"""Static (per-run constant) simulation parameters (counterpart of
shadow1_tpu/core/params.py).

Per-host and per-pair tables are tensors on the run's device; run-wide
scalars (`min_latency_ns`, `stop_time`, ...) are plain Python ints, since
they never change during a run and the kernels take them by value.  The
seed key is the JAX key's uint32[2] data (numpy), and every `PURPOSE_*`
key is folded once here (`purpose_words`), not on every draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import rng, simtime
from .state import I32, I64, F32, Tree, enc_lo, enc_hi, dec_i64

QDISC_FIFO = 0
QDISC_RR = 1

(RCOL_LAT_LO, RCOL_LAT_HI, RCOL_REL, RCOL_JIT_LO, RCOL_JIT_HI) = range(5)
RCOLS = 5
RCOLS_NARROW = 3

_PURPOSES = (rng.PURPOSE_PACKET_DROP, rng.PURPOSE_HOST_APP,
             rng.PURPOSE_ATTACH, rng.PURPOSE_JITTER, rng.PURPOSE_SCHED,
             rng.PURPOSE_CHAOS, rng.PURPOSE_LINEAGE)


def fold_purposes(seed_key) -> dict:
    """{purpose: (k0, k1)} key words of every purpose key, folded once."""
    return {p: rng.key_words(rng.purpose_key(seed_key, p))
            for p in _PURPOSES}


@dataclasses.dataclass
class NetParams(Tree):
    route_blk: torch.Tensor        # [V*V, RCOLS] i32 packed per-pair routing
    host_vertex: torch.Tensor      # [H] i32
    bw_up_Bps: torch.Tensor        # [H] i64
    bw_down_Bps: torch.Tensor      # [H] i64
    min_latency_ns: int
    seed_key: np.ndarray           # uint32[2], == jax.random.key_data
    stop_time: int
    bootstrap_end: int
    cpu_ns_per_event: torch.Tensor  # [H] i64
    cpu_threshold_ns: int
    cpu_precision_ns: int
    qdisc: int
    autotune_snd: torch.Tensor     # [H] bool
    autotune_rcv: torch.Tensor     # [H] bool
    iface_buf_pkts: torch.Tensor   # [H] i32
    pcap_mask: torch.Tensor        # [H] bool
    hosts_real: object = None      # bucket padding: not in this slice
    # Statics (same meaning as in the JAX package).
    cong: str = "reno"
    has_iface_buf: bool = False
    pds_trail: bool = False
    has_loss: bool = True
    has_jitter: bool = True
    kernel_diet: bool = True
    megakernel: bool = True
    persistent: bool = True
    # Derived, host side: the folded purpose keys' words.
    purpose_words: dict = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.purpose_words is None:
            self.purpose_words = fold_purposes(self.seed_key)

    # Leaves that mirror the JAX NetParams pytree (for conversion/compare).
    LEAVES = ("route_blk", "host_vertex", "bw_up_Bps", "bw_down_Bps",
              "min_latency_ns", "seed_key", "stop_time", "bootstrap_end",
              "cpu_ns_per_event", "cpu_threshold_ns", "cpu_precision_ns",
              "qdisc", "autotune_snd", "autotune_rcv", "iface_buf_pkts",
              "pcap_mask")
    STATICS = ("cong", "has_iface_buf", "pds_trail", "has_loss",
               "has_jitter", "kernel_diet", "megakernel", "persistent")

    def global_hosts(self) -> int:
        if self.hosts_real is not None:
            raise ValueError("hosts_real (bucket-padded worlds) is not "
                             "part of this slice of the port")
        return self.host_vertex.shape[0]

    @property
    def n_vertices(self) -> int:
        v = int(round(self.route_blk.shape[0] ** 0.5))
        assert v * v == self.route_blk.shape[0]
        return v

    def route(self, vs, vd):
        """Routing lookup: (latency_ns i64, jitter_ns i64, reliability
        f32), one row gather."""
        rows = self.route_blk[vs * self.n_vertices + vd]
        lat = dec_i64(rows[..., RCOL_LAT_LO], rows[..., RCOL_LAT_HI])
        jit = dec_i64(rows[..., RCOL_JIT_LO], rows[..., RCOL_JIT_HI])
        rel = rows[..., RCOL_REL].contiguous().view(F32)
        return lat, jit, rel

    def route_narrow(self, vs, vd):
        """Jitter-free routing lookup: (latency_ns i64, reliability f32)."""
        rows = self.route_blk[vs * self.n_vertices + vd]
        lat = dec_i64(rows[..., RCOL_LAT_LO], rows[..., RCOL_LAT_HI])
        rel = rows[..., RCOL_REL].contiguous().view(F32)
        return lat, rel


def make_net_params(latency_ns, reliability, host_vertex, bw_up_Bps,
                    bw_down_Bps, seed: int = 1,
                    stop_time: int = simtime.SIMTIME_ONE_SECOND,
                    bootstrap_end: int = 0, min_latency_ns=None,
                    jitter_ns=None, cpu_ns_per_event=None,
                    cpu_threshold_ns: int = -1,
                    cpu_precision_ns: int = 200 * simtime.SIMTIME_ONE_MICROSECOND,
                    qdisc: int = QDISC_FIFO, autotune_snd=None,
                    autotune_rcv=None, iface_buf_pkts=None, pcap_mask=None,
                    cong: str = "reno", megakernel: bool = True,
                    persistent: bool = True, device=None) -> NetParams:
    """Same arguments and derivations as the JAX make_net_params; the
    tables are built on the CPU and moved to `device` once."""
    from .. import resolve_device
    dev = resolve_device(device)
    latency_ns = torch.as_tensor(latency_ns, dtype=I64).cpu()
    jitter_ns = (torch.zeros_like(latency_ns) if jitter_ns is None
                 else torch.as_tensor(jitter_ns, dtype=I64).cpu())
    hv = torch.as_tensor(host_vertex).to(I32).cpu()
    if min_latency_ns is None:
        v = latency_ns.shape[0]
        occupants = torch.zeros((v,), dtype=I32).index_add_(
            0, hv.to(I64), torch.ones_like(hv))
        shared_self = occupants >= 2
        eye = torch.eye(v, dtype=torch.bool)
        eligible = (~eye) | (eye & shared_self[None, :])
        eff = torch.clamp(latency_ns - jitter_ns, min=1)
        inv = simtime.SIMTIME_INVALID
        cand = torch.where(eligible & (latency_ns > 0), eff,
                           torch.full_like(eff, inv))
        m = int(cand.min())
        min_latency_ns = 10 * simtime.SIMTIME_ONE_MILLISECOND \
            if m == inv else m
    h = hv.shape[0]
    if cpu_ns_per_event is None:
        cpu_ns_per_event = torch.zeros((h,), dtype=I64)
    if autotune_snd is None:
        autotune_snd = torch.ones((h,), dtype=torch.bool)
    if autotune_rcv is None:
        autotune_rcv = torch.ones((h,), dtype=torch.bool)
    if iface_buf_pkts is None:
        iface_buf_pkts = torch.zeros((h,), dtype=I32)
    if pcap_mask is None:
        pcap_mask = torch.ones((h,), dtype=torch.bool)
    rel_m = torch.as_tensor(reliability, dtype=F32).cpu()
    lat_f = latency_ns.reshape(-1)
    jit_f = jitter_ns.reshape(-1)
    route_blk = torch.stack([
        enc_lo(lat_f), enc_hi(lat_f),
        rel_m.reshape(-1).contiguous().view(I32),
        enc_lo(jit_f), enc_hi(jit_f)], dim=1)
    iface = torch.as_tensor(iface_buf_pkts).to(I32)

    def t(x, dtype):
        return torch.as_tensor(x).to(dtype).to(dev)

    return NetParams(
        route_blk=route_blk.to(dev),
        host_vertex=hv.to(dev),
        bw_up_Bps=t(bw_up_Bps, I64),
        bw_down_Bps=t(bw_down_Bps, I64),
        min_latency_ns=int(min_latency_ns),
        seed_key=rng.root_key(seed),
        stop_time=int(stop_time),
        bootstrap_end=int(bootstrap_end),
        cpu_ns_per_event=t(cpu_ns_per_event, I64),
        cpu_threshold_ns=int(cpu_threshold_ns),
        cpu_precision_ns=int(cpu_precision_ns),
        qdisc=int(qdisc),
        autotune_snd=t(autotune_snd, torch.bool),
        autotune_rcv=t(autotune_rcv, torch.bool),
        iface_buf_pkts=iface.to(dev),
        pcap_mask=t(pcap_mask, torch.bool),
        cong=cong,
        has_iface_buf=bool((iface > 0).any()),
        has_loss=bool((rel_m < 1.0).any()),
        has_jitter=bool((jitter_ns > 0).any()),
        megakernel=bool(megakernel),
        persistent=bool(persistent),
    )
