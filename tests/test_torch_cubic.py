"""CUBIC congestion control in the port against the JAX package (CPU).

* `cong._cubic_target` equals the JAX `_cubic_target` (jitted, as XLA CPU
  compiles it) on 2^20 seeded inputs and the edges: cub_epoch = 0,
  cub_wmax = 0, srtt = 0, epochs long enough to hit the clamp;
* the three CUBIC hooks (new ACK, fast recovery, RTO) equal the JAX ones
  on 2^20 seeded socket registers each, cwnd below and above cub_wmax and
  ssthresh, fresh and running epochs, and per-ACK steps whose i64
  quotient wraps in the i32 cast;
* a lossy bulk world (3 hosts, reliability 0.9, as tests/test_tcp.py's
  CUBIC cases build it) equals the JAX package leaf for leaf at three
  window ends on both port paths, with CUBIC's own branches shown to run
  (a socket in congestion avoidance with an epoch; losses that ran the
  recovery or timeout hooks);
* `examples/tgen-2host` to 8 s (its three streams are done by then)
  through both CLIs with `--tcp-congestion-control cubic`: the same
  heartbeat.csv bytes and summary.json;
* (slow) the JAX package reproduces the constants chip_smoke.py holds
  the card to: LOSSY with CUBIC (JAX_LOSSY_CUBIC) and the JAX CLI on
  examples/tgen-100host with CUBIC (JAX_CLI["tgen-100host-cubic"]).

The card's versions (csrc/tcp.cuh cubic_target and the hooks,
csrc/xla_cbrt.cuh cbrt_xla) are held to these plain versions by
chip_smoke.py.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu import sim as jsim
from shadow1_tpu.core import engine as jeng
from shadow1_tpu.transport import cong as jcong
from shadow1_tpu.transport import tcp as jtcp
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import sim as tsim
from shadow1_tpu_torch.core import engine as teng
from shadow1_tpu_torch.transport import cong as tcong
from shadow1_tpu_torch.transport import tcp as ttcp

from _torch_parity import assert_same, jax_tree
from test_torch_cli import REPO, _chip_smoke, _constants, _jax, _port

MS = 1_000_000
SEC = 1_000_000_000
MSS = 1460
N = 1 << 20
FIELDS = ("cwnd", "ssthresh", "cub_epoch", "cub_wmax", "srtt")


class _JaxView:
    """A socket view of bare fields with the JAX _Sock's setwhere."""
    setwhere = jtcp._Sock.setwhere


class _PortView:
    setwhere = ttcp._Sock.setwhere


def _registers(seed: int) -> dict:
    """N seeded sockets' registers: chip_smoke.py holds the card's CUBIC
    target and hooks to cong.py on the same ones."""
    return _chip_smoke().cubic_registers(seed, N)


def _edges() -> dict:
    """Registers at the edges named in the module docstring."""
    return _chip_smoke().cubic_edges()


def _views(r: dict):
    jv, tv = _JaxView(), _PortView()
    for f in FIELDS:
        setattr(jv, f, jnp.asarray(r[f]))
        setattr(tv, f, torch.from_numpy(r[f].copy()))
    return jv, tv


def _out(view) -> dict:
    return {f: np.asarray(getattr(view, f)) for f in FIELDS}


@functools.lru_cache(maxsize=None)
def _jax_hook(name: str):
    """The JAX hook `name` jitted over the registers it reads."""
    def run(cwnd, ssthresh, cub_epoch, cub_wmax, srtt, tick, acked, flight,
            mask):
        v = _JaxView()
        v.cwnd, v.ssthresh, v.cub_epoch = cwnd, ssthresh, cub_epoch
        v.cub_wmax, v.srtt = cub_wmax, srtt
        if name == "target":
            return jcong._cubic_target(v, tick)
        if name == "new_ack":
            jcong._cubic_new_ack(v, mask, jnp.where(mask, acked, 0), tick)
        elif name == "enter_recovery":
            jcong._cubic_enter_recovery(v, mask, flight, tick)
        else:
            jcong._cubic_timeout(v, mask, flight, tick)
        return {f: getattr(v, f) for f in FIELDS}
    return jax.jit(run)


def _port_hook(name: str, r: dict):
    _jv, v = _views(r)
    tick = torch.from_numpy(r["tick"])
    mask = torch.from_numpy(r["mask"])
    flight = torch.from_numpy(r["flight"])
    if name == "target":
        return tcong._cubic_target(v, tick).numpy()
    if name == "new_ack":
        acked = torch.where(mask, torch.from_numpy(r["acked"]), 0)
        tcong._cubic_new_ack(v, mask, acked, tick)
    elif name == "enter_recovery":
        tcong._cubic_enter_recovery(v, mask, flight, tick)
    else:
        tcong._cubic_timeout(v, mask, flight, tick)
    return _out(v)


def _jax_out(name: str, r: dict):
    out = _jax_hook(name)(*(jnp.asarray(r[k]) for k in (
        *FIELDS, "tick", "acked", "flight", "mask")))
    return np.asarray(out) if name == "target" else \
        {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", ["target", "new_ack", "enter_recovery",
                                  "timeout"])
def test_cubic_hooks_equal_jax(name):
    seed = ["target", "new_ack", "enter_recovery", "timeout"].index(name)
    r = {k: np.concatenate([a, _edges()[k]])
         for k, a in _registers(seed).items()}
    got, want = _port_hook(name, r), _jax_out(name, r)
    if name == "target":
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (f"{bad.size} targets differ, first at "
                               f"{bad[:3]}: {got[bad[:3]]} vs {want[bad[:3]]}")
        # Every regime ran: the clamps at both ends and the cubic between.
        assert (want == 2 * MSS).any() and (want == 4194304).any()
        assert ((want > 2 * MSS) & (want < 4194304)).sum() > N // 4
    else:
        assert_same(got, want, f"cubic {name}")
        changed = got["cwnd"] != r["cwnd"]
        assert changed.sum() > N // 2
    if name == "new_ack":
        # Fresh epochs started, and congestion-avoidance steps above
        # Reno's, including quotients past 2^31 (the wrapping cast).
        ca = r["mask"] & (r["cwnd"] >= r["ssthresh"])
        assert (ca & (r["cub_epoch"] == 0) & (got["cub_epoch"] != 0)).any()
        q = (_port_hook("target", {**r, "cub_epoch": got["cub_epoch"],
                                   "cub_wmax": got["cub_wmax"]})
             .astype(np.int64) - r["cwnd"]) * r["acked"] // \
            np.maximum(r["cwnd"], MSS)
        assert (ca & (q > 2**31)).any()
        reno = np.maximum(MSS * MSS // np.maximum(r["cwnd"], 1), 1)
        assert (ca & (got["cwnd"] - r["cwnd"] > reno)).any()


def test_algorithms_and_validate():
    assert tcong.ALGORITHMS == jcong.ALGORITHMS == ("reno", "cubic")
    for name in ("reno", "cubic"):
        assert tcong.validate(name) == jcong.validate(name) == name
    for mod in (tcong, jcong):
        with pytest.raises(ValueError, match="unknown congestion control"):
            mod.validate("vegas")


# ---------------------------------------------------------------------------
# A lossy bulk world with CUBIC
# ---------------------------------------------------------------------------

WORLD = dict(num_hosts=3, bytes_per_client=1 << 18, latency_ns=10 * MS,
             reliability=0.9, stop_time=60 * SEC, seed=5)
# Window ends compared: early losses; a socket in congestion avoidance
# with a running epoch; the last transfer done.
ENDS = (200 * MS, 1700 * MS, 2000 * MS)


@functools.lru_cache(maxsize=None)
def _jax_world():
    js, jp, ja = jsim.build_bulk(**WORLD)
    jp = jp.replace(cong="cubic", megakernel=False)
    out = []
    for t in ENDS:
        js = jeng.run_until(js, jp, ja, t)
        out.append(jax_tree(js))
    return out


@pytest.mark.parametrize("persistent", [True, False],
                         ids=["persistent", "per-phase"])
def test_lossy_cubic_world_equals_jax(persistent):
    ts, tp, ta = tsim.build_bulk(**WORLD, persistent=persistent,
                                 device="cpu")
    tp = tp.replace(cong="cubic")
    avoid = recover = False
    for t, want in zip(ENDS, _jax_world()):
        ts = teng.run_until(ts, tp, ta, t)
        assert_same(convert.to_numpy(ts), want, f"cubic world at {t} ns")
        sk = ts.socks
        tcp = sk.stype == ttcp.SOCK_TCP
        avoid |= bool((tcp & (sk.cub_epoch != 0)
                       & (sk.cwnd >= sk.ssthresh)).any())
        recover |= bool((tcp & (sk.ssthresh < ttcp.SSTHRESH_INIT)).any())
    assert avoid, "no socket reached CUBIC's congestion avoidance"
    assert recover, "no fast recovery or RTO ran CUBIC's hooks"
    assert int(ts.socks.retx_segs.sum()) > 0
    assert int((ts.app.phase == 2).sum()) == 2 and int(ts.err) == 0


def test_tgen_2host_cubic_equals_jax_cli(tmp_path):
    config = os.path.join(REPO, "examples", "tgen-2host",
                          "shadow.config.xml")
    flag = ["--tcp-congestion-control", "cubic"]
    t = _port(config, tmp_path / "port", 8, flag)
    j = _jax(config, tmp_path / "jax", 8, flag)
    assert j[0] == 0 and j[2]["streams_completed"] >= 2
    assert t[0] == j[0]
    assert t[3] == j[3], "heartbeat.csv differs"
    assert t[2] == j[2], "summary.json differs"


@pytest.mark.slow
def test_jax_cubic_constants(tmp_path):
    """LOSSY with CUBIC to LOSSY_CUBIC_NS, and the JAX CLI on
    examples/tgen-100host with CUBIC to its 120 s (~12 min)."""
    cs = _chip_smoke()
    js, jp, ja = jsim.build_bulk(**cs.LOSSY)
    out = jeng.run_until(js, jp.replace(cong="cubic", megakernel=False), ja,
                         cs.LOSSY_CUBIC_NS)
    assert cs.tcp_summary(out) == cs.JAX_LOSSY_CUBIC
    got = _constants(*_jax(os.path.join(REPO, cs.CLI_100HOST),
                           tmp_path / "cli", None,
                           ["--tcp-congestion-control", "cubic"]))
    assert got == cs.JAX_CLI["tgen-100host-cubic"]
