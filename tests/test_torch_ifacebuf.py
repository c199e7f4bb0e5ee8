"""Interface receive buffers (<host interfacebuffer>) in the port against
the JAX package (CPU).

* a congested, lossy phold world (16 hosts, rx_batch 2, PDS trail) with
  bounds of 1-3 packets on two of three hosts equals the JAX package
  leaf for leaf on the port's persistent path (window_call) and on its
  per-phase path, and tail-drops more packets than without the bounds;
* the 4-host lossy bulk world with bounds on the server and a client,
  the same way, under Reno and under CUBIC (CUBIC's state shown to be
  set);
* a world whose [H, k, k] ranking cube passes 2^28 elements is refused
  with the JAX package's message, word for word;
* `examples/tgen-2host` with an interfacebuffer on the client, to 8 s
  through both CLIs: the same heartbeat.csv bytes and summary.json, with
  tail drops;
* (slow) the JAX package reproduces the constants chip_smoke.py holds
  the card to: STRESS with buffers (JAX_STRESS_BUF), LOSSY with buffers
  under Reno and CUBIC (JAX_LOSSY_BUF, JAX_LOSSY_CUBIC_BUF) and the JAX
  CLI on the interface-buffer config (JAX_CLI["iface"], and with CUBIC
  "iface-cubic"), whose router drops exceed the same config's without
  the attribute.

The kernels' tail drop (csrc/deliver.cuh: rx_open's two passes and
deliver_small's bitmasks) is held to these plain versions by
chip_smoke.py.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu import sim as jsim
from shadow1_tpu.core import engine as jeng
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import sim as tsim
from shadow1_tpu_torch.core import engine as teng

from _torch_parity import assert_same, jax_tree
from test_torch_cli import REPO, _chip_smoke, _constants, _jax, _port

MS = 1_000_000
SEC = 1_000_000_000

PHOLD = dict(num_hosts=16, msgs_per_host=8, mean_delay_ns=10 * MS,
             stop_time=3 * SEC, pool_capacity=16 * 8, rx_batch=2, seed=5,
             bw_up_Bps=50_000, bw_down_Bps=6_000, reliability=0.95)
PHOLD_CAP = np.array([0 if i % 3 == 0 else 1 + i % 3 for i in range(16)],
                     np.int32)
PHOLD_NS = 150 * MS
BULK = dict(num_hosts=4, bytes_per_client=30_000, stop_time=4 * SEC,
            seed=11, reliability=0.97)
BULK_CAP = np.array([4, 0, 2, 0], np.int32)
BULK_NS = 1 * SEC


def _buffered(params, cap, tensor, kind):
    return params.replace(iface_buf_pkts=tensor(cap), has_iface_buf=True,
                          pds_trail=True,
                          cong="cubic" if kind == "bulk-cubic" else "reno")


def _world(kind: str, sim):
    return (sim.build_phold, PHOLD, PHOLD_CAP, PHOLD_NS) if kind == "phold" \
        else (sim.build_bulk, BULK, BULK_CAP, BULK_NS)


@functools.lru_cache(maxsize=None)
def _jax_final(kind: str):
    build, kw, cap, t = _world(kind, jsim)
    js, jp, ja = build(**kw)
    jp = _buffered(jp, cap, jnp.asarray, kind).replace(megakernel=False)
    return jax_tree(jeng.run_until(js, jp, ja, t))


def _port_final(kind: str, persistent: bool, buffered: bool = True):
    build, kw, cap, t = _world(kind, tsim)
    ts, tp, ta = build(**kw, persistent=persistent, device="cpu")
    tp = _buffered(tp, cap, torch.from_numpy, kind)
    if not buffered:
        tp = tp.replace(iface_buf_pkts=tp.iface_buf_pkts * 0,
                        has_iface_buf=False)
    assert tp.has_iface_buf == buffered
    return teng.run_until(ts, tp, ta, t)


@pytest.mark.parametrize("persistent", [True, False],
                         ids=["persistent", "per-phase"])
@pytest.mark.parametrize("kind", ["phold", "bulk", "bulk-cubic"])
def test_buffered_world_equals_jax(kind, persistent):
    out = _port_final(kind, persistent)
    assert_same(convert.to_numpy(out), _jax_final(kind),
                f"buffered {kind} world")
    drops = int(out.hosts.pkts_dropped_router.sum())
    without = int(_port_final(kind, persistent, buffered=False)
                  .hosts.pkts_dropped_router.sum())
    assert drops > without, (drops, without)
    if kind == "bulk-cubic":
        # CUBIC's own state was set: an epoch or a Wmax on some socket.
        sk = out.socks
        assert bool(((sk.cub_epoch != 0) | (sk.cub_wmax != 0)).any())


def test_ranking_cube_refusal_equals_jax():
    """2 hosts with 2^14-slot inbox slabs: 2 * 2^28 elements."""
    kw = dict(num_hosts=2, pool_capacity=2 << 14, stop_time=SEC)
    js, jp, ja = jsim.build_phold(**kw)
    jp = jp.replace(iface_buf_pkts=jnp.asarray([1, 0], jnp.int32),
                    has_iface_buf=True, megakernel=False)
    with pytest.raises(ValueError) as jerr:
        jeng.run_until(js, jp, ja, 10 * MS)
    for persistent in (True, False):
        ts, tp, ta = tsim.build_phold(**kw, persistent=persistent,
                                      device="cpu")
        tp = tp.replace(iface_buf_pkts=torch.tensor([1, 0],
                                                    dtype=torch.int32),
                        has_iface_buf=True)
        with pytest.raises(ValueError) as terr:
            teng.run_until(ts, tp, ta, 10 * MS)
        assert str(terr.value) == str(jerr.value)
    assert "ranking cube (> 2^28 elements)" in str(jerr.value)


def test_tgen_2host_iface_equals_jax_cli(tmp_path):
    src = os.path.join(REPO, "examples", "tgen-2host")
    for name in ("tgen.server.graphml.xml", "tgen.client.graphml.xml"):
        with open(os.path.join(src, name)) as f:
            (tmp_path / name).write_text(f.read())
    with open(os.path.join(src, "shadow.config.xml")) as f:
        xml = f.read()
    old = '<host id="client">'
    assert old in xml
    config = tmp_path / "shadow.config.xml"
    config.write_text(xml.replace(
        old, '<host id="client" interfacebuffer="3000">'))
    t = _port(str(config), tmp_path / "port", 8)
    j = _jax(str(config), tmp_path / "jax", 8)
    assert j[0] == 0 and j[2]["drops_router"] > 0
    assert t[0] == j[0]
    assert t[3] == j[3], "heartbeat.csv differs"
    assert t[2] == j[2], "summary.json differs"


@pytest.mark.slow
def test_jax_iface_constants(tmp_path):
    """STRESS with chip_smoke.buffered's bounds to STRESS_NS, LOSSY with
    lossy_buffered's under Reno and CUBIC to LOSSY_BUF_NS, and the JAX
    CLI on write_iface_config's config, with and without the buffers and
    with CUBIC, to 120 s (~22 min)."""
    cs = _chip_smoke()
    js, jp, ja = jsim.build_phold(**cs.STRESS)
    h = cs.STRESS["num_hosts"]
    cap = np.array([0 if i % 3 == 0 else 1 + i % 4 for i in range(h)],
                   np.int32)
    jp = jp.replace(pds_trail=True, cpu_threshold_ns=0,
                    cpu_ns_per_event=jnp.full_like(jp.cpu_ns_per_event,
                                                   50_000),
                    iface_buf_pkts=jnp.asarray(cap), has_iface_buf=True,
                    megakernel=False)
    out = jeng.run_until(js, jp, ja, cs.STRESS_NS)
    got = dict(cs.summary(out),
               drops_router=int(out.hosts.pkts_dropped_router.sum()))
    assert got == cs.JAX_STRESS_BUF
    h = cs.LOSSY["num_hosts"]
    cap = np.array([24 if i == 0 else 0 if i % 4 == 3 else 2 + i % 3
                    for i in range(h)], np.int32)
    for cong, want in (("reno", cs.JAX_LOSSY_BUF),
                       ("cubic", cs.JAX_LOSSY_CUBIC_BUF)):
        js, jp, ja = jsim.build_bulk(**cs.LOSSY)
        jp = jp.replace(cong=cong, iface_buf_pkts=jnp.asarray(cap),
                        has_iface_buf=True, pds_trail=True,
                        megakernel=False)
        out = jeng.run_until(js, jp, ja, cs.LOSSY_BUF_NS)
        assert dict(cs.tcp_summary(out), drops_router=int(
            out.hosts.pkts_dropped_router.sum())) == want
    runs = {}
    for name, nbytes, flags in (
            ("iface", cs.IFACE_BYTES, []), ("none", None, []),
            ("iface-cubic", cs.IFACE_BYTES,
             ["--tcp-congestion-control", "cubic"])):
        config = cs.write_iface_config(tmp_path / name, cs.IFACE_WEB, nbytes)
        runs[name] = _constants(*_jax(config, tmp_path / f"{name}-out",
                                      None, flags))
    assert runs["iface"] == cs.JAX_CLI["iface"]
    assert runs["iface-cubic"] == cs.JAX_CLI["iface-cubic"]
    assert runs["iface"]["summary"]["drops_router"] > \
        runs["none"]["summary"]["drops_router"]
