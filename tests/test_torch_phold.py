"""The port's phold world end to end against the JAX package.

* `sim.build_phold` gives the same state and params leaves as the JAX
  package's `sim.build_phold`;
* `engine.run_until` / `run_chunked` at H=64, rx_batch 1 and 2, under two
  chunkings, give a full final state equal to the JAX package's, on the
  port's persistent path (one window_call per window, the default) and
  on its per-phase path.  The JAX side runs its reference graph
  (megakernel=False), which tests/test_megakernel.py pins bitwise to
  both of its kernel paths; the port runs its kernel wrappers, which
  take the plain versions on the CPU;
* the persistent path refuses, by name, an app with no device tick;
* (slow) the bench world's trajectory (H = 16,384, 2 simulated seconds)
  equals the constants chip_smoke.py holds the card to, on both sides.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest

from shadow1_tpu import sim as jsim
from shadow1_tpu.core import engine as jeng
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import sim as tsim
from shadow1_tpu_torch.core import engine as teng

from _torch_parity import assert_same, jax_tree, needs_intel_rsqrt

MS = 1_000_000
SEC = 1_000_000_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worlds(persistent=True, **kw):
    """The same phold world from both packages; `persistent` is the
    port's static (the JAX build_phold leaves its own at the default)."""
    kw = {"num_hosts": 64, "msgs_per_host": 2, "pool_capacity": 64 * 8,
          "seed": 7, "stop_time": 2 * SEC, **kw}
    j = jsim.build_phold(**kw)
    t = tsim.build_phold(**kw, persistent=persistent, device="cpu")
    return j, t


def test_build_phold_equals_jax():
    (js, jp, _ja), (ts, tp, _ta) = _worlds(rx_batch=2, reliability=0.9,
                                           bootstrap_end=5 * MS)
    assert_same(convert.to_numpy(ts), jax_tree(js), "build_phold state")
    assert_same(convert.to_numpy(tp), jax_tree(jp), "build_phold params")
    for name in ("has_loss", "has_jitter", "has_iface_buf", "pds_trail",
                 "kernel_diet", "megakernel", "persistent", "cong"):
        assert getattr(tp, name) == getattr(jp, name), name


@functools.lru_cache(maxsize=None)
def _jax_run(rx_batch, chunk_ms):
    """The JAX reference graph's final state, shared by both port paths."""
    (js, jp, ja), _ = _worlds(rx_batch=rx_batch)
    jp = jp.replace(megakernel=False)
    if chunk_ms is None:
        return jeng.run_until(js, jp, ja, 400 * MS)
    return jeng.run_chunked(js, jp, ja, 400 * MS, chunk_ns=chunk_ms * MS)


@pytest.mark.parametrize("persistent", [True, False])
@pytest.mark.parametrize("rx_batch", [1, 2])
@pytest.mark.parametrize("chunk_ms", [None, 150])
def test_run_equals_jax(rx_batch, chunk_ms, persistent):
    jout = _jax_run(rx_batch, chunk_ms)
    _, (ts, tp, ta) = _worlds(rx_batch=rx_batch, persistent=persistent)
    assert tp.persistent is persistent
    t_end = 400 * MS
    if chunk_ms is None:
        tout = teng.run_until(ts, tp, ta, t_end)
    else:
        tout = teng.run_chunked(ts, tp, ta, t_end, chunk_ns=chunk_ms * MS)
    assert int(jout.app.recv.sum()) > 0, "no traffic simulated"
    assert_same(convert.to_numpy(tout), jax_tree(jout),
                f"phold H=64 rx_batch={rx_batch} chunk={chunk_ms} "
                f"persistent={persistent}")


_STRESSED = dict(msgs_per_host=8, seed=5, rx_batch=2, bw_up_Bps=50_000,
                 bw_down_Bps=6_000, reliability=0.95, bootstrap_end=20 * MS)


@functools.lru_cache(maxsize=None)
def _jax_stressed():
    import jax.numpy as jnp
    (js, jp, ja), _ = _worlds(**_STRESSED)
    jp = jp.replace(megakernel=False, pds_trail=True,
                    cpu_ns_per_event=jnp.full(64, 50_000, jnp.int64),
                    cpu_threshold_ns=jnp.asarray(0, jnp.int64))
    return jeng.run_until(js, jp, ja, 400 * MS)


@needs_intel_rsqrt
@pytest.mark.parametrize("persistent", [True, False])
def test_stressed_run_equals_jax(persistent):
    """A congested lossy world drives the branches the bench world never
    takes: reliability drops, TX parking and the drain, rx token
    starvation and CoDel drops, slab overflow, the bootstrap window, the
    virtual-CPU clamp and the PDS trail.  CoDel's drop spacing goes
    through XLA CPU's f32 rsqrt, whose estimate the port reproduces for
    Intel hosts only."""
    import torch
    jout = _jax_stressed()
    _, (ts, tp, ta) = _worlds(**_STRESSED, persistent=persistent)
    tp = tp.replace(pds_trail=True,
                    cpu_ns_per_event=torch.full((64,), 50_000),
                    cpu_threshold_ns=0)
    tout = teng.run_until(ts, tp, ta, 400 * MS)
    h = jout.hosts
    for name in ("pkts_dropped_inet", "pkts_dropped_router",
                 "pkts_dropped_pool"):
        assert int(getattr(h, name).sum()) > 0, f"no {name} in the world"
    assert_same(convert.to_numpy(tout), jax_tree(jout),
                f"stressed phold persistent={persistent}")


def test_persistent_refuses_app_without_device_tick():
    """K_WINDOW runs the app tick on the card, and only phold's tick has
    a device version: with persistent=True another app is refused by
    name, on any device; with persistent=False it runs."""
    from shadow1_tpu_torch.apps import phold as tphold

    class Relay(tphold.Phold):
        device_tick = None

    ts, tp, ta = tsim.build_phold(num_hosts=8, device="cpu")
    assert tp.persistent is True
    app = Relay(ta.mean_delay_ns)
    with pytest.raises(NotImplementedError, match="Relay has no device tick"):
        teng.run_until(ts, tp, app, 10 * MS)
    with pytest.raises(NotImplementedError, match="Relay has no device tick"):
        teng.run_chunked(ts, tp, app, 10 * MS)
    out = teng.run_until(ts, tp.replace(persistent=False), app, 10 * MS)
    assert int(out.now) == 10 * MS


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_bench_trajectory():
    """The bench world and schedule of chip_smoke.py (warm-up to 10 ms,
    then run_chunked to 2 s): the JAX package's trajectory is the one
    chip_smoke.py embeds, and the port's plain path on the CPU, with its
    defaults (persistent: one window_call per window), gives the same
    full final state."""
    cs = _chip_smoke()
    js, jp, ja = jsim.build_phold(**cs.BENCH)
    jp = jp.replace(megakernel=False)
    jwarm = jeng.run_until(js, jp, ja, cs.WARM_NS)
    jout = jeng.run_chunked(jwarm, jp, ja, cs.RUN_NS)
    assert cs.summary(jwarm) == cs.JAX_WARM
    assert cs.summary(jout) == cs.JAX_FINAL
    ts, tp, ta = tsim.build_phold(**cs.BENCH, device="cpu")
    assert tp.persistent is True
    tout = teng.run_chunked(teng.run_until(ts, tp, ta, cs.WARM_NS), tp, ta,
                            cs.RUN_NS)
    assert_same(convert.to_numpy(tout), jax_tree(jout), "bench world")
    assert np.asarray(jout.n_steps) == cs.JAX_FINAL["n_steps"]
