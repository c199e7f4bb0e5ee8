"""The port's whole-window function against the JAX package's K_WINDOW.

The JAX side runs megakernel.window_fused -- the persistent Pallas region
whose body is engine._window_body_ref, in interpret mode on the CPU.  The
port side runs its window_fused on CPU tensors: window_plain, the plain
version the CUDA K_WINDOW (csrc/window.cu) is held against on the card.
Inputs are phold H=16 states at a window boundary (run_until's end), for
rx_batch 1 and 2, in an uncongested world and in a congested lossy one;
the full state, the per-host next times, gmin and the window bounds ws /
we must be equal.  The port's window_plain also runs many windows, as
K_WINDOW's UDP kernel does in one launch: from a window boundary to
t_target it must equal the JAX package's engine.run_until."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu import sim as jsim
from shadow1_tpu.core import engine as jeng
from shadow1_tpu.core import megakernel as jmk
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.apps import phold as tphold
from shadow1_tpu_torch.core import megakernel as tmk

from _torch_parity import (assert_same, jax_statics, jax_tree,
                           needs_intel_rsqrt)

MS = 1_000_000
H = 16
STOP = 2_000 * MS

# A congested lossy variant: slow links, 5 % loss, a bootstrap window.
_STRESSED = dict(msgs_per_host=8, seed=5, bw_up_Bps=50_000,
                 bw_down_Bps=6_000, reliability=0.95, bootstrap_end=20 * MS)


def _boundary(rx_batch, t_ms, stressed, **world):
    """A phold H=16 world (`world` overrides build_phold's arguments) run
    to t_ms (a window boundary)."""
    kw = dict(num_hosts=H, msgs_per_host=2, pool_capacity=H * 8, seed=7,
              stop_time=STOP, rx_batch=rx_batch)
    kw.update(world)
    if stressed:
        kw.update(_STRESSED)
    state, params, app = jsim.build_phold(**kw)
    if stressed:
        params = params.replace(
            pds_trail=True, cpu_ns_per_event=jnp.full(H, 50_000, jnp.int64),
            cpu_threshold_ns=jnp.asarray(0, jnp.int64))
    state = jeng.run_until(state, params.replace(megakernel=False), app,
                           t_ms * MS)
    return state, params, app


# The congested worlds reach CoDel's drop spacing, which goes through XLA
# CPU's f32 rsqrt (reproduced for Intel hosts only).
@pytest.mark.parametrize("rx_batch,t_ms,stressed", [
    (1, 250, False), (2, 600, False),
    pytest.param(1, 150, True, marks=needs_intel_rsqrt),
    pytest.param(2, 300, True, marks=needs_intel_rsqrt)])
def test_window_equals_jax_kernel(rx_batch, t_ms, stressed):
    state, params, app = _boundary(rx_batch, t_ms, stressed)
    js, jth, jg, jws, jwe = jax.jit(
        lambda s: jmk.window_fused(s, params, app, STOP))(state)

    ts = convert.state_from_jax(jax_tree(state), device="cpu")
    tp = convert.params_from_jax(jax_tree(params), jax_statics(params),
                                 device="cpu")
    tapp = tphold.Phold(app.mean_delay_ns, app.sock_slot, app.rx_batch)
    ts2, th2, g2, ws2, we2 = tmk.window_fused(ts, tp, tapp, STOP)
    assert int(js.n_windows) == int(state.n_windows) + 1
    assert int(js.n_steps) > int(state.n_steps), "the window took no step"
    assert_same({"state": convert.to_numpy(ts2), "th": th2.numpy(),
                 "gmin": g2.numpy(), "ws": ws2.numpy(), "we": we2.numpy()},
                {"state": jax_tree(js), "th": np.asarray(jth),
                 "gmin": np.asarray(jg), "ws": np.asarray(jws),
                 "we": np.asarray(jwe)},
                f"window rx_batch={rx_batch} t={t_ms}ms stressed={stressed}")


# From a window boundary to t_target, the windows of one K_WINDOW launch
# (window_plain with no binding cap): rx_batch 1 and 2 over >= 5 windows,
# a t_target that cuts its last window short, and a sparse world (one
# message a host, 2 s mean delay) whose events stop before t_target, so
# the loop ends on its predicate with now short of t_target and run_until
# sets now = t_target (engine._run_windows, the JAX run_until).
_SPARSE = dict(msgs_per_host=1, mean_delay_ns=2_000 * MS)


@pytest.mark.parametrize("kind,rx_batch,t_ms,t_target", [
    ("rx1", 1, 250, 400 * MS), ("rx2", 2, 600, 700 * MS),
    ("cut-window", 1, 250, 330 * MS), ("idle-span", 1, 500, 1_900 * MS)])
def test_windows_equal_jax_run_until(kind, rx_batch, t_ms, t_target):
    world = _SPARSE if kind == "idle-span" else {}
    state, params, app = _boundary(rx_batch, t_ms, False, **world)
    jout = jeng.run_until(state, params.replace(megakernel=False), app,
                          t_target)

    ts = convert.state_from_jax(jax_tree(state), device="cpu")
    tp = convert.params_from_jax(jax_tree(params), jax_statics(params),
                                 device="cpu")
    tapp = tphold.Phold(app.mean_delay_ns, app.sock_slot, app.rx_batch)
    ts2, _th, win = tmk.window_plain(ts, tp, tapp, t_target, 1 << 20)
    gmin, ws, we, pend, status = win.tolist()
    assert status == 0 and int(ts2.now) == we
    windows = int(ts2.n_windows) - int(state.n_windows)
    if kind == "idle-span":
        assert we < t_target <= min(gmin, pend), "no idle span at the end"
        assert windows >= 2
    else:
        assert we == t_target and windows >= 5
    if kind == "cut-window":
        assert ws + tp.min_latency_ns > t_target, "the last window is whole"
    ts2 = ts2.replace(now=torch.full_like(ts2.now, t_target))
    assert_same(convert.to_numpy(ts2), jax_tree(jout),
                f"windows rx_batch={rx_batch} {t_ms} ms -> {t_target} ns")

    # The same span in launches capped at 3 windows (the status says so),
    # each picked up again, ends in the same state.
    tc = ts
    for _ in range(windows):
        tc, _th, win = tmk.window_plain(tc, tp, tapp, t_target, 3)
        if win[4] != tmk.STATUS_WINDOW_CAP:
            break
    assert int(win[4]) == 0
    tc = tc.replace(now=torch.full_like(tc.now, t_target))
    assert_same(convert.to_numpy(tc), jax_tree(jout), "capped launches")


@pytest.mark.parametrize("status,cap,message", [
    (1, None, "cap of 1048576 micro-steps"),
    (2, 40, "cap of 40 windows in one launch")], ids=["steps", "windows"])
def test_window_status_raises(status, cap, message):
    """The status words K_WINDOW sets when it stops at a cap -- its
    micro-step cap in one window, or the window cap of a launch while the
    window loop's predicate still holds -- are raised on, by the cap's
    name; status 0 passes."""
    tmk.check_window_status(0, cap)
    with pytest.raises(RuntimeError, match=message):
        tmk.check_window_status(status, cap)
