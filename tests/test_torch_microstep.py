"""The port's micro-step against the JAX package's fused kernels.

The JAX side runs megakernel.microstep_fused -- K_DELIVER, phold's tick,
K_TRANSPORT, the Pallas kernels in interpret mode on the CPU.  The port
side runs its microstep_fused on CPU tensors: the plain deliver -> tick
-> transport versions the CUDA kernels are held against on the card.
Inputs are phold H=16 states taken mid-run (mid-window, after the
exchange and a micro-step), for rx_batch 1 and 2; the full state, the
per-host next times and their min must be equal."""

import jax
import numpy as np
import pytest

from shadow1_tpu import sim as jsim
from shadow1_tpu.core import engine as jeng
from shadow1_tpu.core import megakernel as jmk
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.apps import phold as tphold
from shadow1_tpu_torch.core import megakernel as tmk

from _torch_parity import assert_same, jax_statics, jax_tree

MS = 1_000_000


def _mid_window(rx_batch, t_ms):
    """A phold H=16 world run to t_ms, then exchanged, scanned and
    stepped once: returns (state, params, app, t_h, window_end)."""
    state, params, app = jsim.build_phold(
        num_hosts=16, msgs_per_host=2, pool_capacity=16 * 8, seed=7,
        stop_time=2_000 * MS, rx_batch=rx_batch)
    params = params.replace(megakernel=False)
    state = jeng.run_until(state, params, app, t_ms * MS)
    state = jeng._exchange(state, params)
    t_h, gmin = jeng._scan_all(state, params, app)
    we = int(min(max(int(state.now), int(gmin)) + int(params.min_latency_ns),
                 2_000 * MS))
    state = jeng._microstep_core(state, params, app, t_h, we)
    t_h, gmin = jeng._scan_all(state, params, app)
    assert int(gmin) < we, "the probe window has no second micro-step"
    return state, params.replace(megakernel=True, persistent=False), app, \
        t_h, we


@pytest.mark.parametrize("rx_batch,t_ms", [(1, 250), (2, 600)])
def test_microstep_equals_jax_kernels(rx_batch, t_ms):
    state, params, app, t_h, we = _mid_window(rx_batch, t_ms)
    js, jth, jg = jax.jit(
        lambda s, th: jmk.microstep_fused(s, params, app, th, we))(
        state, t_h)

    ts = convert.state_from_jax(jax_tree(state), device="cpu")
    tp = convert.params_from_jax(jax_tree(params), jax_statics(params),
                                 device="cpu")
    tapp = tphold.Phold(app.mean_delay_ns, app.sock_slot, app.rx_batch)
    tth = convert._tensor(np.asarray(t_h), "cpu")
    ts2, th2, g2 = tmk.microstep_fused(ts, tp, tapp, tth, we)
    assert int(js.n_steps) == int(state.n_steps) + 1
    assert_same({"state": convert.to_numpy(ts2), "th": th2.numpy(),
                 "gmin": g2.numpy()},
                {"state": jax_tree(js), "th": np.asarray(jth),
                 "gmin": np.asarray(jg)},
                f"microstep rx_batch={rx_batch} t={t_ms}ms")
