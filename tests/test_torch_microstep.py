"""The port's micro-step against the JAX package's fused kernels.

The JAX side runs megakernel.microstep_fused -- K_DELIVER, phold's tick,
K_TRANSPORT, the Pallas kernels in interpret mode on the CPU.  The port
side runs its microstep_fused on CPU tensors: the plain deliver -> tick
-> transport versions the CUDA kernels are held against on the card.
Inputs are phold H=16 states taken mid-run (mid-window, after the
exchange and a micro-step), for rx_batch 1 and 2, and at rx_batch 4 a
state edited the same way on both sides so that K_DELIVER overflows a
socket ring and CoDel drops; the full state, the per-host next times and
their min must be equal.  A congested, lossy case with 12-slot slabs
takes K_TRANSPORT's parking, loss and overflow branches (against the JAX
package's plain micro-step)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shadow1_tpu import sim as jsim
from shadow1_tpu.core import engine as jeng
from shadow1_tpu.core import megakernel as jmk
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import sim as tsim
from shadow1_tpu_torch.apps import phold as tphold
from shadow1_tpu_torch.core import engine as teng
from shadow1_tpu_torch.core import megakernel as tmk

from _torch_parity import (assert_same, jax_statics, jax_tree,
                           needs_intel_rsqrt)

MS = 1_000_000


# A congested, lossy phold world with 12-slot slabs (the shape of
# chip_smoke.py's KO world, cut to 16 hosts): at its compared micro-step
# hosts park packets under the token bucket, lose them to the loss draw
# and overflow their slabs.
CONGESTED = dict(num_hosts=16, msgs_per_host=36, mean_delay_ns=2 * MS,
                 pool_capacity=16 * 12, seed=9, bw_up_Bps=8_000,
                 bw_down_Bps=6_000, reliability=0.8, bootstrap_end=20 * MS)


PHOLD_H16 = dict(num_hosts=16, msgs_per_host=2, pool_capacity=16 * 8,
                seed=7, stop_time=2_000 * MS)


def _mid_window(rx_batch, t_ms):
    """A phold H=16 world run to t_ms, then exchanged, scanned and
    stepped once: returns (state, params, app, t_h, window_end)."""
    state, params, app = jsim.build_phold(**PHOLD_H16, rx_batch=rx_batch)
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


def _put_arrivals(tree, host, times, src0):
    """In-flight UDP arrivals to the phold port in free slots of `host`'s
    inbox slab (numpy tree, convert.to_numpy's layout)."""
    ib = tree["inbox"]
    ki = ib["stage"].shape[0] // 16
    free = [host * ki + k for k in range(ki)
            if ib["stage"][host * ki + k] == 0]
    assert len(free) >= len(times), f"host {host} has no room"
    for j, (slot, t) in enumerate(zip(free, times)):
        row = ib["blk"][slot]
        row[:] = 0
        row[0] = (src0 + j) % 16                     # src
        row[1] = row[2] = tphold.PHOLD_PORT          # sport, dport
        row[3] = 17                                  # UDP
        row[8], row[9] = 64, 7_000 + j               # len, payload
        row[10], row[11] = t & 0x7FFFFFFF, t >> 31   # time
        row[12], row[13] = 900_000 + j, 0            # ctr
        ib["stage"][slot] = 2                        # in flight
        ib["status"][slot] = 0


def _ring_and_codel_window(rx_batch, t_ms):
    """The H=16 world at rx_batch 4 from the port's plain path, then
    edited as numpy (the same arrays go to both sides): host x, the
    earliest, finds its phold socket's ring one short of full and three
    due arrivals for it; host y, made active at the same tick, is in
    CoDel's dropping state with three arrivals 30-50 ms old.  Returns
    (state, params, app, t_h, window_end, x, y) with a JAX state."""
    ts, tp, tapp = tsim.build_phold(**PHOLD_H16, rx_batch=rx_batch,
                                    megakernel=False, device="cpu")
    ts = teng.run_until(ts, tp, tapp, t_ms * MS)
    ts = teng._exchange(ts, tp)
    t_h, gmin = teng._scan_all(ts, tp, tapp)
    we = int(min(max(int(ts.now), int(gmin)) + int(tp.min_latency_ns),
                 2_000 * MS))
    ts = teng._microstep_core(ts, tp, tapp, t_h, we)
    t_h, gmin = teng._scan_all(ts, tp, tapp)
    assert int(gmin) < we, "the probe window has no second micro-step"
    t_h = t_h.numpy().copy()
    x = int(np.argmin(t_h))
    y = (x + 5) % 16
    t0 = int(t_h[x])
    t_h[y] = t0
    tree = convert.to_numpy(ts)
    hosts, socks = tree["hosts"], tree["socks"]
    socks["udp_count"][x, tapp.sock_slot] = 7
    socks["udp_head"][x, tapp.sock_slot] = 5
    _put_arrivals(tree, x, [t0, t0 - 1_000, t0 - 2_000], x + 1)
    _put_arrivals(tree, y, [t0 - 50 * MS, t0 - 40 * MS, t0 - 30 * MS],
                  y + 1)
    for hh in (x, y):
        hosts["tokens_rx"][hh] = 1 << 50
    hosts["codel_dropping"][y] = True
    hosts["codel_count"][y] = 3
    hosts["codel_first_above"][y] = 1
    hosts["codel_drop_next"][y] = 1
    js, jp, japp = jsim.build_phold(**PHOLD_H16, rx_batch=rx_batch)
    return _to_jax(js, tree), jp.replace(megakernel=True, persistent=False), \
        japp, jnp.asarray(t_h), we, x, y


@pytest.mark.parametrize("rx_batch,t_ms,edit", [
    pytest.param(1, 250, False, id="1-250"),
    pytest.param(2, 600, False, id="2-600"),
    pytest.param(4, 150, True, id="4-150-ring-codel",
                 marks=needs_intel_rsqrt)])
def test_microstep_equals_jax_kernels(rx_batch, t_ms, edit):
    if edit:
        state, params, app, t_h, we, x, y = _ring_and_codel_window(rx_batch,
                                                                   t_ms)
    else:
        state, params, app, t_h, we = _mid_window(rx_batch, t_ms)
    js, jth, jg = jax.jit(
        lambda s, th: jmk.microstep_fused(s, params, app, th, we))(
        state, t_h)
    if edit:
        # The edits took: x's ring overflowed (it received more than the
        # one entry its ring had room for) and CoDel dropped at y.
        h0, h1 = state.hosts, js.hosts
        got_x = int(h1.bytes_recv[x] - h0.bytes_recv[x])
        ring_x = int(js.socks.bytes_recv[x].sum()
                     - state.socks.bytes_recv[x].sum())
        assert got_x > ring_x > 0, \
            f"host {x}: {got_x} bytes delivered, {ring_x} into its rings"
        assert int(h1.pkts_dropped_router[y] - h0.pkts_dropped_router[y]) \
            >= 1, f"CoDel dropped nothing at host {y}"

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


def _to_jax(obj, tree):
    """The JAX struct `obj` with every leaf replaced from a numpy tree
    (convert.to_numpy's layout)."""
    if dataclasses.is_dataclass(obj):
        return obj.replace(**{k: _to_jax(getattr(obj, k), v)
                              for k, v in tree.items()})
    return jnp.asarray(tree)


@pytest.mark.parametrize("rx_batch,t_ms", [(2, 60)])
def test_congested_microstep_equals_jax_kernels(rx_batch, t_ms):
    """K_TRANSPORT's branches the light world never takes: the compared
    micro-step parks, loses and overflows packets, with 12-slot outbox
    slabs.  The state before it comes from the port's plain path (the
    same world in both packages) and is carried into JAX, and JAX takes
    the step through its plain reference (_microstep_core, then
    _scan_all), which tests/test_megakernel.py pins to the fused kernels:
    JAX compiles only that step."""
    kw = dict(CONGESTED, stop_time=2_000 * MS, rx_batch=rx_batch)
    js, jp, japp = jsim.build_phold(**kw)
    ts, tp, tapp = tsim.build_phold(**kw, megakernel=False, device="cpu")
    assert ts.pool.capacity // 16 == 12
    ts = teng.run_until(ts, tp, tapp, t_ms * MS)
    ts = teng._exchange(ts, tp)
    t_h, gmin = teng._scan_all(ts, tp, tapp)
    we = int(min(max(int(ts.now), int(gmin)) + int(tp.min_latency_ns),
                 2_000 * MS))
    ts = teng._microstep_core(ts, tp, tapp, t_h, we)
    t_h, gmin = teng._scan_all(ts, tp, tapp)
    assert int(gmin) < we, "the probe window has no second micro-step"
    state = _to_jax(js, convert.to_numpy(ts))
    def step(s, th):
        s = jeng._microstep_core(s, jp, japp, th, we)
        return (s, *jeng._scan_all(s, jp, japp))
    js2, jth, jg = jax.jit(step)(state, jnp.asarray(t_h.numpy()))
    h0, h1 = state.hosts, js2.hosts
    assert int((h1.tx_queued - h0.tx_queued).max()) > 0, "no packet parked"
    assert int((h1.pkts_dropped_inet - h0.pkts_dropped_inet).sum()) > 0, \
        "no packet lost"
    assert int((h1.pkts_dropped_pool - h0.pkts_dropped_pool).sum()) > 0, \
        "no slab overflowed"
    tp = tp.replace(megakernel=True, persistent=False)
    ts2, th2, g2 = tmk.microstep_fused(ts, tp, tapp, t_h, we)
    assert_same({"state": convert.to_numpy(ts2), "th": th2.numpy(),
                 "gmin": g2.numpy()},
                {"state": jax_tree(js2), "th": np.asarray(jth),
                 "gmin": np.asarray(jg)},
                f"congested microstep t={t_ms}ms")
