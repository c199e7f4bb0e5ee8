"""K_WINDOW's TCP branch against the JAX package (CPU).

The JAX side runs megakernel.window_fused -- the persistent Pallas region
whose body is engine._window_body_ref, with the TCP machine, run_timers
and bulk's tick inside -- in interpret mode on the CPU.  The port side
runs its window_fused on CPU tensors: window_plain, the plain version the
CUDA kernel k_window_tcp (csrc/window.cu) is held against on the card.
Inputs are the 4-host bulk world of tests/test_torch_tcp.py at window
boundaries (made by the port's persistent run, then handed to both):

* reliability 1.0 at 0 ms: the clients connect, write their whole stream
  and close in the window's first tick;
* reliability 1.0 at 51 ms: the server receives the clients' FINs, its
  sockets go to CLOSEWAIT and the sink closes them (bulk's table-wide
  step);
* reliability 0.97, seed 3, at 101 ms: an established socket's
  retransmission timeout fires (WORLD's own seed loses no data segment).

The JAX side is asserted to take each of those branches, and the full
state, the per-host next times, gmin and the window bounds must be
equal.  Then the whole lossy world runs on the persistent path with
sim.build_bulk's defaults through run_chunked to the end of its
transfers, against the JAX package's run_chunked reference graph, and
the "pairs" world (client 2i+1 sends 64 KiB to server 2i) runs on both
of the port's paths against one JAX run.  Last, K_WINDOW's TCP grid is
sized from the occupancy query for any number of hosts, and K_TRANSPORT's
TCP launch takes one warp per host."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadow1_tpu
from shadow1_tpu import sim as jsim
from shadow1_tpu.apps import bulk as jbulk
from shadow1_tpu.core import engine as jeng
from shadow1_tpu.core import megakernel as jmk
from shadow1_tpu.core.params import make_net_params as jmake_params
from shadow1_tpu.core.state import make_sim_state as jmake_state
from shadow1_tpu.routing.synthetic import uniform_full_mesh as jmesh
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import sim as tsim
from shadow1_tpu_torch.apps import bulk as tbulk
from shadow1_tpu_torch.core import engine as teng
from shadow1_tpu_torch.core import megakernel as tmk
from shadow1_tpu_torch.core.params import make_net_params as tmake_params
from shadow1_tpu_torch.core.state import make_sim_state as tmake_state
from shadow1_tpu_torch.routing.synthetic import uniform_full_mesh as tmesh

from _torch_parity import assert_same, jax_tree

MS = 1_000_000
SEC = 1_000_000_000
MSS = 1460
# tests/test_torch_tcp.py's world, and a seed of it whose losses reach an
# established retransmission timeout.
WORLD = dict(num_hosts=4, bytes_per_client=30_000, stop_time=4 * SEC,
             seed=11)
LOSSY = dict(WORLD, seed=3, reliability=0.97)
END_NS = 3 * SEC               # every transfer has finished by then


def _to_jax(obj, tree):
    """The JAX struct `obj` with every leaf replaced from a numpy tree
    (convert.to_numpy's layout)."""
    if dataclasses.is_dataclass(obj):
        return obj.replace(**{k: _to_jax(getattr(obj, k), v)
                              for k, v in tree.items()})
    return jnp.asarray(tree)


@functools.lru_cache(maxsize=None)
def _jax_window():
    """One jitted JAX K_WINDOW for both worlds: the state and params ride
    in as arguments (the worlds share their shapes and statics)."""
    app = jsim.bulk_app.Bulk()
    return jax.jit(lambda s, p, t: jmk.window_fused(s, p, app, t))


def _world(kw):
    """Both packages' worlds; the loss-free one keeps the loss draw on
    (`has_loss`, a static of the JAX params): with reliability 1.0 it
    drops nothing, and the two worlds then share one compiled window."""
    js, jp, _ = jsim.build_bulk(**kw)
    ts, tp, ta = tsim.build_bulk(**kw, device="cpu")
    jp = jp.replace(has_loss=True)
    tp = tp.replace(has_loss=True)
    return js, jp, ts, tp, ta


def _connect_close(before, after):
    """Some client connected and closed (its whole stream written)."""
    return bool(((before.app.phase == 0) & (after.app.phase == 1)).any()
                and (after.socks.app_closed & ~before.socks.app_closed)
                .any())


def _sink_close(before, after):
    """The sink closed a server socket whose peer closed (CLOSEWAIT):
    only bulk's table-wide step sets app_closed on a host that is not a
    client."""
    server = ~np.asarray(before.app.is_client)[:, None]
    return bool((np.asarray(after.socks.app_closed)
                 & ~np.asarray(before.socks.app_closed) & server).any())


def _rto(before, after):
    """An established retransmission timeout fired: the back-off, the
    window down to one segment, and the retransmission."""
    b, a = before.socks, after.socks
    return bool(((a.rto > b.rto) & (a.cwnd == MSS)
                 & (a.retx_segs > b.retx_segs)).any())


@pytest.mark.parametrize("world,t_ms,branch", [
    (dict(WORLD, reliability=1.0), 0, _connect_close),
    (dict(WORLD, reliability=1.0), 51, _sink_close),
    (LOSSY, 101, _rto)], ids=["connect-close", "closewait", "rto"])
def test_tcp_window_equals_jax_kernel(world, t_ms, branch):
    js, jp, ts, tp, ta = _world(world)
    ts = teng.run_until(ts, tp, ta, t_ms * MS)
    assert int(ts.now) == t_ms * MS
    js = _to_jax(js, convert.to_numpy(ts))
    jout, jth, jg, jws, jwe = _jax_window()(js, jp, world["stop_time"])
    assert branch(js, jout), f"the window at {t_ms} ms misses its branch"
    assert int(jout.n_steps) > int(js.n_steps), "the window took no step"

    ts2, th2, g2, ws2, we2 = tmk.window_fused(ts, tp, ta,
                                              world["stop_time"])
    assert_same({"state": convert.to_numpy(ts2), "th": th2.numpy(),
                 "gmin": g2.numpy(), "ws": ws2.numpy(), "we": we2.numpy()},
                {"state": jax_tree(jout), "th": np.asarray(jth),
                 "gmin": np.asarray(jg), "ws": np.asarray(jws),
                 "we": np.asarray(jwe)},
                f"TCP window at {t_ms} ms ({branch.__name__})")


def test_persistent_bulk_run_equals_jax():
    """sim.build_bulk's defaults (megakernel and persistent: one
    window_call per window) through run_chunked, on the CPU, equal the
    JAX package's reference graph leaf for leaf."""
    ts, tp, ta = tsim.build_bulk(**LOSSY, device="cpu")
    assert tp.megakernel and tp.persistent
    tout = teng.run_chunked(ts, tp, ta, END_NS)
    js, jp, ja = jsim.build_bulk(**LOSSY)
    jout = jeng.run_chunked(js, jp.replace(megakernel=False), ja, END_NS)
    assert (np.asarray(jout.app.phase)[1:] == 2).all(), "transfers unfinished"
    assert int(jout.socks.retx_segs.sum()) > 0
    assert_same(convert.to_numpy(tout), jax_tree(jout),
                "persistent bulk run")


# The "pairs" world: host 2i+1 sends 64 KiB to host 2i over a uniform
# 10 ms full mesh (host i on vertex i mod 256, as build_phold maps its
# hosts), sized by the JAX package's assembler rule for fan-in 1
# (config/assemble.py: 6 socket slots, 128-slot slabs); Reno, rx_batch 4.
# Built with the API both packages share (no build_* option).
PAIRS_H = 16
PAIRS_NS = 100 * MS


def _pairs_kw(h, xp):
    ids = xp.arange(h)
    is_server = ids % 2 == 0
    return ids, is_server, dict(
        is_client=~is_server, dst=ids - ids % 2,
        total_bytes=xp.where(is_server, 0, 64 * 1024),
        start_t=xp.full((h,), MS))


def _jax_pairs(h):
    def build():
        v = min(h, 256)
        lat, rel = jmesh(v, 10 * MS, 1.0)
        ids, is_server, app_kw = _pairs_kw(h, jnp)
        params = jmake_params(
            latency_ns=lat, reliability=rel, host_vertex=ids % v,
            bw_up_Bps=jnp.full(h, 1 << 30), bw_down_Bps=jnp.full(h, 1 << 30),
            seed=1, stop_time=60 * SEC)
        state = jmake_state(h, sock_slots=6, pool_capacity=h * 128)
        state = state.replace(
            socks=jbulk.setup_servers(state.socks, is_server),
            app=jbulk.init_state(h, **app_kw))
        return state, params
    state, params = shadow1_tpu.build_on_host(build)
    return state, params, jbulk.Bulk()


def _port_pairs(h, persistent):
    v = min(h, 256)
    lat, rel = tmesh(v, 10 * MS, 1.0)
    ids, is_server, app_kw = _pairs_kw(h, torch)
    params = tmake_params(
        latency_ns=lat, reliability=rel, host_vertex=ids % v,
        bw_up_Bps=torch.full((h,), 1 << 30),
        bw_down_Bps=torch.full((h,), 1 << 30), seed=1, stop_time=60 * SEC,
        persistent=persistent, device="cpu")
    state = tmake_state(h, sock_slots=6, pool_capacity=h * 128,
                        uses_tcp=True, device="cpu")
    state = state.replace(
        socks=tbulk.setup_servers(state.socks, is_server),
        app=tbulk.init_state(h, **app_kw, device="cpu"))
    return state, params, tbulk.Bulk()


@functools.lru_cache(maxsize=None)
def _jax_pairs_run():
    js, jp, ja = _jax_pairs(PAIRS_H)
    return jax_tree(jeng.run_chunked(js, jp.replace(megakernel=False), ja,
                                     PAIRS_NS))


@pytest.mark.parametrize("persistent", [True, False],
                         ids=["persistent", "per-phase"])
def test_pairs_run_equals_jax(persistent):
    """The pairs world to 100 ms on each of the port's paths (K_WINDOW's
    TCP kernel, or the per-phase kernels; their plain versions here)
    equals the JAX package's reference graph, every leaf."""
    ts, tp, ta = _port_pairs(PAIRS_H, persistent)
    assert tp.megakernel and tp.persistent == persistent
    tout = teng.run_chunked(ts, tp, ta, PAIRS_NS)
    jout = _jax_pairs_run()
    assert (jout["app"]["phase"][1::2] == 2).all(), \
        "a pair's transfer is unfinished"
    assert_same(convert.to_numpy(tout), jout, "pairs world")


@pytest.mark.parametrize("h", [100, 33_792, 33_793])
def test_tcp_window_grid_follows_occupancy(monkeypatch, h):
    """K_WINDOW's grid is what the card keeps resident (blocks per SM
    from the occupancy query, times SMs), no more blocks than the hosts
    fill (one warp per host in k_window_tcp's 256-thread blocks, one
    thread per host in k_window's 128-thread blocks), and the kernels
    walk hosts grid-stride: no host count is refused."""
    class Lib:
        @staticmethod
        def window_occupancy(tcp, buf, cong, per_sm, sms):
            per_sm._obj.value = 2 if tcp else 4
            sms._obj.value = 132
            return 0

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tmk, "_OCCUPANCY", {})
    assert tmk._window_grid(Lib, h, True) == min(-(-h // 8), 2 * 132)
    assert tmk._window_grid(Lib, h, False) == min(-(-h // 128), 4 * 132)


@pytest.mark.parametrize("h", [100, 40_000])
def test_tcp_transport_takes_one_warp_per_host(h):
    """K_TRANSPORT's TCP kernel (k_transport_tcp) is a plain launch of
    one warp per host, 8 hosts a 256-thread block: its blocks, and so
    its block partials, are ceil(h / 8); the UDP kernel keeps one thread
    per host, in 128-thread blocks."""
    assert tmk._transport_blocks(h, True) == -(-h // 8)
    assert tmk._transport_blocks(h, False) == -(-h // 128)
