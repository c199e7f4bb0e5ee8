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
transfers, against the JAX package's run_chunked reference graph."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shadow1_tpu import sim as jsim
from shadow1_tpu.core import engine as jeng
from shadow1_tpu.core import megakernel as jmk
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import sim as tsim
from shadow1_tpu_torch.core import engine as teng
from shadow1_tpu_torch.core import megakernel as tmk

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


def test_tcp_window_grid_raises_past_residency(monkeypatch):
    """k_window_tcp keeps one resident thread per host, so past what the
    card holds at once the wrapper raises, naming the limit the grid
    query reports (-2); below it the grid is one block per 256 hosts."""
    import torch

    class Lib:
        @staticmethod
        def window_tcp_grid(h, grid, cap):
            grid._obj.value = -(-h // 256)
            cap._obj.value = 132 * 256
            return -2 if h > 132 * 256 else 0

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tmk, "_GRID", {})
    assert tmk._window_grid(Lib, 100, True) == 1
    assert tmk._window_grid(Lib, 33_792, True) == 132
    with pytest.raises(RuntimeError, match="holds at most 33792 at once"):
        tmk._window_grid(Lib, 33_793, True)
