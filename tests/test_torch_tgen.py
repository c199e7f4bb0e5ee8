"""The port's tgen app (shadow1_tpu_torch/apps/tgen.py) against the JAX
package (CPU).

The same inputs, made from a numpy seed, go through the JAX function and
the port's plain torch counterpart, and every output leaf must be equal:

* `parse_tgen` and `parse_size` on the examples' graphs and on sim.py's
  templates, and the refusals of `parse_tgen` and `build_state`
  (fan-out, conflicting peers lists, a stream client with no peers);
* `build_state`'s tables and registers;
* `Tgen.on_tick` on states captured mid-run of an 8-host tgen world,
  with the registers and sockets randomised so that every branch runs:
  start, stop, stream init, write, close, done, failed, the end count,
  the pause draw and the pause end, the server's bounded write near the
  u32 wrap, and servers whose peer re-inits while its old child socket
  is open;
* that world's whole run to 8 s on the port's persistent path (window
  by window through the kernel wrappers, their plain versions on the
  CPU) and its per-phase path;
* (slow) the 100-host world of chip_smoke.py: the JAX package's
  trajectory equals the constants chip_smoke.py holds the card to, its
  fused path ends in the same state as its reference graph, and the
  port's plain path ends in the same state too.

The loopback world (a host that streams to its own listener) and the
staging's loopback insert are in tests/test_torch_tgen_loopback.py.
"""

import functools
import glob
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from shadow1_tpu import sim as jsim
from shadow1_tpu.apps import tgen as jtgen
from shadow1_tpu.core import emit as jemit
from shadow1_tpu.core import engine as jeng
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import sim as tsim
from shadow1_tpu_torch.apps import tgen as ttgen
from shadow1_tpu_torch.core import emit as temit
from shadow1_tpu_torch.core import engine as teng

from _torch_parity import assert_same, jax_statics, jax_tree

MS = 1_000_000
SEC = 1_000_000_000
INV = (1 << 63) - 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 8
# The 8-host world's schedule: run_until to each time in turn (each is a
# window boundary on both sides); on_tick is checked on the states at all
# but the last.
CAPTURE_S = (5.5, 6.5, 7.3, 8.0)


def _graph_sources():
    srcs = sorted(glob.glob(os.path.join(REPO, "examples", "*",
                                         "tgen.*.graphml.xml")))
    assert len(srcs) >= 4
    srcs.append(jsim._TGEN_SERVER_XML.format(port=8888))
    srcs.append(jsim._TGEN_CLIENT_XML.format(port=8888, sendsize="1 MiB",
                                             recvsize=4096, streams=7))
    return srcs


def _same_graph(tg, jg):
    for f in ("node_ids", "pause_s", "peers", "serverport", "start_node"):
        assert getattr(tg, f) == getattr(jg, f), f
    for f in ("ntype", "nxt", "sendsize", "recvsize", "count"):
        a, b = getattr(tg, f), getattr(jg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# ---------------------------------------------------------------------------
# Host side: parsing and assembly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", ["1 MiB", "100 kb", "5242880", "2.5 KiB",
                                  "3 bytes", "7 B", "1 tib", "0.5 gb"])
def test_parse_size_equals_jax(text):
    assert ttgen.parse_size(text) == jtgen.parse_size(text)


@pytest.mark.parametrize("text", ["1 parsec", "1 2 3"])
def test_parse_size_refusals(text):
    with pytest.raises(ValueError):
        jtgen.parse_size(text)
    with pytest.raises(ValueError):
        ttgen.parse_size(text)


def test_parse_tgen_equals_jax():
    for src in _graph_sources():
        _same_graph(ttgen.parse_tgen(src), jtgen.parse_tgen(src))


_FANOUT = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <graph edgedefault="directed">
    <node id="start"/><node id="stream"/><node id="pause"/>
    <edge source="start" target="stream"/>
    <edge source="start" target="pause"/>
  </graph></graphml>"""

_TWO_PEERS = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="peers" attr.type="string" for="node" id="k0"/>
  <key attr.name="sendsize" attr.type="string" for="node" id="k1"/>
  <graph edgedefault="directed">
    <node id="start"><data key="k0">server:80</data></node>
    <node id="stream"><data key="k0">other:80</data>
      <data key="k1">10</data></node>
    <edge source="start" target="stream"/>
  </graph></graphml>"""

_NO_PEERS = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="sendsize" attr.type="string" for="node" id="k1"/>
  <graph edgedefault="directed">
    <node id="start"/><node id="stream"><data key="k1">10</data></node>
    <edge source="start" target="stream"/>
  </graph></graphml>"""


@pytest.mark.parametrize("case,match", [
    ("fanout", "multiple successors"),
    ("unknown", "unknown tgen action"),
    ("two_peers", "conflicting peers"),
    ("no_peers", "no peers list"),
])
def test_tgen_refusals_equal_jax(case, match):
    for mod in (jtgen, ttgen):
        with pytest.raises(ValueError, match=match):
            if case == "fanout":
                mod.parse_tgen(_FANOUT)
            elif case == "unknown":
                mod.parse_tgen(_FANOUT.replace('"pause"', '"sleep"'))
            else:
                g = mod.parse_tgen(_TWO_PEERS if case == "two_peers"
                                   else _NO_PEERS)
                kw = {} if mod is jtgen else {"device": "cpu"}
                mod.build_state(2, [g], [0, 0], [0, 0],
                                resolve_peer=lambda s: (1, 80), **kw)


def test_build_state_equals_jax():
    """Both examples' graphs plus the templates, hosts on every graph and
    none, start and stop times per host."""
    srcs = _graph_sources()
    jg = [jtgen.parse_tgen(s) for s in srcs]
    tg = [ttgen.parse_tgen(s) for s in srcs]
    rng = np.random.default_rng(3)
    h = 11
    host_graph = rng.integers(-1, len(srcs), h)
    start = rng.integers(0, 10 * SEC, h)
    stop = np.where(rng.random(h) < 0.5, INV, start + SEC)
    names = {"server": 0, "client": 1, "other": 2}

    def resolve(spec):
        host, port = spec.rsplit(":", 1)
        return names.get(host, 3), int(port)

    js = jtgen.build_state(h, jg, host_graph, start, stop,
                           resolve_peer=resolve)
    ts = ttgen.build_state(h, tg, host_graph, start, stop,
                           resolve_peer=resolve, device="cpu")
    assert_same(convert.to_numpy(ts), jax_tree(js), "build_state")
    js0 = jtgen.build_state(h, jg, host_graph, start, resolve_peer=resolve)
    ts0 = ttgen.build_state(h, tg, host_graph, start, resolve_peer=resolve,
                            device="cpu")
    assert_same(convert.to_numpy(ts0), jax_tree(js0), "build_state (no stop)")


def test_build_tgen_equals_jax():
    """sim.build_tgen: the same world (state and params) as the JAX
    build_tgen, and a JAX tgen state carried across by convert."""
    js, jp, ja = jsim.build_tgen(6, server=2, streams=2, seed=4)
    ts, tp, ta = tsim.build_tgen(6, server=2, streams=2, seed=4,
                                 device="cpu")
    assert_same(convert.to_numpy(ts), jax_tree(js), "build_tgen state")
    assert_same(convert.to_numpy(tp), jax_tree(jp), "build_tgen params")
    assert ta == ttgen.Tgen() and ta.rx_batch == ja.rx_batch == 4
    assert not hasattr(ta, "may_loopback") and teng._may_loopback(ta)
    back = convert.state_from_jax(jax_tree(js), device="cpu",
                                  app_cls=ttgen.TgenState)
    assert_same(convert.to_numpy(back), jax_tree(js), "state_from_jax")


# ---------------------------------------------------------------------------
# The 8-host world (one JAX compile for the module)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX states of the 8-host world at CAPTURE_S (reference graph), and
    its params and app."""
    js, jp, ja = jsim.build_tgen(H)
    jp = jp.replace(megakernel=False)
    out, s = [], js
    for t in CAPTURE_S:
        s = jeng.run_until(s, jp, ja, int(t * SEC))
        out.append(s)
    return out, jp, ja


@functools.lru_cache(maxsize=None)
def _jax_tick():
    _states, jp, ja = _jax_run()
    return jax.jit(lambda s, em, t, act: ja.on_tick(s, jp, em, t, act))


def _pick(rng, shape, *vals):
    return np.asarray(vals)[rng.integers(0, len(vals), shape)]


def _randomise(tree, rng, tick):
    """Registers and sockets of every host drawn so that each branch of
    on_tick runs somewhere: cursors on every node (the server's start
    node too), due and future starts and stops, running and idle
    streams, torn and open client sockets with full and short replies
    and errors, due and future pauses, ids past 2^32, and child sockets
    whose reply is due, partly written, written, or near the u32 wrap."""
    for blk in ("app", "socks"):
        tree[blk] = {k: np.array(v) for k, v in tree[blk].items()}
    a, s = tree["app"], tree["socks"]
    h, n = s["stype"].shape
    u32 = lambda x: np.asarray(x, np.int64) & 0xFFFFFFFF

    a["cur"] = _pick(rng, h, -1, 0, 1, 2, 2, 2, 3, 3, 4, 4).astype(np.int32)
    a["started"] = rng.random(h) < 0.8
    a["finished"] = rng.random(h) < 0.15
    a["start_t"] = tick + _pick(rng, h, -SEC, 0, SEC)
    a["stop_t"] = _pick(rng, h, INV, INV, INV, tick - 1, tick + 1)
    a["iters"] = _pick(rng, h, 0, 2, 5)
    a["wait_until"] = _pick(rng, h, INV, INV, tick - 5 * MS, tick,
                            tick + 5 * MS)
    a["t_next"] = _pick(rng, h, INV, tick, tick + MS)
    a["stream_active"] = rng.random(h) < 0.7
    a["conn_ctr"] = _pick(rng, h, 0, 1, 2, 19_999, (1 << 32) - 1,
                          (1 << 32) + 3, 7 * (1 << 33) + 5)
    a["cur_send"] = _pick(rng, h, 50 * 1024, 0, 9, (1 << 32) - 2,
                          (1 << 32) + 100)
    a["cur_recv"] = _pick(rng, h, 200 * 1024, 0, 3000, (1 << 32) + 7)
    a["streams_done"] = rng.integers(0, 3, h)
    a["streams_failed"] = rng.integers(0, 2, h)

    # the client slot
    c = 1
    s["stype"][:, c] = _pick(rng, h, 2, 2, 2, 0)
    s["tcp_state"][:, c] = _pick(rng, h, 8, 0, 4, 9, 5, 2)
    s["error"][:, c] = _pick(rng, h, 0, 0, 110)
    s["bytes_recv"][:, c] = np.maximum(
        a["cur_recv"] + _pick(rng, h, -1, 0, 0, 1, -5000), 0)
    s["app_closed"][:, c] = rng.random(h) < 0.3
    # every slot: the bounded write's inputs near the u32 wrap, and the
    # end of the stream within reach: the client's request end, a
    # child's reply end (1 + the peer's cur_send / cur_recv)
    peer = rng.integers(-1, h, (h, n))
    target = np.where(np.arange(n)[None, :] == c, 1 + a["cur_send"][:, None],
                      1 + a["cur_recv"][np.clip(peer, 0, h - 1)])
    una = np.where(rng.random((h, n)) < 0.5,
                   (1 << 32) - rng.integers(1, 300_000, (h, n)),
                   rng.integers(0, 1 << 20, (h, n)))
    near = rng.random((h, n)) < 0.5
    una = np.where(near, target - _pick(rng, (h, n), 0, 100, 5000), una)
    end = np.where(near & (rng.random((h, n)) < 0.5), target,
                   una + _pick(rng, (h, n), 0, 1, 1000, 204_801, 2_000_000))
    s["snd_una"] = u32(una).astype(s["snd_una"].dtype)
    s["snd_end"] = u32(end).astype(s["snd_end"].dtype)
    s["snd_buf_cap"] = _pick(rng, (h, n), 16384, 131072, 4194304,
                             -2).astype(np.int32)
    s["snd_wnd"] = _pick(rng, (h, n), 0, 65535).astype(np.int32)
    # server slots: children of a listener, their peer anywhere
    srv = np.ones((h, n), bool)
    srv[:, c] = False
    s["stype"] = np.where(srv, _pick(rng, (h, n), 2, 2, 2, 0),
                          s["stype"]).astype(np.int32)
    s["parent"] = np.where(srv, _pick(rng, (h, n), -1, 0, 0),
                           s["parent"]).astype(np.int32)
    s["tcp_state"] = np.where(srv, _pick(rng, (h, n), 4, 4, 9, 1, 8),
                              s["tcp_state"]).astype(np.int32)
    s["peer_host"] = np.where(srv, peer, s["peer_host"]).astype(np.int32)
    want = a["cur_send"][np.clip(peer, 0, h - 1)]
    s["bytes_recv"] = np.where(
        srv, np.maximum(want + _pick(rng, (h, n), -1, 0, 0, 3), 0),
        s["bytes_recv"])
    s["app_closed"] = np.where(srv, rng.random((h, n)) < 0.2,
                               s["app_closed"])
    s["rcv_nxt"] = u32(rng.integers(0, 1 << 32, (h, n))).astype(
        s["rcv_nxt"].dtype)


def _coverage(before, after):
    """Which of on_tick's branches a (before, after) pair took."""
    a0, a1 = before["app"], after["app"]
    s0, s1 = before["socks"], after["socks"]
    return {
        "start": (a1["started"] & ~a0["started"]).any(),
        "init": (a1["conn_ctr"] > a0["conn_ctr"]).any(),
        "done": (a1["streams_done"] > a0["streams_done"]).any(),
        "failed": (a1["streams_failed"] > a0["streams_failed"]).any(),
        "end_count": ((a1["iters"] > a0["iters"]) & a1["finished"]
                      & ~a0["finished"]).any(),
        "pause_draw": ((a0["wait_until"] == INV)
                       & (a1["wait_until"] != INV)).any(),
        "pause_end": ((a0["wait_until"] != INV)
                      & (a1["wait_until"] == INV)).any(),
        "close": (s1["app_closed"][:, 1] & ~s0["app_closed"][:, 1]).any(),
        "server_write": (np.delete(s1["snd_end"] != s0["snd_end"], 1,
                                   axis=1)).any(),
        "server_close": (s1["app_closed"] & ~s0["app_closed"]).sum()
        > (s1["app_closed"][:, 1] & ~s0["app_closed"][:, 1]).sum(),
        "advance": (a1["cur"] != a0["cur"]).any(),
    }


def _rebuild(js, tree):
    def put(obj, d):
        return obj.replace(**{k: jax.numpy.asarray(v) for k, v in d.items()})
    return js.replace(app=put(js.app, tree["app"]),
                      socks=put(js.socks, tree["socks"]))


@pytest.mark.parametrize("cap", range(len(CAPTURE_S) - 1))
def test_on_tick_equals_jax(cap):
    states, jp, ja = _jax_run()
    tick0 = int(CAPTURE_S[cap] * SEC)
    tp = convert.params_from_jax(jax_tree(jp), jax_statics(jp),
                                 device="cpu")
    seen = {}
    for seed in range(24):
        rng = np.random.default_rng(100 * cap + seed)
        tree = jax_tree(states[cap])
        _randomise(tree, rng, tick0)
        js = _rebuild(states[cap], tree)
        h = tree["app"]["cur"].shape[0]
        tick = tick0 + rng.integers(0, 3, h) * MS
        active = rng.random(h) < 0.8
        lanes = teng._n_lanes(ttgen.Tgen())     # the JAX engine's count
        jem = jemit.empty(h, lanes, js.pool.blk.shape[1])
        jout, _ = _jax_tick()(js, jem, jax.numpy.asarray(tick),
                                    jax.numpy.asarray(active))
        ts = convert.state_from_jax(tree, device="cpu",
                                    app_cls=ttgen.TgenState)
        tem = temit.empty(h, lanes, ts.pool.blk.shape[1], "cpu")
        tout, _ = ttgen.Tgen().on_tick(ts, tp, tem, torch.from_numpy(tick),
                                       torch.from_numpy(active))
        ref = jax_tree(jout)
        assert_same(convert.to_numpy(tout), ref,
                    f"on_tick capture {cap} seed {seed}")
        for k, v in _coverage(tree, ref).items():
            seen[k] = seen.get(k, False) or bool(v)
        jn = np.asarray(ja.next_time(jout))
        tn = ttgen.Tgen().next_time(tout).numpy()
        assert np.array_equal(jn, tn), "next_time"
    missing = [k for k, v in seen.items() if not v]
    assert not missing, f"branches not taken: {missing}"


@pytest.mark.parametrize("persistent", [True, False])
def test_tgen_run_equals_jax(persistent):
    """The 8-host world to 8 s (clients start at 5 s) on the port's two
    paths: the persistent path (window_call, window_plain here) and the
    per-phase path (the kernels' wrappers and the torch tick), leaf for
    leaf against the JAX reference graph at the end of the schedule."""
    states, _jp, _ja = _jax_run()
    ts, tp, ta = tsim.build_tgen(H, persistent=persistent, device="cpu")
    assert tp.megakernel and tp.persistent == persistent
    for t in CAPTURE_S:
        ts = teng.run_until(ts, tp, ta, int(t * SEC))
    jout = jax_tree(states[-1])
    assert jout["app"]["streams_done"].sum() >= H - 1
    assert_same(convert.to_numpy(ts), jout,
                f"tgen world persistent={persistent}")


# ---------------------------------------------------------------------------
# The 100-host world of chip_smoke.py (slow)
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_tgen_bench_trajectory():
    """chip_smoke.py's tgen world and schedule (run_until to TGEN_MID_NS,
    then to TGEN_NS): the JAX package's trajectory is the one
    chip_smoke.py embeds, its fused path (megakernel and persistent, the
    JAX defaults) ends in the same state as its reference graph, and the
    port's plain per-phase path on the CPU gives the same full final
    state."""
    cs = _chip_smoke()
    js, jp_fused, ja = jsim.build_tgen(cs.TGEN_HOSTS)
    jp = jp_fused.replace(megakernel=False)
    jmid = jeng.run_until(js, jp, ja, cs.TGEN_MID_NS)
    jout = jeng.run_until(jmid, jp, ja, cs.TGEN_NS)
    assert cs.tgen_summary(jmid) == cs.JAX_TGEN_MID
    assert cs.tgen_summary(jout) == cs.JAX_TGEN_FINAL
    assert jp_fused.megakernel
    jfused = jeng.run_until(jeng.run_until(js, jp_fused, ja, cs.TGEN_MID_NS),
                            jp_fused, ja, cs.TGEN_NS)
    assert_same(jax_tree(jfused), jax_tree(jout), "JAX fused path")
    ts, tp, ta = tsim.build_tgen(cs.TGEN_HOSTS, megakernel=False,
                                 persistent=False, device="cpu")
    tout = teng.run_until(teng.run_until(ts, tp, ta, cs.TGEN_MID_NS), tp,
                          ta, cs.TGEN_NS)
    assert_same(convert.to_numpy(tout), jax_tree(jout), "tgen bench world")
