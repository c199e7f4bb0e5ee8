"""The port's TCP machine and bulk world against the JAX package (CPU).

The same inputs, made from a numpy seed, go through the JAX function and
the port's plain torch counterpart, and every output leaf must be equal:

* the u32 sequence helpers and the two range scoreboards
  (`_ranges_insert_many`, `_ranges_drain`) on random inputs, values near
  2^32 and tied sort keys included;
* `process_arrivals`, `run_timers` and `transmit` on states captured mid
  run of the 4-host lossy bulk world (the world of
  tests/test_megakernel.py TestTcpNeutrality), with the socket fields
  and the segments randomised around them so that every branch runs:
  scoreboard inserts and their global re-pack, handshakes, RST, FIN,
  persist, RTO backoff, SACK-aware retransmission, back-pressure, both
  qdiscs, sequence numbers that wrap;
* that world's whole run to 3 s at reliability 1.0 and 0.97, through the
  port's kernel wrappers (their plain versions on the CPU) and through
  its reference graph;
* the crafted slab overflow of tests/test_ack_shed.py through the port's
  `_exchange_core` and `_exchange_tail`, and random full-width pools with
  pure ACKs through the JAX exchange_call kernel (Pallas interpret mode)
  and the port's exchange wrapper;
* (slow) a micro-step of that world through the JAX microstep_fused
  kernels and the port's microstep_fused (K_DELIVER, run_timers, the
  tick, K_TRANSPORT; their plain versions on the CPU);
* `check_supported` refusing Echo, Gossip and an unknown congestion
  control, and admitting CUBIC, and Bulk and Tgen on the persistent path
  (K_WINDOW's TCP kernels).

(slow) The bulk bench world of chip_smoke.py: the JAX package's
trajectory equals the constants chip_smoke.py holds the card to, and the
port's plain path gives the same final state.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu import sim as jsim
from shadow1_tpu.core import emit as jemit
from shadow1_tpu.core import engine as jeng
from shadow1_tpu.core import megakernel as jmk
from shadow1_tpu.transport import tcp as jtcp
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import sim as tsim
from shadow1_tpu_torch.apps import bulk as tbulk
from shadow1_tpu_torch.core import emit as temit
from shadow1_tpu_torch.core import engine as teng
from shadow1_tpu_torch.core import megakernel as tmk
from shadow1_tpu_torch.transport import tcp as ttcp

from _torch_parity import assert_same, jax_statics, jax_tree

MS = 1_000_000
SEC = 1_000_000_000
INV = (1 << 63) - 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = dict(num_hosts=4, bytes_per_client=30_000, stop_time=4 * SEC,
             seed=11)
U32_SOCK = sorted(convert.st.SocketTable.U32_FIELDS)


def _u32(a):
    return np.asarray(a, dtype=np.int64).astype(np.uint32)


def _t(a):
    """A numpy array as a torch tensor (uint32 held in int64)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True))


def _same(port, jax_val, label):
    p = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port)
    j = np.asarray(jax_val)
    if j.dtype == np.uint32:
        p = p.astype(np.uint32)
    assert p.dtype == j.dtype, f"{label}: dtype {p.dtype} != {j.dtype}"
    np.testing.assert_array_equal(p, j, err_msg=label)


# ---------------------------------------------------------------------------
# Sequence helpers and scoreboards
# ---------------------------------------------------------------------------


def _seq_pairs(rng, n):
    """u32 pairs spread over the ring, near 0 and near 2^32, and at
    distances around +-2^31 where the sign flips."""
    a = np.concatenate([rng.integers(0, 1 << 32, n),
                        (1 << 32) - rng.integers(1, 5000, n),
                        rng.integers(0, 5000, n)])
    d = np.concatenate([rng.integers(-5000, 5000, 2 * n),
                        rng.integers(-(1 << 31) - 2, -(1 << 31) + 2, n // 2),
                        rng.integers((1 << 31) - 2, (1 << 31) + 2,
                                     n - n // 2)])
    return _u32(a), _u32(a + d)


def test_sequence_helpers_equal_jax():
    a, b = _seq_pairs(np.random.default_rng(0), 4096)
    for name in ("_sdiff", "_seq_lt", "_seq_leq", "_seq_min", "_seq_max"):
        j = getattr(jtcp, name)(jnp.asarray(a), jnp.asarray(b))
        t = getattr(ttcp, name)(_t(a), _t(b))
        _same(t, j, name)


def _ranges(rng, h, r, base):
    """[h, r] u32 scoreboards around `base`: sorted or shuffled, merged or
    overlapping, with empties (zero and nonzero lo == hi) and tied lo."""
    lo = np.zeros((h, r), np.int64)
    hi = np.zeros((h, r), np.int64)
    for i in range(h):
        n = rng.integers(0, r + 1)
        off = np.sort(rng.choice(60, size=n, replace=False)) * 500 + 1
        if rng.random() < 0.3 and n > 1:
            off[1] = off[0]                           # tied keys
        ln = rng.integers(1, 1500, n)
        lo[i, :n] = base[i] + off
        hi[i, :n] = lo[i, :n] + ln
        if rng.random() < 0.3:
            perm = rng.permutation(r)
            lo[i], hi[i] = lo[i, perm], hi[i, perm]
        if rng.random() < 0.3 and n:
            j = rng.integers(0, r)
            lo[i, j] = hi[i, j] = rng.integers(0, 1 << 32) * (rng.random()
                                                             < 0.5)
    return _u32(lo), _u32(hi)


@pytest.mark.parametrize("seed", range(4))
def test_ranges_insert_many_equals_jax(seed):
    rng = np.random.default_rng(seed)
    h, r, k = 64, 8, 3
    base = _u32(np.where(rng.random(h) < 0.5,
                         (1 << 32) - rng.integers(1, 30000, h),
                         rng.integers(0, 1 << 32, h)))
    lo, hi = _ranges(rng, h, r, base)
    masks = [rng.random(h) < 0.6 for _ in range(k)]
    ss = [_u32(base.astype(np.int64) + rng.integers(-3000, 30000, h))
          for _ in range(k)]
    es = [_u32(s.astype(np.int64) + rng.integers(0, 3000, h)) for s in ss]
    ss[1] = np.where(rng.random(h) < 0.3, ss[0], ss[1])        # ties
    jlo, jhi = jtcp._ranges_insert_many(
        jnp.asarray(lo), jnp.asarray(hi), [jnp.asarray(m) for m in masks],
        [jnp.asarray(s) for s in ss], [jnp.asarray(e) for e in es],
        jnp.asarray(base))
    tlo, thi = ttcp._ranges_insert_many(
        _t(lo), _t(hi), [_t(m) for m in masks], [_t(s) for s in ss],
        [_t(e) for e in es], _t(base))
    _same(tlo, jlo, "insert lo")
    _same(thi, jhi, "insert hi")


@pytest.mark.parametrize("seed", range(3))
def test_ranges_drain_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    h, r = 64, 8
    nxt = _u32(np.where(rng.random(h) < 0.5,
                        (1 << 32) - rng.integers(1, 10000, h),
                        rng.integers(0, 1 << 32, h)))
    lo, hi = _ranges(rng, h, r, _u32(nxt.astype(np.int64) - 800))
    mask = rng.random(h) < 0.7
    j = jtcp._ranges_drain(jnp.asarray(lo), jnp.asarray(hi),
                           jnp.asarray(nxt), jnp.asarray(mask))
    t = ttcp._ranges_drain(_t(lo), _t(hi), _t(nxt), _t(mask))
    for name, a, b in zip(("lo", "hi", "nxt", "drained"), t, j):
        _same(a, b, f"drain {name}")


# ---------------------------------------------------------------------------
# process_arrivals / run_timers / transmit on captured states
# ---------------------------------------------------------------------------

CAPTURE_MS = (25, 45, 65)


@functools.lru_cache(maxsize=None)
def _captured():
    """JAX states of the lossy 4-host world at CAPTURE_MS (reference
    graph), and its params."""
    js, jp, _ja = jsim.build_bulk(**WORLD, reliability=0.97)
    jp = jp.replace(megakernel=False)
    out, s = [], js
    for t in CAPTURE_MS:
        s = jeng.run_until(s, jp, _ja, t * MS)
        out.append(s)
    return out, jp


def _tree_to_jax(js, tree):
    """The JAX state with its socks / hosts / pool replaced from a numpy
    tree (the randomised copy)."""
    def rebuild(obj, d):
        return obj.replace(**{k: jnp.asarray(v) for k, v in d.items()})
    return js.replace(socks=rebuild(js.socks, tree["socks"]),
                      hosts=rebuild(js.hosts, tree["hosts"]),
                      pool=rebuild(js.pool, tree["pool"]))


def _to_port(tree, jp):
    ts = convert.state_from_jax(tree, device="cpu",
                                app_cls=tbulk.BulkState)
    tp = convert.params_from_jax(jax_tree(jp), jax_statics(jp),
                                 device="cpu")
    return ts, tp


def _shift_host_seq(tree, rows, off):
    """Add a per-host u32 offset to every sequence field of the hosts'
    sockets (wrap-around coverage; ISS is 0 in real worlds)."""
    socks = tree["socks"]
    for f in U32_SOCK:
        a = socks[f].astype(np.int64)
        sh = off[:, None] if a.ndim == 2 else off[:, None, None]
        a[rows] = a[rows] + sh[rows]
        socks[f] = _u32(a)


def _randomise_socks(tree, rng, tick):
    """Perturb the TCP sockets: scoreboards with holes, windows, timers,
    states, recovery -- every field stays in its dtype's range."""
    s = tree["socks"]
    h, n = s["stype"].shape
    tcp = (s["stype"] == 2) & (s["tcp_state"] != 1)
    pick = lambda *v: np.asarray(v)[rng.integers(0, len(v), (h, n))]
    una = s["snd_una"].astype(np.int64)
    nxt_ = s["rcv_nxt"].astype(np.int64)
    for name, base, r in (("ssack", una, 4), ("sack", nxt_, 8)):
        lo = (base[:, :, None] + rng.integers(1, 40, (h, n, r)) * 1460)
        lo = np.sort(lo, axis=2)
        hi = lo + rng.integers(1, 3, (h, n, r)) * 700
        keep = (rng.random((h, n, r)) < 0.5) & tcp[:, :, None]
        s[f"{name}_lo"] = np.where(keep, _u32(lo), s[f"{name}_lo"])
        s[f"{name}_hi"] = np.where(keep, _u32(hi), s[f"{name}_hi"])
    sel = tcp & (rng.random((h, n)) < 0.5)
    s["snd_wnd"] = np.where(sel, pick(0, 1460, 65535, 174760),
                            s["snd_wnd"]).astype(np.int32)
    s["cwnd"] = np.where(sel, pick(1460, 2920, 14600, 60000),
                         s["cwnd"]).astype(np.int32)
    s["snd_end"] = np.where(sel, _u32(s["snd_nxt"].astype(np.int64)
                                      + pick(0, 700, 1460, 9000)),
                            s["snd_end"])
    s["retrans_nxt"] = np.where(sel, s["snd_una"], s["retrans_nxt"])
    s["retrans_end"] = np.where(sel, s["snd_nxt"], s["retrans_end"])
    s["in_recovery"] = np.where(sel, rng.random((h, n)) < 0.3,
                                s["in_recovery"])
    s["dup_acks"] = np.where(sel, pick(0, 2, 3, 5),
                             s["dup_acks"]).astype(np.int32)
    s["app_closed"] = np.where(sel, rng.random((h, n)) < 0.3,
                               s["app_closed"])
    s["delack_pending"] = np.where(sel, pick(0, 1, 2),
                                   s["delack_pending"]).astype(np.int32)
    s["tcp_state"] = np.where(sel & (rng.random((h, n)) < 0.4),
                              pick(2, 3, 4, 5, 6, 7, 8, 9, 10),
                              s["tcp_state"]).astype(np.int32)
    s["rto"] = np.where(sel, pick(200 * MS, SEC, 120 * SEC), s["rto"])
    for f in ("t_rto", "t_delack", "t_tw", "t_persist"):
        s[f] = np.where(sel, pick(INV, tick - 5 * MS, tick, tick + 9 * MS),
                        s[f]).astype(np.int64)


def _segments(tree, rng, tick):
    """One random segment per host, mostly addressed to one of its TCP
    sockets (in-order, out-of-order, old or past-window data, pure or
    duplicate ACKs with SACK blocks, SYN, FIN, RST, probes), sometimes to
    no socket.  Returns ([H, 24] int32 rows, [H] pkt ids)."""
    s = tree["socks"]
    h, n = s["stype"].shape
    row = np.zeros((h, 24), np.int64)
    for i in range(h):
        tcp = np.flatnonzero(s["stype"][i] == 2)
        if len(tcp) and rng.random() < 0.85:
            k = rng.choice(tcp)
            peer = s["peer_host"][i, k]
            row[i, 0] = peer if peer >= 0 else rng.integers(0, h)
            row[i, 1] = s["peer_port"][i, k] if peer >= 0 else 40000
            row[i, 2] = s["local_port"][i, k]
        else:
            k = 0
            row[i, 0:3] = rng.integers(0, h), rng.integers(1, 50000), \
                rng.choice([80, 40000, 7])
        row[i, 3] = 6
        row[i, 4] = rng.choice([16, 16, 16, 24, 17, 2, 18, 4, 20, 1])
        row[i, 5] = int(s["rcv_nxt"][i, k]) + rng.choice(
            [-1460, 0, 0, 0, 1460, 2920, 7300, 400000])
        una, nx = int(s["snd_una"][i, k]), int(s["snd_nxt"][i, k])
        row[i, 6] = una + rng.integers(-1460, max(nx - una, 0) + 1461)
        row[i, 7] = rng.choice([0, 1460, 65535, 174760])
        row[i, 8] = rng.choice([0, 0, 1460, 700])
        row[i, 9] = -1
        ts = int(rng.integers(1, tick))
        tse = int(rng.choice([0, rng.integers(1, tick)]))
        row[i, 14:16] = ts & ((1 << 31) - 1), ts >> 31
        row[i, 16:18] = tse & ((1 << 31) - 1), tse >> 31
        for b in range(3):
            if rng.random() < 0.5:
                lo = una + int(rng.integers(1, 30)) * 1460
                row[i, 18 + 2 * b] = lo
                row[i, 19 + 2 * b] = lo + int(rng.integers(1, 4)) * 1460
    row = _u32(row).view(np.int32)
    ids = (row[:, 0].astype(np.int64) << 40) | rng.integers(0, 1 << 20, h)
    return row, ids


def _seq_offsets(rng, h):
    off = (1 << 32) - rng.integers(1, 40 * 1460, h)
    return np.where(rng.random(h) < 0.5, off, 0).astype(np.int64)


@pytest.mark.parametrize("cap", range(len(CAPTURE_MS)))
@pytest.mark.parametrize("seed", range(3))
def test_process_arrivals_equals_jax(cap, seed):
    states, jp = _captured()
    rng = np.random.default_rng(1000 * cap + seed)
    tree = jax_tree(states[cap])
    h = tree["socks"]["stype"].shape[0]
    tick = CAPTURE_MS[cap] * MS
    _randomise_socks(tree, rng, tick)
    row, ids = _segments(tree, rng, tick)
    off = _seq_offsets(rng, h)
    _shift_host_seq(tree, np.arange(h), off)
    r64 = row.view(np.uint32).astype(np.int64)
    for c in (5, 6, 18, 19, 20, 21, 22, 23):
        nz = (c < 18) | (r64[:, c] != 0)
        r64[:, c] = np.where(nz, r64[:, c] + off, r64[:, c])
    row = _u32(r64).view(np.int32)
    t_h = tick + rng.integers(0, 3, h)
    mask = rng.random(h) < 0.85
    slot = int(rng.choice([0, 7, 8, 9]))
    js = _tree_to_jax(states[cap], tree)
    em_j = jemit.empty(h, 10, cols=28)
    jst, jem = jtcp.process_arrivals(
        js, jp, em_j, jnp.asarray(t_h),
        jeng.RxPkt(jnp.asarray(row), jnp.asarray(ids), jnp.asarray(t_h)),
        jnp.asarray(mask), reply_slot=slot)
    ts, tp = _to_port(tree, jp)
    em_t = temit.empty(h, 10, 28, "cpu")
    tst, tem = ttcp.process_arrivals(
        ts, tp, em_t, _t(t_h), teng.RxPkt(_t(row), _t(ids), _t(t_h)),
        _t(mask), reply_slot=slot)
    label = f"process_arrivals t={CAPTURE_MS[cap]}ms seed={seed}"
    assert_same(convert.to_numpy(tst.socks), jax_tree(jst.socks), label)
    assert_same(convert.to_numpy(tem), jax_tree(jem), label + " em")
    assert int(tst.err) == int(jst.err), label


@pytest.mark.parametrize("cap", range(len(CAPTURE_MS)))
@pytest.mark.parametrize("seed", range(2))
def test_run_timers_equals_jax(cap, seed):
    states, jp = _captured()
    rng = np.random.default_rng(2000 * cap + seed)
    tree = jax_tree(states[cap])
    h = tree["socks"]["stype"].shape[0]
    tick = CAPTURE_MS[cap] * MS
    _randomise_socks(tree, rng, tick)
    _shift_host_seq(tree, np.arange(h), _seq_offsets(rng, h))
    t_h = tick + rng.integers(0, 3, h)
    active = rng.random(h) < 0.8
    js = _tree_to_jax(states[cap], tree)
    jst, jem = jtcp.run_timers(js, jp, jemit.empty(h, 10, cols=28),
                               jnp.asarray(t_h), jnp.asarray(active))
    ts, tp = _to_port(tree, jp)
    tst, tem = ttcp.run_timers(ts, tp, temit.empty(h, 10, 28, "cpu"),
                               _t(t_h), _t(active))
    label = f"run_timers t={CAPTURE_MS[cap]}ms seed={seed}"
    assert_same(convert.to_numpy(tst.socks), jax_tree(jst.socks), label)
    assert_same(convert.to_numpy(tem), jax_tree(jem), label + " em")


@pytest.mark.parametrize("qdisc", [0, 1])
@pytest.mark.parametrize("cap", range(len(CAPTURE_MS)))
@pytest.mark.parametrize("seed", range(1))
def test_transmit_equals_jax(qdisc, cap, seed):
    states, jp = _captured()
    jp = jp.replace(qdisc=jnp.asarray(qdisc, jnp.int32))
    rng = np.random.default_rng(3000 * cap + 10 * qdisc + seed)
    tree = jax_tree(states[cap])
    h = tree["socks"]["stype"].shape[0]
    tick = CAPTURE_MS[cap] * MS
    _randomise_socks(tree, rng, tick)
    _shift_host_seq(tree, np.arange(h), _seq_offsets(rng, h))
    tree["hosts"]["rr_next"] = rng.integers(
        0, tree["socks"]["stype"].shape[1], h).astype(np.int32)
    stage = tree["pool"]["stage"].reshape(h, -1).copy()
    full = rng.random(h) < 0.4          # back-pressure: almost no room
    stage[full, : stage.shape[1] - 3] = 2
    tree["pool"]["stage"] = stage.reshape(-1)
    t_h = tick + rng.integers(0, 3, h)
    active = rng.random(h) < 0.8
    js = _tree_to_jax(states[cap], tree)
    jst, jem = jtcp.transmit(js, jp, jemit.empty(h, 10, cols=28),
                             jnp.asarray(t_h), jnp.asarray(active))
    ts, tp = _to_port(tree, jp)
    tst, tem = ttcp.transmit(ts, tp, temit.empty(h, 10, 28, "cpu"),
                             _t(t_h), _t(active))
    label = f"transmit qdisc={qdisc} t={CAPTURE_MS[cap]}ms seed={seed}"
    assert_same(convert.to_numpy(tst.socks), jax_tree(jst.socks), label)
    assert_same(convert.to_numpy(tst.hosts), jax_tree(jst.hosts), label)
    assert_same(convert.to_numpy(tem), jax_tree(jem), label + " em")


# ---------------------------------------------------------------------------
# The whole lossy world
# ---------------------------------------------------------------------------


def test_build_bulk_equals_jax():
    js, jp, _ = jsim.build_bulk(**WORLD, reliability=0.97, sock_slots=8)
    ts, tp, ta = tsim.build_bulk(**WORLD, reliability=0.97, sock_slots=8,
                                 device="cpu")
    assert_same(convert.to_numpy(ts), jax_tree(js), "build_bulk state")
    assert_same(convert.to_numpy(tp), jax_tree(jp), "build_bulk params")
    assert ta.rx_batch == 4 and tp.cong == jp.cong == "reno"


@functools.lru_cache(maxsize=None)
def _jax_run(reliability):
    js, jp, ja = jsim.build_bulk(**WORLD, reliability=reliability)
    return jeng.run_until(js, jp.replace(megakernel=False), ja, 3 * SEC)


@pytest.mark.parametrize("megakernel", [True, False])
@pytest.mark.parametrize("reliability", [1.0, 0.97])
def test_bulk_run_equals_jax(reliability, megakernel):
    jout = _jax_run(reliability)
    ts, tp, ta = tsim.build_bulk(**WORLD, reliability=reliability,
                                 megakernel=megakernel, persistent=False,
                                 device="cpu")
    tout = teng.run_until(ts, tp, ta, 3 * SEC)
    assert int(jout.err) == 0
    assert int(jout.socks.bytes_recv.sum()) == 90_000
    assert_same(convert.to_numpy(tout), jax_tree(jout),
                f"bulk rel={reliability} megakernel={megakernel}")


# ---------------------------------------------------------------------------
# The two-class exchange (tests/test_ack_shed.py's crafted overflow)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_data,n_acks,n_free",
                         [(6, 4, 8), (11, 2, 8), (2, 2, 8), (10, 0, 4),
                          (0, 9, 5)])
def test_ack_shed_exchange_equals_jax(n_data, n_acks, n_free):
    from test_ack_shed import _craft, _world
    js, jp = _world()
    js = _craft(js, n_data, n_acks, n_free)
    jout = jeng._exchange_body(js, jp)
    ts = convert.state_from_jax(jax_tree(js), device="cpu",
                                app_cls=tbulk.BulkState)
    tp = convert.params_from_jax(jax_tree(jp), jax_statics(jp),
                                 device="cpu")
    h = ts.hosts.num_hosts
    pool, ib, total, tprot, n_free_t = teng._exchange_core(
        ts.pool, ts.inbox, h, tp)
    tout = teng._exchange_tail(ts.replace(pool=pool, inbox=ib), total,
                               tprot, n_free_t)
    label = f"exchange data={n_data} acks={n_acks} free={n_free}"
    assert_same(convert.to_numpy(tout), jax_tree(jout), label)
    thinned = int(tout.hosts.acks_thinned.sum())
    assert thinned == max(0, min(n_acks, n_data + n_acks - n_free)), label


def _random_wide_world(h, seed):
    """A JAX bulk world of h hosts whose full-width outbox and inbox are
    filled at random; a third of the rows are pure ACKs, and destination
    3 gets more movers than free slots, so the two-class re-rank runs."""
    state, params, _app = jsim.build_bulk(num_hosts=h, pool_capacity=h * 8,
                                          seed=seed)
    r = np.random.default_rng(seed)
    pool, ib = state.pool, state.inbox
    p0, pc = pool.blk.shape
    p1, ic = ib.blk.shape
    blk = r.integers(0, 2**31 - 1, (p0, pc), dtype=np.int64).astype(np.int32)
    ack = r.random(p0) < 0.35
    blk[:, 3] = np.where(ack | (r.random(p0) < 0.8), 6, 17)
    blk[:, 4] = np.where(ack, 16, r.choice([16, 17, 18, 24], p0))
    blk[:, 8] = np.where(ack, 0, r.choice([0, 1460], p0))
    dst = r.integers(0, h, p0).astype(np.int32)
    dst[r.random(p0) < 0.3] = 3
    blk[:, pc - 4] = dst
    stage = r.choice(np.array([0, 1, 2], np.int32), p0, p=[0.3, 0.2, 0.5])
    time = r.integers(0, 2**45, p0).astype(np.int64)
    iblk = r.integers(0, 2**31 - 1, (p1, ic), dtype=np.int64).astype(np.int32)
    istage = r.choice(np.array([0, 2, 3], np.int32), p1, p=[0.6, 0.3, 0.1])
    pool = pool.replace(blk=blk, stage=stage, time=time)
    ib = ib.replace(blk=iblk, stage=istage)
    return pool, ib, params


@pytest.mark.parametrize("h,seed", [(16, 1), (32, 2)])
def test_tcp_exchange_equals_jax_kernel(h, seed):
    import jax
    pool, ib, params = _random_wide_world(h, seed)
    jout = jax.jit(lambda p, i: jmk.exchange_call(p, i, h, params))(pool, ib)
    tpool = convert._build(convert.st.PacketPool, jax_tree(pool), "cpu")
    tib = convert._build(convert.st.Inbox, jax_tree(ib), "cpu")
    tparams = convert.params_from_jax(jax_tree(params),
                                      jax_statics(params), device="cpu")
    tout = tmk.exchange_call(tpool, tib, h, tparams)
    names = ("pool", "inbox", "total", "total_prot", "n_free")
    port = {n: convert.to_numpy(v) for n, v in zip(names, tout)}
    ref = {n: jax_tree(v) for n, v in zip(names, jout)}
    assert (ref["total_prot"] < ref["total"]).any(), "no re-rank ran"
    assert_same(port, ref, f"TCP exchange h={h} seed={seed}")


@pytest.mark.slow
def test_tcp_microstep_equals_jax_kernels():
    """(slow: the JAX kernels compile in Pallas interpret mode, ~30 s)"""
    import jax
    states, jp = _captured()
    state = jeng._exchange(states[1], jp)
    t_h, gmin = jeng._scan_all(state, jp, jsim.bulk_app.Bulk())
    we = int(min(max(int(state.now), int(gmin)) + int(jp.min_latency_ns),
                 WORLD["stop_time"]))
    assert int(gmin) < we, "the probe window has no micro-step"
    params = jp.replace(megakernel=True, persistent=False)
    app = jsim.bulk_app.Bulk()
    js, jth, jg = jax.jit(
        lambda s, th: jmk.microstep_fused(s, params, app, th, we))(
        state, t_h)
    ts = convert.state_from_jax(jax_tree(state), device="cpu",
                                app_cls=tbulk.BulkState)
    tp = convert.params_from_jax(jax_tree(params), jax_statics(params),
                                 device="cpu")
    ts2, th2, g2 = tmk.microstep_fused(ts, tp, tbulk.Bulk(),
                                       convert._tensor(np.asarray(t_h), "cpu"),
                                       we)
    assert int(js.n_steps) == int(state.n_steps) + 1
    assert_same({"state": convert.to_numpy(ts2), "th": th2.numpy(),
                 "gmin": g2.numpy()},
                {"state": jax_tree(js), "th": np.asarray(jth),
                 "gmin": np.asarray(jg)}, "TCP microstep")


# ---------------------------------------------------------------------------
# What the port refuses
# ---------------------------------------------------------------------------


def _refusal_cases():
    from shadow1_tpu.apps.echo import EchoServer
    from shadow1_tpu.apps.gossip import Gossip
    ts, tp, ta = tsim.build_bulk(**WORLD, reliability=0.97, device="cpu")
    return {
        "echo": (ts, tp.replace(persistent=False), EchoServer(),
                 NotImplementedError, "EchoServer is not ported"),
        "gossip": (ts, tp.replace(persistent=False), Gossip(),
                   NotImplementedError, "Gossip is not ported"),
    }


@pytest.mark.parametrize("case", ["echo", "gossip"])
def test_check_supported_refuses_by_name(case):
    ts, tp, app, exc, msg = _refusal_cases()[case]
    with pytest.raises(exc, match=msg):
        teng.run_until(ts, tp, app, 10 * MS)
    with pytest.raises(exc, match=msg):
        teng.run_chunked(ts, tp, app, 10 * MS)


def test_check_supported_admits_cubic():
    """CUBIC is carried on both paths (tests/test_torch_cubic.py holds its
    runs to the JAX package); an unknown algorithm is refused by name."""
    ts, tp, ta = tsim.build_bulk(**WORLD, reliability=0.97, device="cpu")
    for persistent in (True, False):
        p = tp.replace(cong="cubic", persistent=persistent)
        teng.check_supported(ts, p, ta)
        out = teng.run_until(ts, p, ta, 10 * MS)
        assert int(out.now) == 10 * MS and int(out.err) == 0
    with pytest.raises(ValueError, match="unknown congestion control"):
        teng.run_until(ts, tp.replace(cong="vegas"), ta, 10 * MS)


def test_persistent_bulk_is_admitted():
    """Bulk has a device tick (csrc/bulk_tick.cuh), so the default
    persistent path takes it: check_supported admits it, and its first
    window runs through window_call (window_plain on the CPU)."""
    ts, tp, ta = tsim.build_bulk(**WORLD, reliability=0.97, device="cpu")
    assert tp.persistent and ta.device_tick == "bulk"
    teng.check_supported(ts, tp, ta)
    assert tmk.persistent_enabled(ts, tp, ta)
    out = teng.run_until(ts, tp, ta, 10 * MS)
    assert int(out.n_windows) == 1 and int(out.n_steps) > 0


def test_persistent_tgen_is_admitted():
    """Tgen has a device tick (csrc/tgen_tick.cuh) and may loop back, so
    the default persistent path takes it: check_supported admits it, and
    its first window runs through window_call (window_plain on the
    CPU)."""
    ts, tp, ta = tsim.build_tgen(4, device="cpu")
    assert tp.persistent and ta.device_tick == "tgen"
    assert teng._may_loopback(ta)
    teng.check_supported(ts, tp, ta)
    assert tmk.persistent_enabled(ts, tp, ta)
    # Clients start at 5 s: the first window opens there.
    out = teng.run_until(ts, tp, ta, 5 * SEC + 10 * MS)
    assert int(out.n_windows) == 1 and int(out.n_steps) > 0


# ---------------------------------------------------------------------------
# The bulk bench world (slow)
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_bulk_bench_trajectory():
    """chip_smoke.py's bulk world and schedule (warm-up to 10 ms with
    run_until, then run_chunked to its end): the JAX package's trajectory
    is the one chip_smoke.py embeds, and the port's plain per-phase path
    on the CPU gives the same full final state."""
    cs = _chip_smoke()
    js, jp, ja = jsim.build_bulk(**cs.BULK)
    jp = jp.replace(megakernel=False)
    jwarm = jeng.run_until(js, jp, ja, cs.WARM_NS)
    jout = jeng.run_chunked(jwarm, jp, ja, cs.BULK_RUN_NS)
    assert cs.tcp_summary(jwarm) == cs.JAX_BULK_WARM
    assert cs.tcp_summary(jout) == cs.JAX_BULK_FINAL
    ts, tp, ta = tsim.build_bulk(**cs.BULK, persistent=False, device="cpu")
    tout = teng.run_chunked(teng.run_until(ts, tp, ta, cs.WARM_NS), tp, ta,
                            cs.BULK_RUN_NS)
    assert_same(convert.to_numpy(tout), jax_tree(jout), "bulk bench world")
