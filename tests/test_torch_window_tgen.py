"""K_WINDOW's tgen kernels on the CPU (no card here): what the two designs
on the card are held to, and how the wrapper picks between them.

* window_plain, K_WINDOW's plain version, running the windows of a whole
  run_until call (max_windows > 1, as the kernels now loop a call's
  windows on the card) on the 4-host tgen world and on the loopback
  world, leaf for leaf against the JAX package's run_until to the same
  time -- n_windows and n_steps among the leaves;
* the shape rule: the resident kernel (one block per host, its record in
  shared memory; megakernel.resident_record_bytes) for the tgen worlds and
  configs chip_smoke.py runs, the warp design for a world with more hosts
  than resident blocks or a record over what a block may opt into, and
  set_window_tgen_resident forcing either (occupancy from a stand-in for
  the library);
* the scoreboard-gate hazard of the JAX package (the SACK insert's gate
  is a global any(), the insert re-packs every connected host's ranges):
  a host whose sender scoreboard has a dead-zeroed front hole takes a
  plain ACK in the round another host's ACK carries a SACK block; the
  port re-packs the first host's ranges as the JAX reference graph does.

One JAX compile for the module: both worlds have the same shapes.
"""

import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from shadow1_tpu import sim as jsim
from shadow1_tpu.apps import tgen as jtgen
from shadow1_tpu.core import engine as jeng
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import sim as tsim
from shadow1_tpu_torch.apps import tgen as ttgen
from shadow1_tpu_torch.core import engine as teng
from shadow1_tpu_torch.core import megakernel as tmk

from _torch_parity import assert_same, jax_tree

MS = 1_000_000
SEC = 1_000_000_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 4
T0 = 5 * SEC + 150 * MS        # the clients have started (5 s)
T1 = 5 * SEC + 300 * MS


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_world(kind):
    """The JAX package's 4-host tgen world, or chip_smoke.loopback_world
    built by it (the same shapes)."""
    js, jp, ja = jsim.build_tgen(H)
    if kind == "loopback":
        cs = _chip_smoke()
        srv = jtgen.parse_tgen(jsim._TGEN_SERVER_XML.format(port=8888))
        cli = jtgen.parse_tgen(jsim._TGEN_CLIENT_XML.format(
            port=8888, sendsize=50 * 1024, recvsize=200 * 1024, streams=3))
        js = js.replace(app=jtgen.build_state(
            H, [srv, cli], np.ones(H, np.int64), cs.loopback_start_times(H),
            resolve_peer=lambda s: (0, 8888)))
    return js, jp.replace(megakernel=False), ja


def _port_world(kind):
    if kind == "loopback":
        return _chip_smoke().loopback_world(device="cpu")
    return tsim.build_tgen(H, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    """The JAX reference graph's states at T0 and T1."""
    js, jp, ja = _jax_world(kind)
    s0 = jeng.run_until(js, jp, ja, T0)
    return s0, jeng.run_until(s0, jp, ja, T1)


@pytest.mark.parametrize("kind", ["tgen", "loopback"])
def test_window_plain_runs_a_call_equal_jax(kind):
    """From the boundary at T0, window_plain with the cap the engine hands
    down runs every window to T1 in one call (status 0) and equals the
    JAX run_until there; capped at 3 windows a call, the same span in
    several calls (status STATUS_WINDOW_CAP until the last) ends equal
    too."""
    j0, j1 = _jax_run(kind)
    ts, tp, ta = _port_world(kind)
    ts = teng.run_until(ts, tp, ta, T0)
    assert_same(convert.to_numpy(ts), jax_tree(j0), f"{kind} at T0")
    cap = -(-(T1 - T0) // tp.min_latency_ns)
    out, _th, win = tmk.window_plain(ts, tp, ta, T1, cap)
    gmin, _ws, we, pend, status = win.tolist()
    windows = int(out.n_windows) - int(ts.n_windows)
    assert status == 0 and windows >= 5, (status, windows)
    assert int(out.n_steps) - int(ts.n_steps) > windows
    if we < T1:                    # the loop ended on its predicate
        assert min(gmin, pend) >= T1
    out = out.replace(now=torch.full_like(out.now, T1))
    assert_same(convert.to_numpy(out), jax_tree(j1),
                f"{kind}: one window_plain call T0 -> T1")

    calls, st = 0, ts
    while True:
        st, _th, win = tmk.window_plain(st, tp, ta, T1, 3)
        calls += 1
        if int(win[4]) != tmk.STATUS_WINDOW_CAP:
            break
    assert int(win[4]) == 0 and calls == -(-windows // 3)
    st = st.replace(now=torch.full_like(st.now, T1))
    assert_same(convert.to_numpy(st), jax_tree(j1),
                f"{kind}: window_plain calls of 3 windows T0 -> T1")


# ---------------------------------------------------------------------------
# The shape rule
# ---------------------------------------------------------------------------


class _Lib:
    """A stand-in for the window library's occupancy query: one block per
    SM on 132 SMs while the record and 24 KB of static shared memory fit
    the H100's 227 KB."""
    STATIC = 24 * 1024
    OPTIN = 227 * 1024

    @staticmethod
    def window_res_occupancy(buf, cong, record, per_sm, sms, static, optin):
        static._obj.value = _Lib.STATIC
        optin._obj.value = _Lib.OPTIN
        sms._obj.value = 132
        per_sm._obj.value = int(record + _Lib.STATIC <= _Lib.OPTIN)
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tmk, "_RES_OCCUPANCY", {})
    tmk.set_window_tgen_resident(None)
    yield _Lib
    tmk.set_window_tgen_resident(None)


def _config_world(cs, tmp_path, name):
    from shadow1_tpu_torch.config import assemble
    if name == "tgen-100host":
        path = os.path.join(REPO, cs.CLI_100HOST)
    elif name == "iface":
        path = cs.write_iface_config(str(tmp_path / "iface"))
    else:
        path = cs.write_jitter_config(str(tmp_path / "jitter"))
    return assemble.load(path, device="cpu")


@pytest.mark.parametrize("world", ["tgen-world", "tgen-100host", "iface",
                                   "jitter"])
def test_resident_design_takes_the_chip_worlds(stand_in, tmp_path, world):
    """The 100-host tgen world, the 100-host config, the interface-buffer
    config and JITTER_CONFIG all fit: their hosts each take one resident
    block, their records the shared memory a block may opt into."""
    cs = _chip_smoke()
    if world == "tgen-world":
        state, _params, app = tsim.build_tgen(cs.TGEN_HOSTS, device="cpu")
    else:
        w = _config_world(cs, tmp_path, world)
        state, app = w.state, w.app
    h = state.hosts.num_hosts
    record = tmk.tgen_record_bytes(state, app)
    assert record + stand_in.STATIC <= tmk.RES_SMEM_OPTIN
    assert tmk.window_tgen_resident(stand_in, h, record)
    assert not tmk.window_tgen_resident(stand_in, 133, record)
    if world == "tgen-100host":
        # 202 sockets and 3,200-slot slabs: 155,584 bytes.
        assert (state.socks.slots, state.inbox.stage.shape[0] // h) == \
            (202, 3200) and record == 155_584


def test_record_bytes_follow_the_layout():
    """Every socket field in its dtype (ranges included), the slab's stage
    words, times and keys, the emission lanes: each array rounded up to
    16 bytes."""
    per_slot = sum(torch.empty((), dtype=dt).element_size() * (r or 1)
                   for _n, dt, r in tmk._TCP_SOCK_FIELDS)
    assert per_slot == 447
    # 16 sockets: every field a multiple of 16 bytes; 32 slots; 10 lanes
    # of 28 columns (10 flags round up to 16).
    assert tmk.resident_record_bytes(16, 32, 10, 28) == \
        16 * per_slot + 32 * 20 + 16 + 1120
    # One socket: 43 scalar fields of 16 bytes, two 8-range and two
    # 4-range fields of 64 and 32; one slot, one lane of one column.
    assert tmk.resident_record_bytes(1, 1, 1, 1) == \
        43 * 16 + 2 * 64 + 2 * 32 + 3 * 16 + 2 * 16


def test_record_fields_match_the_c_layout():
    """csrc/window.cu's S1_SOCK_FIELDS (the record's socket fields, which
    the kernel lays out and res_record_bytes sums) lists the fields of
    _TCP_SOCK_FIELDS in order, each in the same dtype size and range
    count, so resident_record_bytes is the size the launch checks for."""
    import re
    src = open(os.path.join(REPO, "shadow1_tpu_torch", "csrc",
                            "window.cu")).read()
    body = re.search(r"#define S1_SOCK_FIELDS\(X\)(.*?)\n\n", src,
                     re.S).group(1)
    c = re.findall(r"X\((\w+), (\w+), (\w+)\)", body)
    size = {"int32_t": 4, "int64_t": 8, "uint8_t": 1}
    ranges = {"1": None, "SACK_RANGES": 8, "SSACK_RANGES": 4}
    assert [(n, size[t], ranges[r]) for t, n, r in c] == [
        (n, torch.empty((), dtype=dt).element_size(), r)
        for n, dt, r in tmk._TCP_SOCK_FIELDS]


@pytest.mark.parametrize("h,slots,ki,resident", [
    (100, 16, 32, True), (132, 16, 32, True), (133, 16, 32, False),
    (100, 202, 3200, True), (100, 202, 6000, False),
    (8, 600, 32, False)])
def test_shape_rule(stand_in, h, slots, ki, resident):
    """Resident when every host takes one resident block (132 here) and
    the record with the kernel's static shared memory fits 227 KB; a
    record over 227 KB on its own never queries the card."""
    record = tmk.resident_record_bytes(slots, ki, 10, 28)
    assert tmk.window_tgen_resident(stand_in, h, record) == resident
    if record > tmk.RES_SMEM_OPTIN:
        assert not tmk._RES_OCCUPANCY


def test_selector_forces_either_design(stand_in):
    record = tmk.resident_record_bytes(16, 32, 10, 28)
    tmk.set_window_tgen_resident(False)
    assert not tmk.window_tgen_resident(stand_in, 100, record)
    tmk.set_window_tgen_resident(True)
    assert tmk.window_tgen_resident(stand_in, 100, record)
    with pytest.raises(ValueError, match="133 hosts, 132 blocks"):
        tmk.window_tgen_resident(stand_in, 133, record)
    big = tmk.resident_record_bytes(600, 32, 10, 28)
    with pytest.raises(ValueError, match="opt into"):
        tmk.window_tgen_resident(stand_in, 8, big)


# ---------------------------------------------------------------------------
# The scoreboard-gate hazard (ROADMAP queue 3)
# ---------------------------------------------------------------------------


def _to_jax(obj, tree):
    """The JAX struct `obj` with every leaf replaced from a numpy tree
    (convert.to_numpy's layout)."""
    import jax.numpy as jnp
    if dataclasses.is_dataclass(obj):
        return obj.replace(**{k: _to_jax(getattr(obj, k), v)
                              for k, v in tree.items()})
    return jnp.asarray(tree)


def _conn_slot(socks, hh, peer):
    """The slot of host hh's connected TCP socket to `peer` (ESTABLISHED
    or after: tcp.py's est_like)."""
    est = (socks["stype"][hh] == 2) & (socks["peer_host"][hh] == peer) & \
        np.isin(socks["tcp_state"][hh], [4, 5, 6, 7, 9, 10])
    return int(np.flatnonzero(est)[0])


def _hazard_state():
    """The loopback world's JAX state at T0 with one edit on each of two
    clients whose first arrivals in flight, by (time, pkt_id), are ACKs
    from host 0 at one instant, so both take theirs in round 0 of the next
    window's first micro-step: the first (A) gets a sender scoreboard
    [0, 0), [lo, hi) -- a front hole, its range above any ACK -- and the
    second's ACK (B) a SACK block.  Returns (numpy tree, A, slot of A's
    socket, A's range)."""
    j0, _ = _jax_run("loopback")
    tree = jax_tree(j0)
    pool = {k: np.array(v) for k, v in tree["pool"].items()}
    socks = {k: np.array(v) for k, v in tree["socks"].items()}
    ko = pool["stage"].shape[0] // H
    pc = pool["blk"].shape[1]
    live = np.flatnonzero(pool["stage"][:ko] == 2)    # host 0's outbox
    dst = pool["blk"][live, pc - 4]
    ctr = (pool["blk"][:, 13].astype(np.int64) << 31) | pool["blk"][:, 12]
    picked = []
    for hh in range(1, H):
        mine = live[dst == hh]
        if not len(mine):
            continue
        first = mine[np.lexsort((ctr[mine], pool["time"][mine]))[0]]
        flags = pool["blk"][first, 4]
        if flags & 16 and not flags & 6:       # ACK, neither SYN nor RST
            picked.append((hh, first, pool["time"][first]))
    picked = [(hh, k) for hh, k, t in picked if t == picked[0][2]]
    assert len(picked) >= 2, "no two clients take ACKs first at one time"
    (a, _ka), (b, kb) = picked[:2]
    sa, sb = _conn_slot(socks, a, 0), _conn_slot(socks, b, 0)
    una = int(socks["snd_una"][a, sa])
    lo, hi = (una + 200_000) & 0xFFFFFFFF, (una + 210_000) & 0xFFFFFFFF
    socks["ssack_lo"][a, sa] = [0, lo, 0, 0]
    socks["ssack_hi"][a, sa] = [0, hi, 0, 0]
    ub = int(socks["snd_una"][b, sb])
    for col, off in ((18, 400_000), (19, 401_000)):  # SACK block 0
        pool["blk"][kb, col] = np.uint32((ub + off) & 0xFFFFFFFF).view(
            np.int32)
    tree["pool"], tree["socks"] = pool, socks
    return tree, a, sa, (lo, hi)


def test_scoreboard_gate_hazard_equals_jax_reference():
    """One window from the edited state: on the port's plain path, A's
    front hole is re-packed in the first micro-step (its range moves to
    slot 0) because B inserts in the same round, and the whole window
    equals the JAX reference graph's, leaf for leaf."""
    tree, a, sa, (lo, hi) = _hazard_state()
    js, jp, ja = _jax_world("loopback")
    j0, _ = _jax_run("loopback")
    jstate = _to_jax(j0, tree)
    ts, tp, ta = _port_world("loopback")
    ts = convert.state_from_jax(tree, device="cpu", app_cls=ttgen.TgenState)

    t_h, gmin = teng._scan_all(teng._exchange(ts, tp), tp, ta)
    we = min(max(int(ts.now), int(gmin)) + tp.min_latency_ns, T1)
    st = teng._microstep_core(teng._exchange(ts, tp), tp, ta, t_h, we)
    got = (st.socks.ssack_lo[a, sa].tolist(),
           st.socks.ssack_hi[a, sa].tolist())
    assert got == ([lo, 0, 0, 0], [hi, 0, 0, 0]), got

    t_end = int(ts.now) + tp.min_latency_ns
    jout = jeng.run_until(jstate, jp, ja, t_end)
    tout = teng.run_until(ts, tp, ta, t_end)
    assert int(tout.n_windows) > int(ts.n_windows)
    assert_same(convert.to_numpy(tout), jax_tree(jout),
                "scoreboard-gate hazard, one window")


@pytest.mark.slow
def test_scoreboard_gate_hazard_jax_paths():
    """What the JAX package's fused paths do on the same window (~2 min:
    two interpret-mode compiles).  Its persistent K_WINDOW (window_fused,
    one kernel body over every host) gates globally and equals the
    reference graph; its per-phase path (megakernel, persistent=False)
    runs the inserts per block of hosts (here one host a block), so A's
    block has no insert and A keeps its front hole there."""
    tree, a, sa, (lo, hi) = _hazard_state()
    js, jp, ja = _jax_world("loopback")
    j0, _ = _jax_run("loopback")
    jstate = _to_jax(j0, tree)
    t_end = int(tree["now"]) + int(jp.min_latency_ns)
    ref = jax_tree(jeng.run_until(jstate, jp, ja, t_end))
    window = jax_tree(jeng.run_until(
        jstate, jp.replace(megakernel=True, persistent=True), ja, t_end))
    assert_same(window, ref, "JAX persistent fused path vs reference")
    blocked = jax_tree(jeng.run_until(
        jstate, jp.replace(megakernel=True, persistent=False), ja, t_end))
    ranges = lambda t: (t["socks"]["ssack_lo"][a, sa].tolist(),  # noqa: E731
                        t["socks"]["ssack_hi"][a, sa].tolist())
    assert ranges(ref) == ([lo, 0, 0, 0], [hi, 0, 0, 0])
    assert ranges(blocked) == ([0, lo, 0, 0], [0, hi, 0, 0])
