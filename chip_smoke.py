#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (shadow1_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device  -- a CUDA card must be present; prints nvidia-smi's name and
   power limit.
2. build   -- builds the three kernels from shadow1_tpu_torch/csrc with
   nvcc (one process per source, in parallel).
3. kernels -- builds the bench phold world on the card, runs it through
   the 10 ms warm-up plus a few windows, then on cloned inputs taken at a
   window boundary (exchange) and at a mid-window micro-step (K_DELIVER,
   K_TRANSPORT) runs each kernel and its plain torch version and requires
   torch.equal on every output leaf; times both (device time from
   torch.profiler, call time with CUDA events) and counts the bytes and
   operations each must move and do on that input.  Then
   checks the f64 log1p of the phold delay draw on all 2^24 keyed_uniform
   values and CoDel's f32 spacing on 2^20 counts against the CPU, and runs
   a congested lossy world through the kernels and through the plain
   versions, which must agree leaf for leaf.
4. main path -- the bench world (H = 16,384, 4 messages per host, 10 ms
   mean delay, rx_batch = 2, pool H*8) for 2 simulated seconds through
   engine.run_until / run_chunked with megakernel=True, persistent=False;
   every kernel's launch counter is zeroed just before and read just
   after, and the trajectory must equal the JAX package's.
   Then one more window runs under torch.profiler: each micro-step
   phase's host and device time from its profiler range, and the
   device's busy share.
5. kernels line -- one JSON object with each kernel's numbers.

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}.  Any failed phase raises (non-zero exit).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

MS = 1_000_000
SEC = 1_000_000_000

# The bench world (bench.py main()).
BENCH = dict(num_hosts=16384, msgs_per_host=4, mean_delay_ns=10 * MS,
             stop_time=3 * SEC, pool_capacity=16384 * 8, rx_batch=2)
WARM_NS = 10 * MS
RUN_NS = 2 * SEC

# A congested, lossy phold world (slow downlinks, 5 % loss) for the
# kernel-vs-plain whole-run check.
STRESS = dict(num_hosts=2048, msgs_per_host=8, mean_delay_ns=10 * MS,
              stop_time=3 * SEC, pool_capacity=2048 * 8, rx_batch=2, seed=5,
              bw_up_Bps=50_000, bw_down_Bps=6_000, reliability=0.95,
              bootstrap_end=20 * MS)
STRESS_NS = 400 * MS

# The JAX package's trajectory of that world and schedule (warm-up to
# 10 ms with run_until, then run_chunked to 2 s; reference graph, which
# tests/test_megakernel.py pins bitwise to the fused kernels), measured on
# the CPU with:
#   env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_phold.py \
#       -m slow -k bench_trajectory
# which asserts these numbers.  BENCH_r07 cross-checks the timed part:
# 1,215 micro-steps, 199 windows, 6,348.54 events per micro-step.
JAX_WARM = dict(n_steps=1, n_windows=1, n_events=16370, sent=16370, recv=0,
                err=0)
JAX_FINAL = dict(n_steps=1216, n_windows=200, n_events=7729852,
                 sent=3874519, recv=3855333, err=1)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM non-tensor f32/int32 lane rate

REPLACES = {
    "exchange": "shadow1_tpu/core/megakernel.py:231",
    "deliver": "shadow1_tpu/core/megakernel.py:516",
    "transport": "shadow1_tpu/core/megakernel.py:576",
}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def summary(state) -> dict:
    return dict(n_steps=int(state.n_steps), n_windows=int(state.n_windows),
                n_events=int(state.n_events),
                sent=int(state.app.sent.sum()), recv=int(state.app.recv.sum()),
                err=int(state.err))


def leaves(obj, prefix=""):
    """(name, tensor) for every tensor leaf of a port dataclass tree."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from leaves(v, f"{prefix}[{i}]")


def require_equal(a, b, label: str) -> float:
    """Fails unless every leaf of `a` equals `b`'s (dtype, shape, values);
    returns the largest |a - b| over the leaves."""
    import torch
    la, lb = list(leaves(a)), list(leaves(b))
    if [n for n, _ in la] != [n for n, _ in lb]:
        _fail(f"{label}: output trees differ in structure")
    err = 0.0
    for (name, x), (_n, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            _fail(f"{label}: kernel and plain version differ at {name}")
        if x.numel():
            wide = torch.float64 if x.is_floating_point() else torch.int64
            err = max(err, float((x.to(wide) - y.to(wide)).abs().max()))
        if not torch.equal(x, y):
            _fail(f"{label}: kernel and plain version differ at {name} "
                  f"(max |diff| {err})")
    return err


def changed_bytes(before, after, skip=()) -> int:
    """Bytes of the elements that differ between two state trees, leaves
    whose name starts with a `skip` prefix left out: the least a function
    that turns `before` into `after` must write."""
    n = 0
    for (name, x), (_n, y) in zip(leaves(before), leaves(after)):
        if not name.startswith(tuple(skip)):
            n += int((x != y).sum()) * x.element_size()
    return n


def deliver_bytes(st, out, delivered_n, active, app) -> int:
    """Bytes K_DELIVER must move on this input: the slab stages of the
    active hosts, the times of their live slots, the rows it consumes,
    the socket rows of the hosts that receive, and the active hosts' rx
    state; then the changed elements, the ring entries it pushes and the
    two [H] outputs."""
    from shadow1_tpu_torch.core.state import STAGE_FREE
    h = st.hosts.num_hosts
    ki = st.inbox.capacity // h
    s = st.socks.slots
    act = active.repeat_interleave(ki)
    stage0, stage1 = st.inbox.stage, out.inbox.stage
    n_act = int(active.sum())
    n_live = int((act & (stage0 != STAGE_FREE)).sum())
    n_taken = int(((stage0 != STAGE_FREE) & (stage1 == STAGE_FREE)).sum())
    n_recv = int(delivered_n.sum())
    n_recv_hosts = int((delivered_n > 0).sum())
    n_push = int((out.socks.udp_count - st.socks.udp_count).sum())
    hs = st.hosts
    rx_row = sum(t.element_size() for t in (
        hs.tokens_rx, hs.last_refill_rx, hs.rx_queued, hs.codel_count,
        hs.codel_dropping, hs.codel_first_above, hs.codel_drop_next,
        hs.pkts_dropped_router, hs.pkts_recv, hs.bytes_recv, hs.t_resume))
    rx_row += 8 + 8 + (8 if app.rx_batch > 1 else 0)   # tick, bw_dn, aux0
    read = (h * 1 + n_act * (ki * 4 + rx_row) + n_live * 8
            + n_taken * 5 * 4                 # src, proto, len, ctr lo/hi
            # sport/dport/payload; the socket's ring head+count and bytes
            + n_recv * (3 * 4 + 2 * 4 + 8)
            # the receiving host's socket rows for the lookup
            + n_recv_hosts * s * 4 * 4)
    written = (changed_bytes(st, out, skip=(".socks.udp_src",
                                            ".socks.udp_sport",
                                            ".socks.udp_len",
                                            ".socks.udp_payload"))
               + n_push * 4 * 4 + h * (4 + 8))
    return read + written


def transport_bytes(s2, out, em, active, params) -> int:
    """Bytes K_TRANSPORT must move on this input: the emission valid
    flags, the valid rows' dst (and the placed rows' other columns), the
    route_blk entries they gather, the active hosts' outbox stages, their
    parked rows and tx state, and every host's inbox slab for the scan;
    then the placed and drained pool rows, the changed host elements and
    th."""
    import torch
    from shadow1_tpu_torch.core.state import (OEXT_COLS, STAGE_FREE,
                                              STAGE_IN_FLIGHT,
                                              STAGE_TX_QUEUED)
    h = s2.hosts.num_hosts
    pc = s2.pool.blk.shape[1]
    ko = s2.pool.capacity // h
    ki = s2.inbox.capacity // h
    st0, st1 = s2.pool.stage, out.pool.stage
    placed = (st0 == STAGE_FREE) & (st1 != STAGE_FREE)
    drained = (st0 == STAGE_TX_QUEUED) & (st1 == STAGE_IN_FLIGHT)
    n_placed, n_drained = int(placed.sum()), int(drained.sum())
    act = active.repeat_interleave(ko)
    n_parked = int((act & (st0 == STAGE_TX_QUEUED)).sum())
    n_act = int(active.sum())
    valid = em.valid
    n_valid = int(valid.sum())
    dst = em.blk[..., pc - OEXT_COLS][valid].clamp(
        0, params.host_vertex.numel() - 1)
    src = torch.arange(h, device=valid.device).unsqueeze(1).expand_as(valid)
    vs = params.host_vertex[src[valid]].to(torch.int64)
    vd = params.host_vertex[dst].to(torch.int64)
    n_routes = int(torch.unique(vs * params.n_vertices + vd).numel())
    n_if = int((s2.inbox.stage == STAGE_IN_FLIGHT).sum())
    hs = s2.hosts
    tx_row = sum(t.element_size() for t in (
        hs.send_ctr, hs.tokens_tx, hs.last_refill_tx, hs.tx_queued,
        hs.pkts_sent, hs.bytes_sent, hs.pkts_dropped_inet,
        hs.pkts_dropped_pool, hs.cpu_avail))
    tx_row += 4 + 8 + 8 + 8 + 4    # host_vertex, bw_up, tick, t_post, n_rx
    scan_row = 1 + 8 + 8 + 8 + ki * 4   # active, t_resume, t_app, cpu ns
    read = (valid.numel() + n_valid * (4 + 4)         # dst, its vertex
            + n_placed * 12 * 4                       # columns copied
            + n_routes * 3 * 4                        # lat lo/hi, rel
            + n_act * (ko * 4 + tx_row) + n_parked * 8
            + n_drained * 4 * 4                       # proto, len, lat
            + h * scan_row + n_if * 8)
    written = (changed_bytes(s2, out, skip=(".pool.",))
               + n_placed * (pc * 4 + 4 + 8) + n_drained * (4 + 8)
               + h * 8)
    return read + written


def _on_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def time_call(run, make_args, reps: int = 7) -> tuple[float, float]:
    """(device ms, call ms) of `run(*make_args())`, inputs made fresh
    (cloned) before each call and not timed.  Device ms: the durations
    of every kernel, copy and memset the call puts on the card, from
    torch.profiler, mean over `reps` calls.  Call ms: CUDA events around
    one call on an idle card, so the host's enqueue time counts (median
    of `reps`).  A warm-up call comes first."""
    import torch
    run(*make_args())
    calls = []
    for _ in range(reps):
        args = make_args()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run(*args)
        t1.record()
        torch.cuda.synchronize()
        calls.append(t0.elapsed_time(t1))
    inputs = [make_args() for _ in range(reps)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for args in inputs:
            run(*args)
        torch.cuda.synchronize()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if _on_device(e))
    return dev_us / reps / 1e3, statistics.median(calls)


def profile_window(state, params, app):
    """Where one window's time goes: the window runs through
    engine.run_until_impl under torch.profiler.  The "microstep.<phase>"
    ranges that core/megakernel.py microstep_fused opens give each
    phase's host time (the range on the host) and its device busy time
    (the kernels that ran inside the range's span on the card); the rest
    is the exchange, the scans and the per-step gmin reads.  Also the
    device-busy share of the window and the top kernels by device time.
    Returns printable lines."""
    import collections
    import torch
    from shadow1_tpu_torch.core import engine
    st = engine.clone_state(state)
    steps0 = int(st.n_steps)
    t_end = int(st.now) + params.min_latency_ns
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        w0 = time.perf_counter()
        st = engine.run_until_impl(st, params, app, t_end)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    steps = max(int(st.n_steps) - steps0, 1)
    host = collections.Counter()
    busy = collections.Counter()
    spans, kernels = [], []
    for e in prof.events():
        if e.name.startswith("microstep."):
            if _on_device(e):
                spans.append((e.time_range.start, e.time_range.end, e.name))
            else:
                host[e.name] += e.time_range.elapsed_us()
        elif _on_device(e):
            kernels.append(e)
    for k in kernels:
        t = k.time_range.start
        phase = next((n for a, b, n in spans if a <= t < b), "outside")
        busy[phase] += k.time_range.elapsed_us()
    per_step = "; ".join(
        f"{n[len('microstep.'):]} host {host[n] / steps / 1e3:.3f} ms, "
        f"device busy {busy[n] / steps / 1e3:.3f} ms" for n in sorted(host))
    by_name = collections.Counter()
    for k in kernels:
        by_name[k.name] += k.time_range.elapsed_us()
    top = "; ".join(f"{n[:60]} {us / 1e3:.2f} ms"
                    for n, us in by_name.most_common(6))
    total = sum(busy.values())
    return [
        f"profile: {steps} micro-steps of one window, wall "
        f"{wall_us / 1e3:.1f} ms under the profiler; per step: {per_step}; "
        f"outside the ranges (exchange, scans, gmin reads) host "
        f"{(wall_us - sum(host.values())) / steps / 1e3:.3f} ms, device "
        f"busy {busy['outside'] / steps / 1e3:.3f} ms",
        f"profile: device busy {total / 1e3:.1f} ms of {wall_us / 1e3:.1f} "
        f"ms wall ({100 * total / wall_us:.1f} %); {len(kernels)} device "
        f"kernels; top by device time: {top}"]


def check_kernels(state, params, app, dev):
    """Each kernel against its plain version on cloned inputs: the
    exchange at a window boundary a few windows after `state`, K_DELIVER
    and K_TRANSPORT at a mid-window micro-step.  Fails unless every
    output leaf is equal.  Returns ({name: (kernel (device ms, call ms),
    plain (device ms, call ms))},
    {name: (bytes, operations) bound}, {name: max |kernel - plain|})."""
    import torch
    from shadow1_tpu_torch.core import emit, engine
    from shadow1_tpu_torch.core import megakernel as mk
    from shadow1_tpu_torch.core.state import STAGE_IN_FLIGHT
    ctx = engine._window_ctx(state, params)
    # A few windows in, then stop at a window boundary.
    for _ in range(3):
        state = engine.run_until(state, params, app,
                                 int(state.now) + params.min_latency_ns)
    clone = engine.clone_state
    h = state.hosts.num_hosts
    times, bounds, errs = {}, {}, {}

    # exchange, at the window boundary.
    def ex_args(s=state):
        c = clone(s)
        return c.pool, c.inbox, h, params
    pk, ik, tot_k, tp_k, nf_k = mk.exchange_kernel(*ex_args())
    pp, ip, tot_p, tp_p, nf_p = mk.exchange_plain(*ex_args())
    errs["exchange"] = require_equal((pk, ik, tot_k, tp_k, nf_k),
                                     (pp, ip, tot_p, tp_p, nf_p), "exchange")
    n_mov = int((state.pool.stage == STAGE_IN_FLIGHT).sum())
    n_placed = int(torch.minimum(tot_p, nf_p).sum())
    ic = state.inbox.blk.shape[1]
    ki = state.inbox.capacity // h
    # Data-dependent: the stage of every pool row and inbox slot, the dst,
    # row and time of each mover, the placed rows and the three tallies.
    bounds["exchange"] = (
        state.pool.stage.numel() * 4 + state.inbox.stage.numel() * 4
        + n_mov * (4 + ic * 4 + 8 + 4) + n_placed * (ic * 4 + 4)
        + 3 * h * 4,
        state.pool.stage.numel() * 2 + n_mov * (ic + 12) + h * ki * 2)
    times["exchange"] = (time_call(mk.exchange_kernel, ex_args),
                         time_call(mk.exchange_plain, ex_args))
    print(f"kernels: exchange equal ({n_mov} movers)", flush=True)

    # Mid-window micro-step: exchange, scan, then two micro-steps.
    st = engine._exchange(clone(state), params, fused=True)
    t_h, gmin = engine._scan_all(st, params, app)
    we = min(max(int(st.now), int(gmin)) + params.min_latency_ns,
             params.stop_time)
    for _ in range(2):
        st, t_h, gmin = mk.microstep_fused(st, params, app, t_h, we, ctx)
    if int(gmin) >= we:
        _fail("the probe window ended before its mid-window micro-step")
    st, active, tick_t = engine._tick_setup(st, t_h, we)
    aux0 = engine._aux_times(st, params, app)

    def dl_args(s=st):
        return (clone(s), params, app, tick_t, active, we, ctx[1], aux0)
    out_k = mk.deliver_kernel(*dl_args())
    out_p = mk.deliver_plain(*dl_args())
    errs["deliver"] = require_equal(out_k, out_p, "deliver")
    s2, delivered_n, t_post = out_p
    n_act = int(active.sum())
    # Operations: per active host the slab scans of the enqueue and of
    # each delivery round plus the NIC/CoDel arithmetic; per delivery the
    # socket lookup.
    bounds["deliver"] = (
        deliver_bytes(st, s2, delivered_n, active, app),
        n_act * (ki * 6 + app.rx_batch * ki * 12 + 60)
        + int(delivered_n.sum()) * st.socks.slots * 8)
    times["deliver"] = (time_call(mk.deliver_kernel, dl_args),
                        time_call(mk.deliver_plain, dl_args))
    print(f"kernels: deliver equal ({int(delivered_n.sum())} deliveries)",
          flush=True)

    em = emit.empty(h, engine._n_lanes(app), s2.pool.blk.shape[1], dev)
    s2, em = engine._app_tick(s2, params, app, em, t_post, active, we)
    t_app = app.next_time(s2)

    def tr_args(s=s2):
        return (clone(s), params, em, tick_t, t_post, active, ctx[0],
                delivered_n, t_app)
    out_k = mk.transport_kernel(*tr_args())
    out_p = mk.transport_plain(*tr_args())
    errs["transport"] = require_equal(out_k, out_p, "transport")
    # Operations: per valid emission the staging arithmetic, per active
    # host its outbox slab scans, per host the post-step scan.
    bounds["transport"] = (
        transport_bytes(s2, out_p[0], em, active, params),
        int(em.valid.sum()) * 60 + n_act * (s2.pool.capacity // h) * 8
        + h * (ki * 6 + 40))
    times["transport"] = (time_call(mk.transport_kernel, tr_args),
                          time_call(mk.transport_plain, tr_args))
    print(f"kernels: transport equal ({int(em.valid.sum())} emissions)",
          flush=True)
    for k, ((kd, kc), (pd, pc)) in times.items():
        print(f"kernels: {k} kernel device {kd:.4f} ms (call {kc:.4f} ms), "
              f"plain device {pd:.4f} ms (call {pc:.4f} ms), bound "
              f"{bounds[k][0]} bytes, {bounds[k][1]} operations", flush=True)
    return times, bounds, errs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "shadow1_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: shadow1_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import shadow1_tpu_torch
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.core import engine, nic, xlamath
    from shadow1_tpu_torch.core import megakernel as mk

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    built = shadow1_tpu_torch.build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})",
          flush=True)

    # ---- 3. kernels against their plain versions ------------------------
    dev = torch.device("cuda")
    state, params, app = sim.build_phold(**BENCH, megakernel=True,
                                         persistent=False, device=dev)
    state = engine.run_until(state, params, app, WARM_NS)
    times, bounds, errs = check_kernels(state, params, app, dev)
    del state

    # f64 log1p of the delay draw on all 2^24 inputs: card vs CPU.
    n_bad = 0
    for lo in range(0, 1 << 24, 1 << 22):
        k = torch.arange(lo, lo + (1 << 22), dtype=torch.int64)
        u = k.to(torch.float64) * (1.0 / (1 << 24))
        gpu = xlamath.log1p(-u.to(dev)).cpu()
        cpu = xlamath.log1p(-u)
        n_bad += int((gpu.view(torch.int64) != cpu.view(torch.int64)).sum())
    if n_bad:
        _fail(f"f64 log1p: card and CPU differ on {n_bad} of 2^24 inputs")
    print("kernels: f64 log1p bitwise equal to the CPU on all 2^24 inputs",
          flush=True)
    cnt = torch.arange(1, 1 << 20, dtype=torch.int32)
    if not torch.equal(nic.codel_spacing(cnt.to(dev)).cpu(),
                       nic.codel_spacing(cnt)):
        _fail("CoDel spacing (f32 rsqrt): card and CPU differ")

    # A congested, lossy world takes the branches the bench world never
    # does (loss draws, TX parking and drain, rx starvation, CoDel drops,
    # slab overflow, bootstrap, the CPU clamp, the PDS trail): the whole
    # run through the kernels must equal the whole run through the plain
    # versions, leaf for leaf.
    finals = []
    for fused in (True, False):
        s0, p0, a0 = sim.build_phold(**STRESS, megakernel=fused,
                                     persistent=False, device=dev)
        p0 = p0.replace(pds_trail=True, cpu_threshold_ns=0,
                        cpu_ns_per_event=torch.full_like(
                            p0.cpu_ns_per_event, 50_000))
        mk.reset_launches()
        finals.append(engine.run_until(s0, p0, a0, STRESS_NS))
        if fused and min(mk.LAUNCHES.values()) <= 0:
            _fail(f"stressed world: a kernel was not launched "
                  f"{mk.LAUNCHES}")
    require_equal(finals[0], finals[1], "stressed world")
    hs = finals[0].hosts
    drops = {k: int(getattr(hs, k).sum()) for k in (
        "pkts_dropped_inet", "pkts_dropped_router", "pkts_dropped_pool")}
    if min(drops.values()) <= 0:
        _fail(f"stressed world did not take every drop path: {drops}")
    print(f"kernels: stressed world (H={STRESS['num_hosts']}, "
          f"{STRESS_NS // MS} ms) equal through kernels and plain "
          f"versions; {int(finals[0].n_steps)} micro-steps, drops {drops}",
          flush=True)
    del finals

    # ---- 4. main path ---------------------------------------------------
    state, params, app = sim.build_phold(**BENCH, megakernel=True,
                                         persistent=False, device=dev)
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    warm = engine.run_until(state, params, app, WARM_NS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = engine.run_chunked(warm, params, app, RUN_NS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(mk.LAUNCHES)
    w, f = summary(warm), summary(out)
    if w != JAX_WARM:
        _fail(f"warm-up trajectory {w} != JAX {JAX_WARM}")
    if f != JAX_FINAL:
        _fail(f"trajectory {f} != JAX {JAX_FINAL}")
    if launches["exchange"] != f["n_windows"] or \
            launches["deliver"] != f["n_steps"] or \
            launches["transport"] != f["n_steps"]:
        _fail(f"launch counts {launches} do not match windows/steps {f}")
    if min(launches.values()) <= 0:
        _fail(f"a kernel was not launched on the main path: {launches}")
    if int((out.app.next_send < 0).sum()) or out.pool.time.min() < 0:
        _fail("negative times in the final state")
    events = (f["sent"] - w["sent"]) + (f["recv"] - w["recv"])
    wall = t2 - t1
    print(f"main path: n_steps {f['n_steps'] - w['n_steps']} n_windows "
          f"{f['n_windows'] - w['n_windows']} n_events "
          f"{f['n_events'] - w['n_events']} events/s {events / wall:.1f} "
          f"wall {wall:.3f} s (warm-up {t1 - t0:.3f} s); launches "
          f"{launches}; trajectory equals the JAX package's", flush=True)

    # ---- 4b. where the time goes, one window after the run ---------------
    for line in profile_window(out, params, app):
        print(line, flush=True)

    # ---- 5. kernels line ------------------------------------------------
    rows = []
    for name in ("exchange", "deliver", "transport"):
        b, ops = bounds[name]
        bytes_ms = b / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": f"shadow1_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": times[name][0][0],
            "plain_ms": times[name][1][0], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
