#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (shadow1_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device  -- a CUDA card must be present; prints nvidia-smi's name and
   power limit.
2. build   -- builds the four kernels from shadow1_tpu_torch/csrc and
   K_WINDOW's phase-clock variant (-DS1_PHASE_CLOCKS) with nvcc (one
   process per library, in parallel, each with --split-compile); prints
   each library's build time and every kernel's registers, stack and
   spills from ptxas.
3. kernels -- builds the bench phold world on the card and runs it
   through the 10 ms warm-up plus a few windows.  On cloned inputs taken
   at a window boundary (exchange, K_WINDOW) and at a mid-window
   micro-step (K_DELIVER, K_TRANSPORT) runs each kernel and its plain
   torch version and requires torch.equal on every output leaf; times
   both (device time from torch.profiler, call time with CUDA events) and
   counts the bytes and operations each must move and do on that input
   (K_WINDOW: the sum over its exchange and micro-steps).  Then checks
   the f64 log1p of the phold delay draw on all 2^24 keyed_uniform values
   against the CPU (the plain torch emulation on the card, and K_WINDOW's
   device log1p), CoDel's f32 spacing on 2^20 counts, and runs a congested
   lossy world through K_WINDOW, through the per-phase kernels and through
   the plain versions, which must agree leaf for leaf.  Also: K_WINDOW's
   windows again with ex_run's exchange instead of k_window's default
   (the previous passes), equal and timed; the general paths of K_DELIVER
   and K_TRANSPORT (the KO world's 12-slot slabs) against their plain
   versions at every micro-step of a congested, lossy window, and
   K_WINDOW's (its micro-step's deliver_host) over that window.  Each
   K_DELIVER check prints the path it took (megakernel.deliver_path).
4. main path -- the bench world (H = 16,384, 4 messages per host, 10 ms
   mean delay, rx_batch = 2, pool H*8) for 2 simulated seconds through
   engine.run_until / run_chunked with the defaults (megakernel and
   persistent: one K_WINDOW launch per run_until call); every kernel's
   launch
   counter is zeroed just before and read just after, and the trajectory
   must equal the JAX package's.  The timed part runs again under
   torch.profiler: K_WINDOW's device time per launch, the host time per
   window and the device's busy share.  Then its first BUSY_WINDOWS
   windows through K_WINDOW's phase-clock build, traced for the host with
   the most events and for the median host (the split of a micro-step by
   phase, K_DELIVER's phases summed; final state equal to the untraced
   run's), and K_DELIVER's bound over those windows' micro-steps.
5. per-phase path -- the same world and schedule with persistent=False
   (exchange, K_DELIVER, app tick in torch, K_TRANSPORT), counters zeroed
   just before and read just after; its final state must equal the
   persistent path's.  Then one window runs under torch.profiler: each
   micro-step phase's host and device time and the device's busy share.
6. TCP kernels -- the bulk world (BULK: 1 server, 99 clients, full
   width) on the card through its warm-up and into the transfer: the TCP
   branches of the exchange (at a window boundary, and on crafted
   slab-overflow inputs that shed pure ACKs), K_DELIVER and K_TRANSPORT
   (at the arrival-heaviest of a window's micro-steps) and K_WINDOW's TCP
   kernel (the whole window at that boundary) against their plain
   versions, torch.equal on every output leaf, timed and bounded as in
   phase 3; the exchange also on crafted fan-ins (FAN_IN movers to one
   host, pure ACKs shed first), where its time at 20,000 movers must stay
   under 20x its time at 2,000.  Then a lossy 16-host bulk world to
   LOSSY_NS through K_WINDOW, through the per-phase kernels and through
   the plain versions, leaf for leaf, with retransmissions reached.
7. TCP per-phase path -- BULK with persistent=False through run_until /
   run_chunked from 0 to BULK_RUN_NS, counters zeroed just before and
   read just after; the trajectory must equal the JAX package's and the
   launches its windows and micro-steps.  Then one window under
   torch.profiler, as in phase 5.
8. TCP main path, persistent -- BULK with sim.build_bulk's defaults (one
   K_WINDOW TCP launch per run_until call), the same schedule, counters
   zeroed just before and read just after: the trajectory must equal the
   JAX package's, the launches one window launch per run_until call
   (RunCalls) and nothing else, and the final state the per-phase path's,
   leaf for leaf.  Then the timed part again, and its first BUSY_WINDOWS
   windows, with CUDA events around each K_WINDOW call (device time per
   launch and per window, the device's busy share); those windows
   through K_WINDOW's phase-clock build, opened by
   the previous exchange passes and by ex_run (the split of the server's
   micro-step by phase, the open's exchange stages among them; final
   state equal to the untraced run's), the exchange's bound at their
   opens beside its traced time, and the first TR_WINDOWS windows
   replayed through the per-phase kernels (K_TRANSPORT's time and bound
   there, and the windows' bound, window_bound over each).
9. pairs world -- PAIRS_H = 40,000 hosts in client -> server pairs to
   100 ms on both paths, counters zeroed just before and read just
   after, final states equal leaf for leaf; k_window_tcp against
   window_plain on its heaviest window.
10. tgen kernels -- the tgen world (TGEN_HOSTS = 100, sim.build_tgen's
   defaults: Shadow's examples/tgen-100host at full width) on the
   persistent path to PROBE_TGEN_NS, mid fan-in: K_WINDOW's two tgen
   designs (TGEN_DESIGNS: the warp design k_window_tgen and the resident
   kernel k_window_tgen_res, one block per host with its record in
   shared memory, whose bytes it prints) each against
   window_plain over the next window, and over the BUSY_WINDOWS windows
   of one call (window_plain with that max_windows), timed on the same
   inputs and bounded as in phase 3; then K_TRANSPORT's TCP kernel with
   the staging's loopback insert against its plain version at every
   micro-step of the loopback world's first window.
11. tgen per-phase path -- the tgen world with persistent=False to
   TGEN_MID_NS, counters zeroed just before and read just after; the
   trajectory must equal the JAX package's and the launches its windows
   and micro-steps.  Then one window under torch.profiler, as in phase 5.
12. tgen main path, persistent -- the tgen world with sim.build_tgen's
   defaults (the resident kernel, one launch per run_until call) to
   TGEN_MID_NS and on to TGEN_NS (120 s), counters zeroed just before and
   read just after: the trajectory must equal the JAX package's, the
   launches one window launch per run_until call and nothing else, and
   the state at TGEN_MID_NS the per-phase path's, leaf for leaf; the same
   run with the warp design forced, held the same way.  Then the part
   after TGEN_MID_NS again with CUDA events around each K_WINDOW call, on
   the same input for each design (device time per window, the device's
   busy share), and BUSY_WINDOWS windows from PROBE_TGEN_NS timed,
   bounded (windows_bound) and traced by phase (the warp design: the
   server, host 0, and a client; the resident kernel: the server's block;
   final states equal to the untraced run's).
13. loopback world -- LOOP_HOSTS = 4 hosts where host 0 streams to its
   own listener, to LOOP_NS on both paths, counters zeroed just before
   and read just after: both trajectories equal the JAX package's and the
   final states each other, leaf for leaf.
14. jitter kernels -- the per-packet jitter draw of K_TRANSPORT's
   staging on jittered worlds (jittered_world: sim.build_phold /
   build_bulk with make_net_params given a jitter table), torch.equal
   against the plain staging: k_transport at every micro-step of a window
   of the STRESS world (transport_small) and of the KO world (the general
   path), k_window over one STRESS window, k_transport_tcp at every
   micro-step of four windows of JITTER_CONFIG at 2.2 s and k_window_tgen
   over one of its windows, k_window_tcp over a window of the LOSSY bulk
   world; each must stage rows that a nonzero draw moved, and each is
   timed with jitter and on the same inputs without.
15. cli: tgen-2host -- `python -m shadow1_tpu_torch run`'s run_config on
   examples/tgen-2host to its 60 s on the card, counters zeroed just
   before and read just after (one K_WINDOW launch a run_until call and
   nothing else): heartbeat.csv's sha256 and summary.json equal the JAX
   CLI's (JAX_CLI), and the printed summary line summary.json's.
16. cli: tgen-100host, the main path -- examples/tgen-100host through
   the CLI to its 120 s on the persistent path (the resident kernel),
   counters zeroed just before and read just after: heartbeat.csv and
   summary.json equal the JAX CLI's; wall, events/s, windows, launches;
   the same with the warp design forced.  The same schedule on the
   per-phase path ends in an equal state with the same heartbeat file;
   the main path again with CUDA events around each K_WINDOW call gives
   the device time per launch and per window and the device's busy
   share.  Then the main path's launch (heartbeat second) from
   CLI_PROBE_S: each design's device time on its input, the bound of its
   windows (window_bound over each), and its busiest window (its windows
   one a call), reached again on the CLI's schedule, each design against
   window_plain over it, timed and bounded as in phase 3; and that
   window on the resident kernel again right after a 4-host world's
   launch (a smaller record) in this process, against window_plain.
17. cli: jittered config -- JITTER_CONFIG through the CLI to its 5 s:
   heartbeat.csv and summary.json equal the JAX CLI's.
18. cubic -- the device f32 cbrt (cbrt_xla) against xlamath.cbrt run on
   the card on all 2^31 non-negative f32 values; CUBIC's device target
   and hooks (tcp.cuh, through a probe kernel) against cong.py on the
   card, bitwise, on 2^20 seeded socket registers each and the edges;
   LOSSY with CUBIC to LOSSY_CUBIC_NS on both paths, each held to the JAX
   package's trajectory (JAX_LOSSY_CUBIC) and the two to each other leaf
   for leaf; the CUBIC instantiations of k_deliver_tcp (every micro-step
   of a window) and k_window_tcp against their plain versions over a
   window that moves CUBIC's state (cubic_moves), timed beside the Reno
   instantiation on the same inputs and bounded.
19. cli: tgen-100host with CUBIC, the slice's main path -- the CLI with
   --tcp-congestion-control cubic to 120 s, counters zeroed just before
   and read just after: heartbeat.csv and summary.json equal the JAX
   CLI's; the config on both paths, launch by launch, equal leaf for
   leaf at every heartbeat second from BURST_FROM_S to BURST_TO_S (the
   opening bursts); k_window_tgen (CUBIC) against window_plain on a
   window that moves CUBIC's state, timed beside Reno.
20. buffers -- STRESS with interface buffers (buffered) on both paths,
   held to JAX_STRESS_BUF and to each other; the buffered k_deliver_small
   and k_window (STRESS) and k_deliver (deliver_host, KO) against their
   plain versions over a window with tail drops, timed beside the
   unbuffered instantiation.  LOSSY with interface buffers
   (lossy_buffered) under Reno and under CUBIC on both paths, held to
   JAX_LOSSY_BUF and JAX_LOSSY_CUBIC_BUF; k_window_tcp<1,0>,
   k_deliver_tcp<1,1> and k_window_tcp<1,1> against their plain versions
   over windows with tail drops (and CUBIC moves), timed the same way.
21. cli: the interface-buffer config (write_iface_config) -- through the
   CLI to 120 s on the persistent path, counters zeroed just before and
   read just after: heartbeat.csv and summary.json equal the JAX CLI's;
   the per-phase path ends in an equal state with the same heartbeat
   file; the buffered k_deliver_tcp and k_window_tgen against their plain
   versions over the window with the most tail drops from IFACE_PROBE_S.
   The config again with --tcp-congestion-control cubic, held to the JAX
   CLI's; k_window_tgen<1,1> against window_plain over a window that
   moves CUBIC's state.
22. apsp -- routing/apsp.py build_matrices on the card against the CPU,
   bitwise, on a random GraphML of APSP_V vertices.
23. kernels line -- one JSON object with each kernel's numbers (ms is
   the device time, call_ms the call time); each kernel's launches come
   from the run of its own path; the TCP branches and the tgen kernel
   are rows of their own, and the tgen kernel has a second row
   (window_tgen_cli) for phase 16's main path and its window there; the
   CUBIC and buffered instantiations (NEW_ROWS) are rows of their own,
   with `other_ms`, the other instantiation on the same inputs.

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}.  Any failed phase raises (non-zero exit).
"""

from __future__ import annotations

import json
import re
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
# Its depth: by 175 ms it has taken every drop path (loss, router, a full
# slab), so the three paths' run stops there (200 ms until the CLI phases
# came: 149 micro-steps).
STRESS_NS = 175 * MS
# A world like it with 12-slot slabs, 12 messages a host and a 3 kB/s
# uplink: K_TRANSPORT's general path (slabs above transport_small's
# eight), checked against its plain version at every micro-step of one
# window, where hosts park, lose and overflow packets.
KO = dict(STRESS, pool_capacity=2048 * 12, msgs_per_host=12,
          bw_up_Bps=3_000)
KO_NS = 150 * MS

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

# The bulk TCP world (sim.build_bulk): the fan-in shape of Shadow's
# examples/tgen-100host, 1 server and 99 clients of 1 MiB each, sized by
# shadow1_tpu/config/assemble.py's rule (sock_slots = min(512, 2 * fan_in
# + 4), slab = min(4096, 32 * (1 + fan_in))).  Its depth is cut to
# BULK_RUN_NS, since the JAX reference on a CPU takes well over ten
# minutes to reach 2 s; 0.5 s holds the slab overflow (err bit 0), the
# go-back-N retransmissions and the first 15 completions.
BULK = dict(num_hosts=100, server=0, bytes_per_client=1 << 20,
            latency_ns=10 * MS, reliability=1.0, sock_slots=204,
            pool_capacity=100 * 3200, seed=1, stop_time=60 * SEC)
BULK_RUN_NS = 500 * MS
# Where the TCP kernels are checked: a window boundary mid-transfer.
TCP_PROBE_NS = 60 * MS

# A lossy bulk world for the kernels-vs-plain whole-run check.
LOSSY = dict(num_hosts=16, bytes_per_client=200_000, reliability=0.97,
             seed=11, stop_time=4 * SEC)
# Its depth: 340 of the 785 micro-steps to its end (2 s), 31 segments
# retransmitted by then (0.8 s and 592 micro-steps until the CUBIC and
# interface-buffer phases came; 1.5 s and 709 before the CLI phases).
LOSSY_NS = 150 * MS

# The JAX package's trajectory of BULK and its schedule (warm-up to 10 ms
# with run_until, then run_chunked to BULK_RUN_NS; reference graph),
# measured on the CPU with:
#   env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tcp.py \
#       -m slow -k bulk_bench_trajectory
# which asserts these numbers.
JAX_BULK_WARM = dict(n_steps=2, n_windows=1, n_events=99, bytes_recv=0,
                     done=0, finish_sum=0, err=0)
JAX_BULK_FINAL = dict(n_steps=21340, n_windows=47, n_events=106189,
                      bytes_recv=48340660, done=15, finish_sum=2578965422,
                      err=1)

# The tgen world (sim.build_tgen at its defaults): Shadow's
# examples/tgen-100host at full width -- 1 server and 99 clients, 50 KiB
# up and 200 KiB down, 3 streams each with 1-2 s pauses, 20 ms full mesh,
# 16 sockets a host, 32-slot slabs, rx_batch 4 -- to its full 120 s,
# through run_until to TGEN_MID_NS and then to TGEN_NS.
TGEN_HOSTS = 100
TGEN_MID_NS = 10 * SEC
TGEN_NS = 120 * SEC
# The loopback world (loopback_world): 4 hosts of that shape where host
# 0 also runs the client graph with itself as its peer, from 1 s, to
# LOOP_NS; its segments to itself take the staging's loopback insert.
LOOP_HOSTS = 4
LOOP_NS = 6 * SEC
# Where K_WINDOW's tgen kernel is checked against window_plain: the
# window that holds PROBE_TGEN_NS, mid fan-in.
PROBE_TGEN_NS = 5500 * MS

# The JAX package's trajectories of those worlds and schedules
# (reference graph), measured on the CPU with:
#   env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tgen.py \
#       -m slow -k tgen_bench_trajectory
#   env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tgen_loopback.py
# which assert these numbers.
JAX_TGEN_MID = dict(n_steps=1747, n_windows=250, n_events=21033, done=35,
                    failed=0, finished=6, err=3)
JAX_TGEN_FINAL = dict(n_steps=11775, n_windows=1823, n_events=128982,
                      done=237, failed=0, finished=79, err=3)
JAX_LOOP_FINAL = dict(n_steps=443, n_windows=39, n_events=3440, done=6,
                      failed=0, finished=1, err=1)
# The JAX package's trajectories of LOSSY with CUBIC to LOSSY_CUBIC_NS
# (tcp_summary) and of STRESS with phase 3's parameters and buffered()'s
# interface buffers to STRESS_NS (summary plus the router drops), both
# with run_until from the start on the reference graph, measured on the
# CPU; tests/test_torch_ifacebuf.py and tests/test_torch_cubic.py
# -m slow assert them.
JAX_LOSSY_CUBIC = dict(n_steps=622, n_windows=52, n_events=6688,
                       bytes_recv=2800000, done=14, finish_sum=3534000000,
                       err=0)
JAX_STRESS_BUF = dict(n_steps=141, n_windows=18, n_events=61194, sent=37858,
                      recv=23336, err=1, drops_router=6272)
# LOSSY with lossy_buffered()'s interface buffers to LOSSY_BUF_NS, under
# Reno and under CUBIC (tcp_summary plus the router drops), the same way;
# tests/test_torch_ifacebuf.py -m slow asserts them.
JAX_LOSSY_BUF = dict(n_steps=119, n_windows=27, n_events=839,
                     bytes_recv=274480, done=0, finish_sum=0, err=0,
                     drops_router=251)
JAX_LOSSY_CUBIC_BUF = dict(n_steps=119, n_windows=27, n_events=840,
                           bytes_recv=274480, done=0, finish_sum=0, err=0,
                           drops_router=252)

# The config worlds of the port's CLI (shadow1_tpu_torch/cli.py run), each
# to its config's own stoptime: Shadow's examples/tgen-2host (60 s) and
# examples/tgen-100host (120 s, the main path; the JAX CLI reaches it on a
# CPU in about 7 minutes, so it is held to the JAX CLI at full depth), and
# JITTER_CONFIG (write_jitter_config, 5 s).
CLI_2HOST = "examples/tgen-2host/shadow.config.xml"
CLI_100HOST = "examples/tgen-100host/shadow.config.xml"
# The heartbeat second (one CLI launch) of examples/tgen-100host whose
# windows phase 16 bounds, and whose busiest window it holds against
# window_plain: the tail of the clients' first streams, windows of a few
# micro-steps.  The launches that hold the streams' opening bursts (from
# 5, 10, 15 and 20 s; phase 16 prints them) run windows of hundreds of
# micro-steps, which window_plain takes minutes to replay.
CLI_PROBE_S = 6
# A config with per-edge jitter and loss on 3 vertices (one explicit
# self-loop), 6 hosts (the server pays 2 us of virtual CPU per event), the
# tgen-100host graphs: 5 clients fetch 64 KiB for 2 KiB sent, from 2 s.
JITTER_CONFIG = """<shadow stoptime="5">
  <topology><![CDATA[<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d1"/>
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d2"/>
  <key attr.name="type" attr.type="string" for="node" id="d3"/>
  <key attr.name="latency" attr.type="double" for="edge" id="d4"/>
  <key attr.name="jitter" attr.type="double" for="edge" id="d5"/>
  <key attr.name="packetloss" attr.type="double" for="edge" id="d6"/>
  <graph edgedefault="undirected">
    <node id="core"><data key="d1">102400</data><data key="d2">102400</data>
      <data key="d3">server</data></node>
    <node id="east"><data key="d1">2048</data><data key="d2">10240</data>
      <data key="d3">client</data></node>
    <node id="west"><data key="d1">4096</data><data key="d2">8192</data>
      <data key="d3">client</data></node>
    <edge source="core" target="east"><data key="d4">20.5</data>
      <data key="d5">4.0</data><data key="d6">0.01</data></edge>
    <edge source="core" target="west"><data key="d4">35.0</data>
      <data key="d5">9.5</data><data key="d6">0.02</data></edge>
    <edge source="east" target="west"><data key="d4">28.0</data>
      <data key="d5">0.0</data><data key="d6">0.005</data></edge>
    <edge source="west" target="west"><data key="d4">24.0</data>
      <data key="d5">2.0</data><data key="d6">0.0</data></edge>
  </graph></graphml>]]></topology>
  <plugin id="tgen" path="tgen"/>
  <host id="fileserver" typehint="server" cpufrequency="1500000">
    <process plugin="tgen" starttime="1" arguments="tgen.server.graphml.xml"/>
  </host>
  <host id="web" quantity="5" typehint="client">
    <process plugin="tgen" starttime="2" arguments="tgen.client.graphml.xml"/>
  </host>
</shadow>
"""

# The interface-buffer config (write_iface_config): examples/tgen-100host
# with IFACE_WEB client hosts, each with an interfacebuffer of
# IFACE_BYTES (2 packets).  Its width is cut: the JAX package refuses
# buffered worlds with H * k^2 > 2^28 (its [H, k, k] ranking cube), and
# its reference builds that cube at every micro-step on the CPU: with 63
# web hosts (64 * 2048^2 = 2^28 elements, the largest the JAX package
# takes) the JAX CLI did not reach 120 s in 16 minutes on a CPU, with 31
# it took 6.
IFACE_WEB = 31
IFACE_BYTES = 3000
# Where the interface-buffer config's kernels are checked: the windows of
# the launch from IFACE_PROBE_S (the clients' first downloads), the one
# with the most tail drops among those of at most PROBE_MAX_STEPS
# micro-steps (window_plain, timed under the profiler, takes ~1 s a
# micro-step there).
IFACE_PROBE_S = 5
PROBE_MAX_STEPS = 16

# CUBIC's probes and paths: LOSSY with --tcp-congestion-control cubic to
# LOSSY_CUBIC_NS on both paths (held to JAX_LOSSY_CUBIC), its kernels
# checked at the window boundary LOSSY_CUBIC_PROBE_NS; the CUBIC
# tgen-100host config through the CLI (JAX_CLI["tgen-100host-cubic"]),
# its two paths compared at every heartbeat second from BURST_FROM_S to
# BURST_TO_S (the clients' opening bursts).
LOSSY_CUBIC_NS = 800 * MS
LOSSY_CUBIC_PROBE_NS = 300 * MS
BURST_FROM_S = 5
BURST_TO_S = 20
# Interface buffers on the STRESS and KO worlds (buffered): hosts i with
# i % 3 == 0 unbounded, the others bounded at 1 + i % 4 packets; STRESS
# to STRESS_NS on both paths (held to JAX_STRESS_BUF), its kernels and
# KO's K_DELIVER checked over the window with the most tail drops among
# the BUF_WINDOWS windows from BUF_PROBE_NS.
BUF_PROBE_NS = 60 * MS
BUF_WINDOWS = 10
# LOSSY with interface buffers (lossy_buffered), under Reno and under
# CUBIC, on both paths to LOSSY_BUF_NS (held to JAX_LOSSY_BUF and
# JAX_LOSSY_CUBIC_BUF); their TCP kernels checked over a window among the
# BUF_WINDOWS from there.
LOSSY_BUF_NS = 300 * MS
# The seeded socket registers CUBIC's device target and hooks are held to
# cong.py on (cubic_registers; tests/test_torch_cubic.py holds cong.py to
# the JAX package on the same ones).
CUBIC_REGS = 1 << 20
# A random GraphML of APSP_V vertices (random_graphml): above the
# assembler's 1,024-vertex limit for APSP on the CPU, so on the card.
APSP_V = 1100

# The jitter kernels' probes (phase 14): worlds of sim.build_phold /
# build_bulk with a jitter amplitude of up to JITTER_MAX_NS on 3 of 4
# vertex pairs (jittered_world), checked at these times; JITTER_CONFIG
# at JITTER_TCP_PROBE_NS.
JITTER_MAX_NS = 4 * MS
JITTER_PROBE_NS = 60 * MS
JITTER_BULK_PROBE_NS = 300 * MS
JITTER_TCP_PROBE_NS = 2200 * MS

# The JAX CLI's artifacts of those runs on the CPU: heartbeat.csv's
# sha256 and summary.json without wall_seconds (the printed summary line
# is the same without object_census).  Made with
#   python3 -c 'import chip_smoke; chip_smoke.write_jitter_config("J")'
#   python3 -c 'import chip_smoke; chip_smoke.write_iface_config("I")'
#   env JAX_PLATFORMS=cpu python -m shadow1_tpu run CONFIG \
#       --data-directory OUT [--tcp-congestion-control cubic]
#   sha256sum OUT/heartbeat.csv; cat OUT/summary.json
# for CONFIG = CLI_2HOST, CLI_100HOST (also with CUBIC:
# "tgen-100host-cubic"), J/shadow.config.xml and I/shadow.config.xml
# ("iface"; with CUBIC "iface-cubic"); tests/test_torch_cli.py -m slow
# asserts the first three,
# tests/test_torch_cubic.py and tests/test_torch_ifacebuf.py -m slow the
# last two.
JAX_CLI = {
    "tgen-2host": dict(
        rc=0, heartbeat_sha256="4c203ad2906807f7df14d55ed46cd995"
        "d89fc48d30cb8c6458722a8aaf77ac3a",
        summary={"simulated_seconds": 60.0, "hosts": 2,
                 "streams_completed": 3, "streams_failed": 0,
                 "packets_sent": 850, "packets_received": 850,
                 "bytes_sent": 768000, "drops_inet": 5, "drops_router": 0,
                 "drops_pool": 0, "acks_thinned": 0, "err_flags": 0,
                 "object_census": {
                     "packets_free": 512, "packets_tx_queued": 0,
                     "packets_in_flight": 0, "packets_rx_queued": 0,
                     "sockets_free": 11, "sockets_udp": 0,
                     "sockets_tcp": 1}}),
    "tgen-100host": dict(
        rc=0, heartbeat_sha256="d70840453c51582886b99ffd9306703a"
        "92f9a2689f85ee7fe430a22767cf81f7",
        summary={"simulated_seconds": 120.0, "hosts": 100,
                 "streams_completed": 198, "streams_failed": 0,
                 "packets_sent": 14711, "packets_received": 14711,
                 "bytes_sent": 13381632, "drops_inet": 20,
                 "drops_router": 0, "drops_pool": 0, "acks_thinned": 0,
                 "err_flags": 0,
                 "object_census": {
                     "packets_free": 640000, "packets_tx_queued": 0,
                     "packets_in_flight": 0, "packets_rx_queued": 0,
                     "sockets_free": 20199, "sockets_udp": 0,
                     "sockets_tcp": 1}}),
    "jitter": dict(
        rc=0, heartbeat_sha256="f0ee85122f8622576d0804bc92c62b08"
        "a2498a639ada94513dc39c4caa250484",
        summary={"simulated_seconds": 5.0, "hosts": 6,
                 "streams_completed": 5, "streams_failed": 0,
                 "packets_sent": 505, "packets_received": 505,
                 "bytes_sent": 390480, "drops_inet": 17, "drops_router": 0,
                 "drops_pool": 0, "acks_thinned": 0, "err_flags": 0,
                 "object_census": {
                     "packets_free": 2304, "packets_tx_queued": 0,
                     "packets_in_flight": 0, "packets_rx_queued": 0,
                     "sockets_free": 78, "sockets_udp": 0,
                     "sockets_tcp": 6}}),
    "tgen-100host-cubic": dict(
        rc=0, heartbeat_sha256="068e1efb31577e57dd941161a079b4fa"
        "4cf989f5cfb2714e85ed6f4621bdeee3",
        summary={"simulated_seconds": 120.0, "hosts": 100,
                 "streams_completed": 198, "streams_failed": 0,
                 "packets_sent": 14710, "packets_received": 14710,
                 "bytes_sent": 13381632, "drops_inet": 20,
                 "drops_router": 0, "drops_pool": 0, "acks_thinned": 0,
                 "err_flags": 0,
                 "object_census": {
                     "packets_free": 640000, "packets_tx_queued": 0,
                     "packets_in_flight": 0, "packets_rx_queued": 0,
                     "sockets_free": 20199, "sockets_udp": 0,
                     "sockets_tcp": 1}}),
    "iface": dict(
        rc=0, heartbeat_sha256="d0f83ec3b4e4fadbcf40e65e8df87371"
        "4e8a779814a065e9c0bf6c992c4c4ee0",
        summary={"simulated_seconds": 120.0, "hosts": 32,
                 "streams_completed": 62, "streams_failed": 0,
                 "packets_sent": 6225, "packets_received": 5131,
                 "bytes_sent": 5772176, "drops_inet": 12,
                 "drops_router": 1094, "drops_pool": 0, "acks_thinned": 0,
                 "err_flags": 0,
                 "object_census": {
                     "packets_free": 65536, "packets_tx_queued": 0,
                     "packets_in_flight": 0, "packets_rx_queued": 0,
                     "sockets_free": 2111, "sockets_udp": 0,
                     "sockets_tcp": 1}}),
    "iface-cubic": dict(
        rc=0, heartbeat_sha256="7709226c208bcdb7622331674d301e6f"
        "6d2a227f8afa2731e2f9d54d2d3e0877",
        summary={"simulated_seconds": 120.0, "hosts": 32,
                 "streams_completed": 62, "streams_failed": 0,
                 "packets_sent": 6783, "packets_received": 5404,
                 "bytes_sent": 6210028, "drops_inet": 15,
                 "drops_router": 1379, "drops_pool": 0, "acks_thinned": 0,
                 "err_flags": 0,
                 "object_census": {
                     "packets_free": 65536, "packets_tx_queued": 0,
                     "packets_in_flight": 0, "packets_rx_queued": 0,
                     "sockets_free": 2111, "sockets_udp": 0,
                     "sockets_tcp": 1}}),
}

REPLACES = {
    "exchange": "shadow1_tpu/core/megakernel.py:231",
    "deliver": "shadow1_tpu/core/megakernel.py:516",
    "transport": "shadow1_tpu/core/megakernel.py:576",
    "window": "shadow1_tpu/core/megakernel.py:391",
}
PER_PHASE = ("exchange", "deliver", "transport")
# K_DELIVER's CUDA kernel by the path megakernel.deliver_path names.
DELIVER_KERNELS = {"small": "k_deliver_small", "general": "k_deliver",
                   "tcp": "k_deliver_tcp"}
TCP_ROWS = {"exchange_tcp": "exchange", "deliver_tcp": "deliver",
            "transport_tcp": "transport", "window_tcp": "window",
            "window_tgen": "window", "window_tgen_cli": "window",
            "window_tgen_res": "window", "window_tgen_res_cli": "window"}
# The CUBIC and interface-buffer instantiations (phases 18-21), one row
# each, by the template arguments <Buf, Cong>: each row also carries
# `other_ms`, the device time on the same inputs of the Reno instantiation
# (CUBIC without buffers) or of the unbuffered one (buffered rows).
NEW_ROWS = {"deliver_tcp_cubic": "deliver",         # k_deliver_tcp<0,1>
            "window_tcp_cubic": "window",           # k_window_tcp<0,1>
            "window_tgen_cubic": "window",          # k_window_tgen<0,1>
            "deliver_small_buf": "deliver",         # k_deliver_small<1>
            "window_buf": "window",                 # k_window<1>
            "deliver_buf": "deliver",               # k_deliver<1>
            "window_tcp_buf": "window",             # k_window_tcp<1,0>
            "deliver_tcp_cubic_buf": "deliver",     # k_deliver_tcp<1,1>
            "window_tcp_cubic_buf": "window",       # k_window_tcp<1,1>
            "deliver_tcp_buf": "deliver",           # k_deliver_tcp<1,0>
            "window_tgen_buf": "window",            # k_window_tgen<1,0>
            "window_tgen_cubic_buf": "window",      # k_window_tgen<1,1>
            "window_tgen_res_cubic": "window",      # k_window_tgen_res<0,1>
            "window_tgen_res_buf": "window",        # k_window_tgen_res<1,0>
            "window_tgen_res_cubic_buf": "window"}  # k_window_tgen_res<1,1>
# K_WINDOW's two designs for tgen worlds (megakernel.
# set_window_tgen_resident): (resident, the CUDA kernel, what a row name
# gains).  The warp design keeps the rows it had (window_tgen*); the
# resident kernel's rows put "_res" after "window_tgen".
TGEN_DESIGNS = ((False, "k_window_tgen", ""),
                (True, "k_window_tgen_res", "_res"))
# Windows of the persistent TCP main path timed again with CUDA events,
# traced by phase and bounded.
BUSY_WINDOWS = 8
# Windows of the TCP main path replayed through the per-phase kernels to
# time and bound K_TRANSPORT there (transport_main_path).
TR_WINDOWS = 4
# The GPU spin (ms) before each K_TRANSPORT launch timed in
# transport_main_path: longer than the wrapper's host time (~0.3 ms).
SPIN_MS = 2
# Calls a plain version is timed over (time_call): profiling one call of
# a plain TCP window's tens of thousands of small torch ops takes
# seconds.
PLAIN_REPS = 2

# The "pairs" TCP world (pairs_world): 20,000 client -> server pairs, more
# hosts than one resident thread each would fit on the card, to 100 ms.
PAIRS_H = 40_000
PAIRS_NS = 100 * MS


_T0 = time.perf_counter()


def res_row(name: str) -> str:
    """The resident kernel's row beside the warp design's row `name`."""
    return name.replace("window_tgen", "window_tgen_res", 1)


class tgen_design:
    """Within the block, tgen worlds run on the resident kernel
    (resident=True) or on the warp design (False); by shape after it."""

    def __init__(self, resident: bool):
        self.resident = resident

    def __enter__(self):
        from shadow1_tpu_torch.core import megakernel as mk
        mk.set_window_tgen_resident(self.resident)
        return self

    def __exit__(self, *exc):
        from shadow1_tpu_torch.core import megakernel as mk
        mk.set_window_tgen_resident(None)
        return False


class RunCalls:
    """Within the block, counts the run_until calls (engine.run_until_impl,
    which run_until, run_chunked and the CLI's loop all reach) that ran at
    least one window: the persistent path launches K_WINDOW once for each.
    Each call's n_windows before and after are copied on the card and read
    after the run (`n`), so the count adds no host read to it."""

    def __enter__(self):
        from shadow1_tpu_torch.core import engine
        self._engine, self._impl, self._pairs = engine, \
            engine.run_until_impl, []

        def counted(state, params, app, t_target):
            before = state.n_windows.clone()
            out = self._impl(state, params, app, t_target)
            self._pairs.append((before, out.n_windows.clone()))
            return out
        engine.run_until_impl = counted
        return self

    def __exit__(self, *exc):
        self._engine.run_until_impl = self._impl
        return False

    @property
    def n(self) -> int:
        return sum(int(b) > int(a) for a, b in self._pairs)


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def _phase_done(name: str) -> None:
    print(f"phase {name}: done at {time.perf_counter() - _T0:.1f} s",
          flush=True)


def summary(state) -> dict:
    return dict(n_steps=int(state.n_steps), n_windows=int(state.n_windows),
                n_events=int(state.n_events),
                sent=int(state.app.sent.sum()), recv=int(state.app.recv.sum()),
                err=int(state.err))


def tcp_summary(state) -> dict:
    """The bulk world's trajectory: steps, windows, events, bytes
    received, completed clients and the sum of their finish times, err."""
    import numpy as np

    def host(x):
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x)

    done = host(state.app.phase) == 2
    fin = host(state.app.finish_t)
    return dict(n_steps=int(state.n_steps), n_windows=int(state.n_windows),
                n_events=int(state.n_events),
                bytes_recv=int(state.socks.bytes_recv.sum()),
                done=int(done.sum()), finish_sum=int(fin[done].sum()),
                err=int(state.err))


def tgen_summary(state) -> dict:
    """A tgen world's trajectory: steps, windows, events, streams done and
    failed, hosts finished, err."""
    import numpy as np

    def total(x):
        return int(np.asarray(x.cpu() if hasattr(x, "cpu") else x).sum())

    a = state.app
    return dict(n_steps=int(state.n_steps), n_windows=int(state.n_windows),
                n_events=int(state.n_events), done=total(a.streams_done),
                failed=total(a.streams_failed), finished=total(a.finished),
                err=int(state.err))


def loopback_start_times(h: int):
    """The loopback world's start times: host 0 at 1 s, the others at 5 s
    (sim.build_tgen's server and client times)."""
    import numpy as np
    t = np.full(h, 5 * SEC, np.int64)
    t[0] = SEC
    return t


def loopback_world(persistent: bool = True, device=None, **kw):
    """sim.build_tgen(LOOP_HOSTS) with every host on the client graph:
    host 0 keeps its listener and streams to itself (its peer is the
    server, host 0), so its segments loop back."""
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.apps import tgen
    state, params, app = sim.build_tgen(LOOP_HOSTS, persistent=persistent,
                                        device=device, **kw)
    srv = tgen.parse_tgen(sim._TGEN_SERVER_XML.format(port=sim.TGEN_PORT))
    cli = tgen.parse_tgen(sim._TGEN_CLIENT_XML.format(
        port=sim.TGEN_PORT, sendsize=50 * 1024, recvsize=200 * 1024,
        streams=3))
    app_state = tgen.build_state(
        LOOP_HOSTS, [srv, cli], [1] * LOOP_HOSTS,
        loopback_start_times(LOOP_HOSTS),
        resolve_peer=lambda s: (0, sim.TGEN_PORT), device=state.device)
    return state.replace(app=app_state), params, app


def write_jitter_config(directory) -> str:
    """Write JITTER_CONFIG and the tgen-100host graphs it names into
    `directory`; returns the config's path."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).resolve().parent / "examples" / "tgen-100host"
    for name in ("tgen.server.graphml.xml", "tgen.client.graphml.xml"):
        (d / name).write_text((src / name).read_text())
    (d / "shadow.config.xml").write_text(JITTER_CONFIG)
    return str(d / "shadow.config.xml")


def write_iface_config(directory, web: int = IFACE_WEB,
                       iface_bytes: int | None = IFACE_BYTES) -> str:
    """Write examples/tgen-100host with `web` client hosts, each with an
    `<host interfacebuffer>` of `iface_bytes` (None: no attribute), and
    the graphs it names into `directory`; returns the config's path."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).resolve().parent / "examples" / "tgen-100host"
    for name in ("tgen.server.graphml.xml", "tgen.client.graphml.xml"):
        (d / name).write_text((src / name).read_text())
    old = '<host id="web" quantity="99" typehint="client">'
    xml = (src / "shadow.config.xml").read_text()
    if old not in xml:
        _fail("examples/tgen-100host no longer has its 99 web hosts")
    attr = "" if iface_bytes is None else f' interfacebuffer="{iface_bytes}"'
    xml = xml.replace(old, f'<host id="web" quantity="{web}" '
                           f'typehint="client"{attr}>')
    (d / "shadow.config.xml").write_text(xml)
    return str(d / "shadow.config.xml")


def kernel_name(symbol: str) -> str:
    """The k_* kernel name inside a mangled or demangled symbol, with a
    template instantiation's arguments as integers (k_window_tcp<1,0>);
    else the symbol."""
    m = re.search(r"k_[a-z0-9_]+", symbol)
    if not m:
        return symbol
    rest = symbol[m.end():]
    targs = re.match(r"I((?:L[a-z]+\d+E)+)E", rest)      # mangled
    if targs:
        vals = re.findall(r"L[a-z]+(\d+)E", targs.group(1))
    else:
        targs = re.match(r"<([^>]*)>", rest)             # demangled
        vals = [{"false": "0", "true": "1"}.get(v.strip(), v.strip())
                for v in targs.group(1).split(",")] if targs else []
    return m.group(0) + (f"<{','.join(vals)}>" if vals else "")


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


def sock_row_bytes(socks) -> int:
    """Bytes of one socket's TCP fields (the registers a gather reads)."""
    from shadow1_tpu_torch.transport.tcp import _Sock
    return sum(getattr(socks, f)[0, 0].numel()
               * getattr(socks, f).element_size()
               for f in _Sock.FIELDS + _Sock.RANGE_FIELDS)


def deliver_bytes(st, out, delivered_n, active, app, em=None) -> int:
    """Bytes K_DELIVER must move on this input: the slab stages of the
    active hosts, the times of their live slots, the rows it consumes,
    the socket rows of the hosts that receive, and the active hosts' rx
    state; then the changed elements, the ring entries it pushes and the
    two [H] outputs.  In TCP worlds (`em` given) each delivery also reads
    the five match columns of its host's sockets and the matched socket,
    and each reply writes its emission row."""
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
    if em is not None:
        read += n_recv * (s * 5 * 4 + sock_row_bytes(st.socks))
        written += int(em.valid.sum()) * em.blk.shape[-1] * 4 \
            + em.valid.numel()
    return read + written


def transport_bytes(s2, out, em, active, params, tcp=False) -> int:
    """Bytes K_TRANSPORT must move on this input: the emission valid
    flags, the valid rows' dst (and the placed rows' other columns), the
    route_blk entries they gather, the active hosts' outbox stages, their
    parked rows and tx state, and every host's inbox slab for the scan;
    then the placed and drained pool rows, the changed host elements and
    th.  In TCP worlds transmit also reads the nine eligibility columns of
    each active host's sockets and the sending socket, and the scan every
    socket's four timers."""
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
    if tcp:
        socks = s2.socks
        s = socks.slots
        elig = 4 + 8 * 3 + 4 + 4 + 8 * 2 + 1
        senders = int(((out.socks.snd_nxt != socks.snd_nxt)
                       | (out.socks.retrans_nxt != socks.retrans_nxt))
                      .any(dim=1).sum())
        read += n_act * s * elig + h * s * 4 * 8 \
            + senders * sock_row_bytes(socks)
    return read + written


def exchange_bound(state) -> tuple[int, int]:
    """(bytes, operations) the exchange must move and do on this state:
    the stage of every pool row and inbox slot, the dst, row and time of
    each mover, the placed rows and the three per-destination tallies."""
    import torch
    from shadow1_tpu_torch.core.state import STAGE_FREE, STAGE_IN_FLIGHT
    h = state.hosts.num_hosts
    ic = state.inbox.blk.shape[1]
    ki = state.inbox.capacity // h
    moving = state.pool.stage == STAGE_IN_FLIGHT
    n_mov = int(moving.sum())
    total = torch.bincount(state.pool.dst[moving].clamp(0, h - 1).long(),
                           minlength=h)
    n_free = (state.inbox.stage == STAGE_FREE).view(h, ki).sum(dim=1)
    n_placed = int(torch.minimum(total, n_free).sum())
    return (state.pool.stage.numel() * 4 + state.inbox.stage.numel() * 4
            + n_mov * (4 + ic * 4 + 8 + 4) + n_placed * (ic * 4 + 4)
            + 3 * h * 4,
            state.pool.stage.numel() * 2 + n_mov * (ic + 12) + h * ki * 2)


def deliver_ops(st, delivered_n, active, app, tcp=False) -> int:
    """Operations of K_DELIVER: per active host the slab scans of the
    enqueue and of each delivery round plus the NIC/CoDel arithmetic; per
    delivery the socket lookup (and in TCP worlds ~600 operations of the
    TCP machine, ~400 more when a scoreboard insert sorts 11 entries)."""
    ki = st.inbox.capacity // st.hosts.num_hosts
    per_rx = st.socks.slots * 8 + (1000 if tcp else 0)
    return (int(active.sum()) * (ki * 6 + app.rx_batch * ki * 12 + 60)
            + int(delivered_n.sum()) * per_rx)


def transport_ops(s2, em, active, tcp=False) -> int:
    """Operations of K_TRANSPORT: per valid emission the staging
    arithmetic, per active host its outbox slab scans, per host the
    post-step scan; in TCP worlds per active host two eligibility scans
    of its sockets (~30 operations a socket) and per host the timer scan."""
    h = s2.hosts.num_hosts
    ki = s2.inbox.capacity // h
    ops = (int(em.valid.sum()) * 60
           + int(active.sum()) * (s2.pool.capacity // h) * 8
           + h * (ki * 6 + 40))
    if tcp:
        s = s2.socks.slots
        ops += int(active.sum()) * s * 60 + h * s * 4
    return ops


def tick_bound(st, out, em, active) -> tuple[int, int]:
    """(bytes, operations) of phold's tick for the active hosts: their
    app state, draw counter, socket ring head and count, slab stages and
    live slot times (the send bound) read; the changed elements and the
    staged rows written.  Operations: ~80 per keyed f64 delay or dst draw
    (the hash and the log1p), ~40 per active host plus its slab scan."""
    from shadow1_tpu_torch.core.state import STAGE_FREE
    h = st.hosts.num_hosts
    ki = st.inbox.capacity // h
    pc = em.blk.shape[-1]
    n_act = int(active.sum())
    live = (st.inbox.stage != STAGE_FREE).view(h, ki) & active[:, None]
    n_valid = int(em.valid.sum())
    read = n_act * (4 + 8 + 8 + 8 + 8 + 8) + n_act * ki * 4 \
        + int(live.sum()) * 8
    written = changed_bytes(st, out) + em.valid.numel() + n_valid * pc * 4
    draws = int((out.app.recv - st.app.recv).sum()) + 2 * n_valid
    return read + written, draws * 80 + n_act * (ki * 4 + 40)


def tcp_tick_bound(st, out, em, active) -> tuple[int, int]:
    """(bytes, operations) of run_timers plus bulk's tick: every active
    host's four timers per socket and the fired socket's row; every host's
    socket type, state and receive pointers (the sink consumes and closes
    on the whole table); the running clients' socket rows and every active
    host's app state read; the changed elements and the timer lane's rows
    written.  Operations: ~8 per timer compared, ~6 per socket of the sink,
    ~200 per fired timer or client step."""
    from shadow1_tpu_torch.core import emit
    h = st.hosts.num_hosts
    s = st.socks.slots
    n_act = int(active.sum())
    fired = int((out.socks.t_rto != st.socks.t_rto).any(dim=1).sum()
                + (out.socks.t_delack != st.socks.t_delack).any(dim=1).sum()
                + (out.socks.t_tw != st.socks.t_tw).any(dim=1).sum()
                + (out.socks.t_persist != st.socks.t_persist).any(dim=1)
                .sum())
    running = int((active & st.app.is_client
                   & ((st.app.phase == 1) | (out.app.phase != st.app.phase)))
                  .sum())
    row = sock_row_bytes(st.socks)
    n_timer = int(em.valid[:, emit.SLOT_TIMER].sum())
    read = (n_act * s * 4 * 8 + h * s * (4 + 4 + 8 + 8)
            + (fired + running) * row + n_act * (1 + 4 + 4 + 8 * 3))
    written = changed_bytes(st, out) + n_timer * (em.blk.shape[-1] * 4 + 1)
    return read + written, (n_act * s * 4 * 8 + h * s * 6
                            + (fired + running) * 200)


def tgen_tick_bound(st, out, em, active) -> tuple[int, int]:
    """(bytes, operations) of run_timers plus tgen's tick: the timers as
    in tcp_tick_bound; every active host's registers and the table
    entries at its cursor read, and the client socket of each host that
    streams; the server pass and the sink read every socket's type,
    parent, state, peer, closed flag and receive pointer, and each child
    that may reply its byte counts, send pointers and buffer and its
    peer's two stream registers; the changed elements and the timer
    lane's rows written.  Operations: ~8 per timer compared, ~10 per
    socket of the server pass and the sink, ~200 per fired timer or
    stream step."""
    from shadow1_tpu_torch.core import emit
    from shadow1_tpu_torch.core.state import (SOCK_TCP, TCPS_CLOSEWAIT,
                                              TCPS_ESTABLISHED)
    h = st.hosts.num_hosts
    s = st.socks.slots
    n_act = int(active.sum())
    fired = int((out.socks.t_rto != st.socks.t_rto).any(dim=1).sum()
                + (out.socks.t_delack != st.socks.t_delack).any(dim=1).sum()
                + (out.socks.t_tw != st.socks.t_tw).any(dim=1).sum()
                + (out.socks.t_persist != st.socks.t_persist).any(dim=1)
                .sum())
    a0, a1 = st.app, out.app
    streaming = int((active & (a0.stream_active
                               | (a1.conn_ctr != a0.conn_ctr))).sum())
    so = out.socks
    child = ((so.stype == SOCK_TCP) & (so.parent >= 0)
             & ((so.tcp_state == TCPS_ESTABLISHED)
                | (so.tcp_state == TCPS_CLOSEWAIT))
             & (so.peer_host >= 0) & ~so.app_closed)
    n_child = int(child.sum())
    row = sock_row_bytes(st.socks)
    n_timer = int(em.valid[:, emit.SLOT_TIMER].sum())
    regs = 4 + 8 * 2 + 1 + 1 + 8 * 3 + 1 + 8 * 3   # registers a host reads
    tables = 4 + 4 + 8 * 3 + 4 + 4 * 3             # at its cursor
    read = (n_act * s * 4 * 8 + (fired + streaming) * row
            + n_act * (regs + tables)
            + h * s * (4 + 4 + 4 + 4 + 1 + 8)
            + n_child * (8 + 8 + 8 + 4 + 16))
    written = changed_bytes(st, out) + n_timer * (em.blk.shape[-1] * 4 + 1)
    return read + written, (n_act * s * 4 * 8 + h * s * 10
                            + (fired + streaming) * 200)


def window_bound(state, params, app, t_target, keep=False, kt=None,
                 shares=None):
    """(bytes, operations, micro-steps) of one K_WINDOW call on `state`:
    the sum of what its phases must move and do, counted from this
    window's data by replaying it phase by phase through the per-phase
    kernels -- the exchange, the scan, per micro-step the tick setup,
    K_DELIVER, (TCP) run_timers, the tick and K_TRANSPORT, and the
    closing outbox scan.  With `keep`, the state after the window comes
    fourth (now = we, one more window), to count the next one.  With `kt`
    (a dict), each K_TRANSPORT launch of the replay also adds its own
    bytes and operations to kt["b"] / kt["ops"] and its CUDA events --
    recorded behind a SPIN_MS GPU spin, so that they bracket only the
    launch's work on the card -- to kt["ev"] (kt["late"] counts launches
    whose host call outran the spin).  With `shares` (a dict), the
    exchange's and K_DELIVER's bytes and operations add to
    shares["exchange"] / shares["deliver"] ([bytes, operations])."""
    import torch
    from shadow1_tpu_torch.core import emit, engine
    from shadow1_tpu_torch.core import megakernel as mk
    from shadow1_tpu_torch.core.state import STAGE_IN_FLIGHT
    from shadow1_tpu_torch.transport import tcp as tcp_mod
    clone = engine.clone_state
    h = state.hosts.num_hosts
    ki = state.inbox.capacity // h
    tcp = engine._uses_tcp(app)
    bw_up, bw_dn = engine._window_ctx(state, params)
    b, ops = exchange_bound(state)
    if shares is not None:
        shares["exchange"][0] += b
        shares["exchange"][1] += ops
    st = engine._exchange(clone(state), params, fused=True)
    n_if = int((st.inbox.stage == STAGE_IN_FLIGHT).sum())
    # Scan: slab stages, in-flight times, resume, app and CPU state; t_h.
    b += h * (ki * 4 + 8 + 12 + 16) + n_if * 8 + h * 8
    ops += h * (ki * 6 + 40)
    t_h, gmin = engine._scan_all(st, params, app)
    we = min(max(int(st.now), int(gmin)) + params.min_latency_ns,
             int(t_target))
    steps = 0
    while int(gmin) < we:
        steps += 1
        st, active, tick_t = engine._tick_setup(st, t_h, we)
        b += h * 8 + int(active.sum()) * 8          # t_h read, re-arm
        aux0 = engine._aux_times(st, params, app)
        s_in = clone(st)
        em = emit.empty(h, engine._n_lanes(app), st.pool.blk.shape[1],
                        st.device)
        st, em, dn, tp = mk.deliver_kernel(st, params, app, em, tick_t,
                                           active, we, bw_dn, aux0)
        db = deliver_bytes(s_in, st, dn, active, app, em if tcp else None)
        do = deliver_ops(s_in, dn, active, app, tcp)
        b, ops = b + db, ops + do
        if shares is not None:
            shares["deliver"][0] += db
            shares["deliver"][1] += do
        s_in = clone(st)
        if tcp:
            st, em = tcp_mod.run_timers(st, params, em, tp, active)
        st, em = engine._app_tick(st, params, app, em, tp, active, we)
        bound = tick_bound if not tcp else tgen_tick_bound \
            if hasattr(st.app, "conn_ctr") else tcp_tick_bound
        tb, to = bound(s_in, st, em, active)
        b, ops = b + tb, ops + to
        t_app = app.next_time(st)
        s_in = clone(st)
        if kt is not None:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(kt["spin"])
            h0 = time.perf_counter()
            e0.record()
        st, t_h, gmin = mk.transport_kernel(st, params, app, em, tick_t, tp,
                                            active, bw_up, dn, t_app)
        if kt is not None:
            e1.record()
            kt["ev"].append((e0, e1))
            kt["late"] += time.perf_counter() - h0 > SPIN_MS / 1e3
        tb = transport_bytes(s_in, st, em, active, params, tcp)
        to = transport_ops(s_in, em, active, tcp)
        b, ops = b + tb, ops + to
        if kt is not None:
            kt["b"] += tb
            kt["ops"] += to
    # Window close: the pool's stage column and its in-flight times.
    n_out = int((st.pool.stage == STAGE_IN_FLIGHT).sum())
    b += st.pool.stage.numel() * 4 + n_out * 8 + 5 * 8
    ops += st.pool.stage.numel() * 2
    if keep:
        st = st.replace(now=st.now.new_tensor(we),
                        n_windows=st.n_windows + 1)
        return b, ops, steps, st
    return b, ops, steps


def windows_bound(warm, params, app, n: int, kt=None,
                  shares=None, until=None) -> tuple:
    """(bytes, operations, micro-steps) of the windows of one run from
    `warm` to t_end = now + n x min latency (or `until`) on the
    persistent path (the schedule of busy_windows and of check_window's
    span; at most n windows): the sum of window_bound over them, while the
    window loop's predicate holds.  `kt` collects K_TRANSPORT's share,
    `shares` the exchange's and K_DELIVER's (window_bound)."""
    from shadow1_tpu_torch.core import engine
    st = engine.clone_state(warm)
    t_end = until or int(st.now) + n * params.min_latency_ns
    b = ops = steps = 0
    while int(st.now) < t_end and min(
            int(engine._scan_all(st, params, app)[1]),
            int(engine._outbox_pending(st))) < t_end:
        wb, wo, ws, st = window_bound(st, params, app, t_end, keep=True,
                                      kt=kt, shares=shares)
        b, ops, steps = b + wb, ops + wo, steps + ws
    return b, ops, steps


def transport_main_path(warm, params, app, n: int) -> tuple:
    """K_TRANSPORT on its own (per-phase) path over the first `n` windows
    after `warm`, replayed by windows_bound: the launches, their mean
    device ms (CUDA events behind a spin) and their mean bound (ms).
    Returns (printable line, (bytes, operations) of the replayed windows,
    micro-steps)."""
    import torch
    kt = {"b": 0, "ops": 0, "ev": [], "late": 0,
          "spin": int(SPIN_MS * _spin_cycles_per_ms())}
    b, ops, steps = windows_bound(warm, params, app, n, kt=kt)
    torch.cuda.synchronize()
    ms = [e0.elapsed_time(e1) for e0, e1 in kt["ev"]]
    k = len(ms)
    return (f"K_TRANSPORT (TCP) on its per-phase path, the first {n} "
            f"windows replayed: {k} launches, device "
            f"{statistics.mean(ms):.4f} ms a launch (CUDA events behind a "
            f"spin; min {min(ms):.4f}, median {statistics.median(ms):.4f}, "
            f"max {max(ms):.4f}); they must move {kt['b']} bytes and do "
            f"{kt['ops']} operations: bound "
            f"{bound_ms(kt['b'], kt['ops']) / k:.6f} ms a launch; "
            f"{kt['late']} host calls outran the spin"), \
        (b, ops), steps


def _on_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def _spin_cycles_per_ms() -> float:
    """GPU clock cycles per millisecond of torch.cuda._sleep, measured."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    torch.cuda._sleep(10_000_000)
    e1.record()
    torch.cuda.synchronize()
    return 10_000_000 / e0.elapsed_time(e1)


def device_ms_events(run, make_args, reps: int, host_ms: float,
                     redo: int = 3) -> float:
    """Device ms of one `run(*make_args())` from CUDA events: the stream
    first spins (torch.cuda._sleep) for 4x the call's host time plus
    10 ms, so the host has enqueued the whole call before the first event
    runs and the events bracket only the call's work on the card.  The
    host's clock is shared with other work, so a call may still stall
    past the spin now and then: such a sample would count host time and
    is taken again, at most `redo` x `reps` times in all (then fails).
    Python's collector is off while a call is timed.  Median of `reps`."""
    import gc
    import torch
    per_ms = _spin_cycles_per_ms()
    spin_ms = 4 * host_ms + 10
    out, late = [], 0
    while len(out) < reps:
        args = make_args()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        gc.disable()
        try:
            torch.cuda._sleep(int(per_ms * spin_ms))
            h0 = time.perf_counter()
            e0.record()
            run(*args)
            e1.record()
            host = (time.perf_counter() - h0) * 1e3
        finally:
            gc.enable()
        torch.cuda.synchronize()
        if host > spin_ms:
            late += 1
            if late > redo * reps:
                _fail(f"device_ms_events: {late} calls' host time (last "
                      f"{host:.3f} ms) outran the {spin_ms:.3f} ms spin")
            continue
        out.append(e0.elapsed_time(e1))
    if late:
        print(f"device_ms_events: {late} of {reps + late} calls outran the "
              f"{spin_ms:.3f} ms spin and were taken again", flush=True)
    return statistics.median(out)


def time_call(run, make_args, reps: int = 7, kernel: str | None = None,
              warm: bool = True) -> tuple[float, float]:
    """(device ms, call ms) of `run(*make_args())`, inputs made fresh
    (cloned) before each call and not timed.  Device ms: the durations
    of every kernel, copy and memset the call puts on the card, from
    torch.profiler, mean over `reps` calls.  Call ms: CUDA events around
    one call on an idle card, so the host's enqueue time counts (median
    of `reps`).  A warm-up call comes first (unless `warm` is false: the
    caller has just made one).  `kernel` names the CUDA
    kernel each call launches: when the profile holds fewer than `reps`
    of its launches (the tracer drops records of some long kernels, and
    on some machines every launch from the port's libraries), the device
    ms comes from CUDA events instead (device_ms_events).
    Without `kernel` (a plain version) at most PLAIN_REPS calls are
    timed."""
    import torch
    if kernel is None:
        reps = min(reps, PLAIN_REPS)
    if warm:
        run(*make_args())
    calls, hosts = [], []
    for _ in range(reps):
        args = make_args()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        t0.record()
        run(*args)
        t1.record()
        hosts.append((time.perf_counter() - h0) * 1e3)
        torch.cuda.synchronize()
        calls.append(t0.elapsed_time(t1))
    inputs = [make_args() for _ in range(reps)]
    torch.cuda.synchronize()
    # Device activity only: the CPU ops' records cost seconds a plain
    # call and change no device duration.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for args in inputs:
            run(*args)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if _on_device(e)]
    seen = sum(kernel_name(e.name) == kernel or
               kernel_name(e.name).split("<")[0] == kernel
               for e in dev) if kernel else reps
    if seen >= reps:
        dev_ms = sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3
    else:
        dev_ms = device_ms_events(run, make_args, reps, max(hosts))
        names = sorted({kernel_name(e.name) for e in dev})[:4]
        print(f"time_call: the profile held {seen} of {reps} {kernel} "
              f"launches ({len(dev)} device events: {names}); device time "
              f"{dev_ms:.4f} ms from CUDA events", flush=True)
    return dev_ms, statistics.median(calls)


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
    ki = state.inbox.capacity // h
    bounds["exchange"] = exchange_bound(state)
    times["exchange"] = (time_call(mk.exchange_kernel, ex_args,
                                   kernel="k_exchange"),
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

    lanes = engine._n_lanes(app)

    def dl_args(s=st):
        return (clone(s), params, app,
                emit.empty(h, lanes, s.pool.blk.shape[1], dev), tick_t,
                active, we, ctx[1], aux0)
    path = mk.deliver_path(st, params, app)
    if path != "small":
        _fail(f"the bench world's K_DELIVER takes the {path} path, not "
              f"deliver_small")
    out_k = mk.deliver_kernel(*dl_args())
    out_p = mk.deliver_plain(*dl_args())
    errs["deliver"] = require_equal(out_k, out_p, "deliver")
    s2, em, delivered_n, t_post = out_p
    bounds["deliver"] = (deliver_bytes(st, s2, delivered_n, active, app),
                         deliver_ops(st, delivered_n, active, app))
    times["deliver"] = (time_call(mk.deliver_kernel, dl_args,
                                  kernel=DELIVER_KERNELS[path]),
                        time_call(mk.deliver_plain, dl_args))
    print(f"kernels: deliver equal ({int(delivered_n.sum())} deliveries; "
          f"{path} path, {DELIVER_KERNELS[path]})", flush=True)

    s2, em = engine._app_tick(s2, params, app, em, t_post, active, we)
    t_app = app.next_time(s2)

    def tr_args(s=s2):
        return (clone(s), params, app, em, tick_t, t_post, active, ctx[0],
                delivered_n, t_app)
    out_k = mk.transport_kernel(*tr_args())
    out_p = mk.transport_plain(*tr_args())
    errs["transport"] = require_equal(out_k, out_p, "transport")
    bounds["transport"] = (
        transport_bytes(s2, out_p[0], em, active, params),
        transport_ops(s2, em, active))
    times["transport"] = (time_call(mk.transport_kernel, tr_args,
                                    kernel="k_transport"),
                          time_call(mk.transport_plain, tr_args))
    print(f"kernels: transport equal ({int(em.valid.sum())} emissions)",
          flush=True)
    for k, ((kd, kc), (pd, pc)) in times.items():
        print(f"kernels: {k} kernel device {kd:.4f} ms (call {kc:.4f} ms), "
              f"plain device {pd:.4f} ms (call {pc:.4f} ms), bound "
              f"{bounds[k][0]} bytes, {bounds[k][1]} operations", flush=True)
    return times, bounds, errs


def stressed(params):
    """Phase 3's parameters of the STRESS and KO worlds: the PDS trail and
    the virtual CPU on (50 us an event, a threshold of 0)."""
    import torch
    return params.replace(pds_trail=True, cpu_threshold_ns=0,
                          cpu_ns_per_event=torch.full_like(
                              params.cpu_ns_per_event, 50_000))


def check_ko(dev) -> list:
    """The general paths on the KO world (12-slot slabs, congested, lossy,
    PDS trail and CPU model on), torch.equal on every output: K_DELIVER
    (deliver_host, which slabs above deliver_small's eight take) and
    K_TRANSPORT against their plain versions at every micro-step of the
    window after KO_NS, where the compared steps must park, lose and
    overflow packets; then K_WINDOW, whose micro-step takes deliver_host
    too, against window_plain over that window.  Returns printable
    lines."""
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.core import emit, engine
    from shadow1_tpu_torch.core import megakernel as mk
    state, params, app = sim.build_phold(**KO, megakernel=True,
                                         persistent=False, device=dev)
    params = stressed(params)
    state = engine.run_until(state, params, app, KO_NS)
    path = mk.deliver_path(state, params, app)
    if path != "general":
        _fail(f"KO world: K_DELIVER takes the {path} path, not deliver_host")
    clone = engine.clone_state
    h = state.hosts.num_hosts
    ctx = engine._window_ctx(state, params)
    st = engine._exchange(clone(state), params, fused=True)
    t_h, gmin = engine._scan_all(st, params, app)
    we = min(max(int(st.now), int(gmin)) + params.min_latency_ns,
             params.stop_time)
    steps, took = 0, {"parked": 0, "lost": 0, "overflow": 0}
    rx = {"delivered": 0, "router drops": 0}
    while int(gmin) < we:
        s1, active, tick_t = engine._tick_setup(clone(st), t_h, we)
        aux0 = engine._aux_times(s1, params, app)

        def dl_args(s=s1):
            return (clone(s), params, app,
                    emit.empty(h, engine._n_lanes(app),
                               s.pool.blk.shape[1], dev),
                    tick_t, active, we, ctx[1], aux0)
        out_k = mk.deliver_kernel(*dl_args())
        s2, em, dn, tp = mk.deliver_plain(*dl_args())
        require_equal(out_k, (s2, em, dn, tp),
                      f"deliver (KO world, step {steps})")
        rx["delivered"] += int(dn.sum())
        rx["router drops"] += int((s2.hosts.pkts_dropped_router
                                   - s1.hosts.pkts_dropped_router).sum())
        s2, em = engine._app_tick(s2, params, app, em, tp, active, we)
        t_app = app.next_time(s2)

        def args(s=s2):
            return (clone(s), params, app, em, tick_t, tp, active, ctx[0],
                    dn, t_app)
        out_k = mk.transport_kernel(*args())
        out_p = mk.transport_plain(*args())
        require_equal(out_k, out_p, f"transport (KO world, step {steps})")
        hp, h0 = out_p[0].hosts, s2.hosts
        took["parked"] += int((hp.tx_queued - h0.tx_queued).clamp(min=0)
                              .sum())
        took["lost"] += int((hp.pkts_dropped_inet - h0.pkts_dropped_inet)
                            .sum())
        took["overflow"] += int((hp.pkts_dropped_pool - h0.pkts_dropped_pool)
                                .sum())
        st, t_h, gmin = mk.microstep_fused(st, params, app, t_h, we, ctx)
        steps += 1
    if min(took.values()) <= 0:
        _fail(f"KO world: the compared steps did not park, lose and "
              f"overflow packets: {took}")
    if rx["delivered"] <= 0:
        _fail(f"KO world: the compared steps delivered nothing: {rx}")
    pw = params.replace(persistent=True)
    win_k = mk.window_kernel(clone(state), pw, app, params.stop_time)
    win_p = mk.window_plain(clone(state), pw, app, params.stop_time)
    require_equal(win_k, win_p, "window (KO world)")
    world = (f"KO world, H={KO['num_hosts']}, "
             f"{KO['pool_capacity'] // KO['num_hosts']}-slot slabs")
    return [f"kernels: deliver ({world}; {path} path, "
            f"{DELIVER_KERNELS[path]}) equal at all {steps} micro-steps of "
            f"the window after {KO_NS // MS} ms; {rx}",
            f"kernels: transport ({world}) equal at all {steps} micro-steps "
            f"of that window; {took}",
            f"kernels: window ({world}; K_DELIVER's {path} path inside) "
            f"equal over that window "
            f"({int(win_p[0].n_steps) - int(state.n_steps)} micro-steps)"]


def check_window(state, params, app, advance=3, label="kernels: window",
                 kernel="k_window", plain_reps=7, span=None, until=None,
                 reuse=None):
    """K_WINDOW (`kernel`) against window_plain on clones of `state`
    advanced by `advance` windows, at a window boundary: one window
    (`span` None: max_windows 1, t_target `until`, else the world's stop
    time), or the
    windows of one call to t_target = now + span x min latency (the cap
    engine._run_windows hands down, which a right predicate never
    reaches).  Every leaf of the state and t_h / gmin / ws / we / outbox
    pending / status must be equal; the plain version is timed over
    `plain_reps` calls (not at all when 0).  `reuse`, another kernel's
    check_window result on the same inputs, gives the plain version's
    times and the bound (neither is taken again).  Returns ((kernel
    (device ms, call ms), plain (device ms, call ms)), (bytes,
    operations) bound, max |kernel - plain|)."""
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    params = params.replace(persistent=True)
    for _ in range(advance):
        state = engine.run_until(state, params, app,
                                 int(state.now) + params.min_latency_ns)
    if span is None:
        t_target, cap = until or params.stop_time, 1
    else:
        t_target, cap = int(state.now) + span * params.min_latency_ns, span

    def args(s=state):
        return engine.clone_state(s), params, app, t_target, cap
    out_k = mk.window_kernel(*args())
    out_p = mk.window_plain(*args())
    err = require_equal(out_k, out_p, label)
    steps = int(out_k[0].n_steps) - int(state.n_steps)
    if reuse is not None:
        b, ops = reuse[1]
    elif span is None:
        b, ops, steps = window_bound(state, params, app, t_target)
    else:
        b, ops, steps = windows_bound(state, params, app, span)
    windows = int(out_k[0].n_windows) - int(state.n_windows)
    if span is not None:
        if windows < 5 or int(out_k[2][4]) != 0 or \
                int(out_k[0].now) != t_target:
            _fail(f"{label}: {windows} windows to {int(out_k[0].now)} ns "
                  f"(status {int(out_k[2][4])}) for t_target {t_target}")
    times = (time_call(mk.window_kernel, args, kernel=kernel),
             reuse[0][1] if reuse is not None else
             time_call(mk.window_plain, args, reps=plain_reps, warm=False)
             if plain_reps else (float("nan"), float("nan")))
    (kd, kc), (pd, pc) = times
    print(f"{label} equal ({windows} window{'s' * (windows > 1)} in one "
          f"call, {steps} micro-steps, last window "
          f"{out_k[2][1].item()}..{out_k[2][2].item()} ns); kernel device "
          f"{kd:.4f} ms (call {kc:.4f} ms), plain device {pd:.4f} ms (call "
          f"{pc:.4f} ms), bound {b} bytes, {ops} operations "
          f"({bound_ms(b, ops):.6f} ms)", flush=True)
    return times, (b, ops), err


def profile_persistent(warm, params, app, t_end, launches: int):
    """The persistent main path's timed part again, under torch.profiler:
    K_WINDOW's device time per launch (`launches` of them, one per
    run_until call) and per window, the device's busy share of the wall
    time, and the wall per window.  Returns (printable line, K_WINDOW
    device ms per launch)."""
    import torch
    from shadow1_tpu_torch.core import engine
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        w0 = time.perf_counter()
        out = engine.run_chunked(warm, params, app, t_end)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    windows = int(out.n_windows) - int(warm.n_windows)
    dev = [e for e in prof.events() if _on_device(e)]
    kw = [e.time_range.elapsed_us() for e in dev if "k_window" in e.name]
    busy = sum(e.time_range.elapsed_us() for e in dev)
    if len(kw) != launches:
        _fail(f"profile: {len(kw)} K_WINDOW kernels for {launches} "
              f"run_until calls ({windows} windows)")
    k_ms = sum(kw) / len(kw) / 1e3
    return (f"profile (persistent): {windows} windows, wall "
            f"{wall_us / 1e3:.1f} ms under the profiler "
            f"({wall_us / windows / 1e3:.4f} ms per window); {len(kw)} "
            f"K_WINDOW launches, device {k_ms:.4f} ms per launch (min "
            f"{min(kw) / 1e3:.4f}, max {max(kw) / 1e3:.4f}), "
            f"{sum(kw) / windows / 1e3:.4f} ms per window; device busy "
            f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f} %), "
            f"{len(dev)} device kernels"), k_ms


def drive(state, params, app, label: str):
    """The bench schedule (warm-up with run_until, then run_chunked to
    RUN_NS) with every launch counter zeroed just before and read just
    after; the trajectory must equal the JAX package's.  Prints the
    timed part's events/s and wall.  Returns (final state, warm state,
    launches, wall seconds of the timed part)."""
    import torch
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
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
        _fail(f"{label}: warm-up trajectory {w} != JAX {JAX_WARM}")
    if f != JAX_FINAL:
        _fail(f"{label}: trajectory {f} != JAX {JAX_FINAL}")
    if int((out.app.next_send < 0).sum()) or out.pool.time.min() < 0:
        _fail(f"{label}: negative times in the final state")
    events = (f["sent"] - w["sent"]) + (f["recv"] - w["recv"])
    wall = t2 - t1
    windows = f["n_windows"] - w["n_windows"]
    print(f"{label}: n_steps {f['n_steps'] - w['n_steps']} n_windows "
          f"{windows} n_events {f['n_events'] - w['n_events']} events/s "
          f"{events / wall:.1f} wall {wall:.4f} s ({wall / windows * 1e3:.4f}"
          f" ms per window; warm-up {t1 - t0:.4f} s); launches {launches}; "
          f"trajectory equals the JAX package's", flush=True)
    return out, warm, launches, wall


def _ack_shed_input(dev, n_data, n_acks, n_free):
    """tests/test_ack_shed.py's crafted overflow on the card: in a 2-host
    bulk world host 1 has `n_data` data segments then `n_acks` pure ACKs
    in flight to host 0, whose inbox slab has `n_free` free slots."""
    import torch
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.core.state import (
        ICOL_FLAGS, ICOL_LEN, ICOL_PROTO, PROTO_TCP, STAGE_IN_FLIGHT,
        STAGE_RX_QUEUED, TCP_FLAG_ACK, ext_base)
    state, params, _ = sim.build_bulk(num_hosts=2, server=0,
                                      bytes_per_client=1000, stop_time=SEC,
                                      seed=1, persistent=False, device=dev)
    pool, ib = state.pool, state.inbox
    ko, ki = pool.capacity // 2, ib.capacity // 2
    idx = torch.arange(n_data + n_acks, device=dev) + ko
    is_ack = torch.arange(n_data + n_acks, device=dev) >= n_data
    blk, stage, tm = pool.blk.clone(), pool.stage.clone(), pool.time.clone()
    blk[idx, ICOL_PROTO] = PROTO_TCP
    blk[idx, ICOL_FLAGS] = TCP_FLAG_ACK
    blk[idx, ICOL_LEN] = torch.where(is_ack, 0, 100).to(blk.dtype)
    blk[idx, ext_base(blk.shape[1])] = 0
    stage[idx] = STAGE_IN_FLIGHT
    tm[idx] = 1000
    ib_stage = ib.stage.clone()
    ib_stage[n_free:ki] = STAGE_RX_QUEUED
    return state.replace(pool=pool.replace(blk=blk, stage=stage, time=tm),
                         inbox=ib.replace(stage=ib_stage)), params


# The exchange's fan-in probe: movers to one destination (host 0 of a
# 4-host bulk world), a quarter of its slab taken, pure ACKs mixed in.
FAN_IN = (2_000, 20_000)


def fan_in_arrays(n_movers: int, seed: int = 1, slab: int = 0,
                  taken: float = 0.25) -> dict:
    """A crafted TCP fan-in as numpy arrays for a 4-host world whose
    slabs hold ko = max(slab, ceil(1.2 x n_movers / 3)) slots: hosts 1-3
    each have a third of `n_movers` rows in flight to host 0, a third of
    them pure ACKs and the rest 100-byte data segments in shuffled order,
    and a twentieth more to the other clients; a fraction `taken` of host
    0's inbox slab is taken (by default a quarter, so host 0 overflows and
    the two-class gate is on).  Returns the pool's dst / proto / flags /
    len columns, stage and time and the inbox's stage, which
    tests/test_torch_exchange.py applies to a JAX world of the same
    shape."""
    import numpy as np
    r = np.random.default_rng(seed)
    h, per = 4, -(-n_movers // 3)
    ko = max(slab, -(-per * 6 // 5))
    p0 = h * ko
    stage = np.zeros(p0, np.int32)
    dst = np.zeros(p0, np.int32)
    for s in range(1, h):
        base = s * ko
        stage[base:base + per] = 2
        extra = per // 20
        stage[base + per:base + per + extra] = 2
        dst[base + per:base + per + extra] = r.choice(
            [d for d in range(1, h) if d != s], extra)
    ack = r.random(p0) < 1 / 3
    istage = np.zeros(p0, np.int32)
    istage[r.permutation(ko)[:int(ko * taken)]] = 3
    return dict(h=h, ko=ko, dst=dst, stage=stage,
                proto=np.full(p0, 6, np.int32),
                flags=np.full(p0, 16, np.int32),
                length=np.where(ack, 0, 100).astype(np.int32),
                time=r.integers(1, 1 << 40, p0).astype(np.int64),
                istage=istage)


def _fan_in_input(dev, n_movers: int):
    """fan_in_arrays on a 4-host bulk world of the port on `dev`."""
    import torch
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.core.state import (
        ICOL_FLAGS, ICOL_LEN, ICOL_PROTO, ext_base)
    f = fan_in_arrays(n_movers)
    state, params, _ = sim.build_bulk(num_hosts=f["h"], server=0,
                                      bytes_per_client=1000, stop_time=SEC,
                                      seed=1, persistent=False,
                                      pool_capacity=f["h"] * f["ko"],
                                      device=dev)
    pool, ib = state.pool, state.inbox
    t = {k: torch.from_numpy(v).to(dev) for k, v in f.items()
         if not isinstance(v, int)}
    blk = pool.blk.clone()
    blk[:, ICOL_PROTO] = t["proto"]
    blk[:, ICOL_FLAGS] = t["flags"]
    blk[:, ICOL_LEN] = t["length"]
    blk[:, ext_base(blk.shape[1])] = t["dst"]
    return state.replace(
        pool=pool.replace(blk=blk, stage=t["stage"], time=t["time"]),
        inbox=ib.replace(stage=t["istage"])), params


def check_fan_in(dev) -> list:
    """The exchange kernel on the crafted fan-ins (FAN_IN movers to one
    destination, gate on) against the plain version, torch.equal on every
    output; its device time at each size, and the ratio, which a step
    quadratic in one destination's movers would blow up.  Returns
    printable lines and {n: (kernel (device ms, call ms), bytes, ops)}."""
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    lines, out = [], {}
    for n in FAN_IN:
        state, params = _fan_in_input(dev, n)
        h = state.hosts.num_hosts

        def args(s=state):
            c = engine.clone_state(s)
            return c.pool, c.inbox, h, params
        ok = mk.exchange_kernel(*args())
        op = mk.exchange_plain(*args())
        require_equal(ok, op, f"fan-in exchange ({n} movers)")
        tot, tprot, nf = (int(v[0]) for v in op[2:])
        if not (tot >= n and tprot < tot and nf < tot):
            _fail(f"fan-in probe ({n}): host 0 takes {tot} movers, {tprot} "
                  f"protected, {nf} free: not the crafted overflow")
        b, ops = exchange_bound(state)
        times = time_call(mk.exchange_kernel, args, kernel="k_exchange")
        out[n] = (times, b, ops)
        lines.append(f"fan-in exchange: {tot} movers to host 0 ({tprot} "
                     f"protected, {nf} free slots, pool {state.pool.capacity} "
                     f"rows): equal; kernel device {times[0]:.4f} ms (call "
                     f"{times[1]:.4f} ms), bound {b} bytes, {ops} operations "
                     f"({bound_ms(b, ops):.6f} ms)")
    lo, hi = (out[n][0][0] for n in FAN_IN)
    lines.append(f"fan-in exchange: {FAN_IN[1]} movers take {hi / lo:.2f}x "
                 f"the device time of {FAN_IN[0]}")
    if hi >= 20 * lo:
        _fail(f"fan-in exchange: {FAN_IN[1]} movers take {hi / lo:.2f}x the "
              f"time of {FAN_IN[0]} (20x or more)")
    return lines, out


def check_ack_shed(dev) -> list:
    """The exchange kernel's two-class re-rank against the plain version
    on crafted overflows (pure ACKs shed first; data overflow raises
    ERR_POOL_OVERFLOW): every output and the accounting tail equal, and
    the shed count the crafted one.  Returns printable lines."""
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    lines = []
    for n_data, n_acks, n_free in ((6, 4, 8), (11, 2, 8), (0, 9, 5),
                                   (2, 2, 8)):
        state, params = _ack_shed_input(dev, n_data, n_acks, n_free)
        outs = []
        for fn in (mk.exchange_kernel, mk.exchange_plain):
            c = engine.clone_state(state)
            pool, ib, total, tprot, nf = fn(c.pool, c.inbox, 2, params)
            tail = engine._exchange_tail(c.replace(pool=pool, inbox=ib),
                                         total, tprot, nf)
            outs.append((pool, ib, total, tprot, nf, tail))
        label = f"ack shed ({n_data} data, {n_acks} acks, {n_free} free)"
        require_equal(outs[0], outs[1], label)
        tail = outs[0][5]
        shed = int(tail.hosts.acks_thinned.sum())
        want = max(0, min(n_acks, n_data + n_acks - n_free))
        if shed != want:
            _fail(f"{label}: {shed} acks shed, want {want}")
        lines.append(f"{label}: equal, {shed} shed, "
                     f"{int(tail.hosts.pkts_dropped_pool.sum())} data "
                     f"dropped, err {int(tail.err)}")
    return lines


def check_tcp_kernels(state, params, app, dev):
    """The TCP branches against their plain versions on clones of the
    bulk world: the exchange at the window boundary `state` is at, then
    K_DELIVER and K_TRANSPORT at the micro-step of the next window with
    the most due arrivals.  Returns (times, bounds, errs) keyed like the
    kernels line's TCP rows."""
    import torch
    from shadow1_tpu_torch.core import emit, engine
    from shadow1_tpu_torch.core import megakernel as mk
    from shadow1_tpu_torch.core.state import STAGE_IN_FLIGHT
    from shadow1_tpu_torch.transport import tcp
    clone = engine.clone_state
    ctx = engine._window_ctx(state, params)
    h = state.hosts.num_hosts
    times, bounds, errs = {}, {}, {}

    def ex_args(s=state):
        c = clone(s)
        return c.pool, c.inbox, h, params
    out_k = mk.exchange_kernel(*ex_args())
    out_p = mk.exchange_plain(*ex_args())
    errs["exchange_tcp"] = require_equal(out_k, out_p, "exchange (TCP)")
    n_mov = int((state.pool.stage == STAGE_IN_FLIGHT).sum())
    bounds["exchange_tcp"] = exchange_bound(state)
    times["exchange_tcp"] = (time_call(mk.exchange_kernel, ex_args,
                                       kernel="k_exchange"),
                             time_call(mk.exchange_plain, ex_args))
    print(f"tcp kernels: exchange equal ({n_mov} movers)", flush=True)

    # The window's micro-steps; keep the one with the most due arrivals.
    st = engine._exchange(clone(state), params, fused=True)
    t_h, gmin = engine._scan_all(st, params, app)
    we = min(max(int(st.now), int(gmin)) + params.min_latency_ns,
             params.stop_time)
    best, n_best = None, -1
    while int(gmin) < we:
        ib = st.inbox
        ki = ib.capacity // h
        tk = torch.where(t_h < we, t_h, we)
        due = ((ib.stage == STAGE_IN_FLIGHT).view(h, ki)
               & (ib.times().view(h, ki) <= tk[:, None])).sum()
        if int(due) > n_best:
            best, n_best = (clone(st), t_h.clone()), int(due)
        st, t_h, gmin = mk.microstep_fused(st, params, app, t_h, we, ctx)
    if best is None:
        _fail("the TCP probe window has no micro-step")
    st, t_h = best
    st, active, tick_t = engine._tick_setup(st, t_h, we)
    aux0 = engine._aux_times(st, params, app)
    lanes = engine._n_lanes(app)

    def dl_args(s=st):
        return (clone(s), params, app,
                emit.empty(h, lanes, s.pool.blk.shape[1], dev), tick_t,
                active, we, ctx[1], aux0)
    out_k = mk.deliver_kernel(*dl_args())
    out_p = mk.deliver_plain(*dl_args())
    errs["deliver_tcp"] = require_equal(out_k, out_p, "deliver (TCP)")
    s2, em, delivered_n, t_post = out_p
    bounds["deliver_tcp"] = (
        deliver_bytes(st, s2, delivered_n, active, app, em),
        deliver_ops(st, delivered_n, active, app, tcp=True))
    times["deliver_tcp"] = (time_call(mk.deliver_kernel, dl_args,
                                      kernel="k_deliver_tcp"),
                            time_call(mk.deliver_plain, dl_args))
    print(f"tcp kernels: deliver equal ({int(delivered_n.sum())} "
          f"deliveries, {int(em.valid.sum())} replies)", flush=True)

    s2, em = tcp.run_timers(s2, params, em, t_post, active)
    s2, em = engine._app_tick(s2, params, app, em, t_post, active, we)
    t_app = app.next_time(s2)

    def tr_args(s=s2):
        return (clone(s), params, app, clone(em), tick_t, t_post, active,
                ctx[0], delivered_n, t_app)
    out_k = mk.transport_kernel(*tr_args())
    out_p = mk.transport_plain(*tr_args())
    errs["transport_tcp"] = require_equal(out_k, out_p, "transport (TCP)")
    bounds["transport_tcp"] = (
        transport_bytes(s2, out_p[0], em, active, params, tcp=True),
        transport_ops(s2, em, active, tcp=True))
    times["transport_tcp"] = (time_call(mk.transport_kernel, tr_args,
                                        kernel="k_transport_tcp"),
                              time_call(mk.transport_plain, tr_args))
    sent = int((out_p[0].hosts.pkts_sent - s2.hosts.pkts_sent).sum())
    print(f"tcp kernels: transport equal ({sent} segments placed)",
          flush=True)
    for k, ((kd, kc), (pd, pc)) in times.items():
        print(f"tcp kernels: {k} kernel device {kd:.4f} ms (call "
              f"{kc:.4f} ms), plain device {pd:.4f} ms (call {pc:.4f} ms), "
              f"bound {bounds[k][0]} bytes, {bounds[k][1]} operations",
              flush=True)
    return times, bounds, errs


def check_lossy_tcp(dev) -> str:
    """The lossy 16-host bulk world to LOSSY_NS through K_WINDOW's TCP
    kernel, through the per-phase kernels and through the plain versions:
    equal leaf for leaf, with retransmissions reached.  Returns a
    printable line."""
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    finals = {}
    for path, (fused, persist, want) in (
            ("K_WINDOW", (True, True, {"window"})),
            ("per-phase", (True, False, set(PER_PHASE))),
            ("plain", (False, False, set()))):
        s0, p0, a0 = sim.build_bulk(**LOSSY, megakernel=fused,
                                    persistent=persist, device=dev)
        mk.reset_launches()
        finals[path] = engine.run_until(s0, p0, a0, LOSSY_NS)
        used = {k for k, v in mk.LAUNCHES.items() if v > 0}
        if used != want:
            _fail(f"lossy TCP world, {path} path: launches {mk.LAUNCHES}")
    require_equal(finals["K_WINDOW"], finals["plain"],
                  "lossy TCP world, K_WINDOW")
    require_equal(finals["per-phase"], finals["plain"],
                  "lossy TCP world, per-phase kernels")
    out = finals["plain"]
    retx = int(out.socks.retx_segs.sum())
    if retx <= 0:
        _fail("lossy TCP world: no retransmission reached")
    return (f"tcp kernels: lossy world (H={LOSSY['num_hosts']}, "
            f"{LOSSY_NS // MS} ms, reliability {LOSSY['reliability']}) equal "
            f"through K_WINDOW, the per-phase kernels and the plain "
            f"versions; {int(out.n_steps)} micro-steps, "
            f"{int(out.n_windows)} windows, {retx} retransmitted segments, "
            f"{int(out.hosts.pkts_dropped_inet.sum())} segments lost, "
            f"{int((out.app.phase == 2).sum())} transfers done")


def drive_tcp(dev, persistent: bool):
    """BULK from 0 to BULK_RUN_NS (warm-up with run_until, then
    run_chunked), every launch counter zeroed just before and read just
    after; the trajectory must equal the JAX package's, and the launches
    one K_WINDOW per run_until call (persistent, sim.build_bulk's default)
    or one exchange per window and one K_DELIVER and K_TRANSPORT per
    micro-step (persistent=False).  Returns (final state, warm state,
    params, app, launches, wall seconds of the timed part)."""
    import torch
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    if persistent:
        state, params, app = sim.build_bulk(**BULK, device=dev)
        if not (params.megakernel and params.persistent):
            _fail("sim.build_bulk's defaults are not megakernel + "
                  "persistent")
        label = "tcp main path (persistent)"
    else:
        state, params, app = sim.build_bulk(**BULK, persistent=False,
                                            device=dev)
        label = "tcp per-phase path"
    torch.cuda.synchronize()
    mk.reset_launches()
    with RunCalls() as calls:
        t0 = time.perf_counter()
        warm = engine.run_until(state, params, app, WARM_NS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = engine.run_chunked(warm, params, app, BULK_RUN_NS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = dict(mk.LAUNCHES)
    w, f = tcp_summary(warm), tcp_summary(out)
    if w != JAX_BULK_WARM:
        _fail(f"{label}: warm-up trajectory {w} != JAX {JAX_BULK_WARM}")
    if f != JAX_BULK_FINAL:
        _fail(f"{label}: trajectory {f} != JAX {JAX_BULK_FINAL}")
    if persistent:
        bad = launches["window"] != calls.n or \
            any(launches[k] for k in PER_PHASE)
    else:
        bad = launches["window"] or \
            launches["exchange"] != f["n_windows"] or \
            launches["deliver"] != f["n_steps"] or \
            launches["transport"] != f["n_steps"]
    if bad:
        _fail(f"{label}: launches {launches} do not match its run_until "
              f"calls ({calls.n}) / windows / micro-steps")
    wall = t2 - t1
    windows = f["n_windows"] - w["n_windows"]
    steps = f["n_steps"] - w["n_steps"]
    events = f["n_events"] - w["n_events"]
    print(f"{label}: n_steps {steps} n_windows {windows} n_events {events} "
          f"events/s {events / wall:.1f} wall {wall:.4f} s "
          f"({wall / windows * 1e3:.4f} ms per window, "
          f"{wall / steps * 1e3:.4f} ms per micro-step; warm-up "
          f"{t1 - t0:.4f} s); bytes received {f['bytes_recv']}, "
          f"{f['done']} transfers done, err {f['err']} "
          f"({int(out.hosts.pkts_dropped_pool.sum())} segments over a full "
          f"slab, {int(out.hosts.acks_thinned.sum())} acks shed, "
          f"{int(out.socks.retx_segs.sum())} retransmitted); launches "
          f"{launches}; trajectory equals the JAX package's", flush=True)
    return out, warm, params, app, launches, wall


def _timed_windows(warm, params, app, n: int | None,
                   until: int | None = None):
    """The first `n` windows after `warm` through the engine's persistent
    loop (n None: the main path's run_chunked to BULK_RUN_NS, or, given
    `until`, its run_until to there), with CUDA events around each
    K_WINDOW call (megakernel.window_call wrapped; one a run_until call).
    Returns (final state, wall seconds, device ms of each call)."""
    import torch
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    call, marks = mk.window_call, []

    def timed(*a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = call(*a)
        e1.record()
        marks.append((e0, e1))
        return out
    st = engine.clone_state(warm)
    torch.cuda.synchronize()
    mk.window_call = timed
    try:
        w0 = time.perf_counter()
        if n is None and until is not None:
            st = engine.run_until_impl(st, params, app, until)
        elif n is None:
            st = engine.run_chunked(st, params, app, BULK_RUN_NS)
        else:
            st = engine.run_until_impl(
                st, params, app, int(st.now) + n * params.min_latency_ns)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    finally:
        mk.window_call = call
    return st, wall, [e0.elapsed_time(e1) for e0, e1 in marks]


def bound_ms(b: int, ops: int) -> float:
    """The least card time for `b` bytes and `ops` operations (ms)."""
    return max(b / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def busy_windows(warm, params, app, n: int | None,
                 label: str = "tcp main path (persistent)",
                 until: int | None = None):
    """The first `n` windows after `warm` on the persistent path again
    (n None: the whole timed part, to `until` if given), with CUDA events
    around each K_WINDOW call (one a run_until call): device ms per launch
    and per window, and the device's busy share of the wall.  Returns
    (printable line, mean device ms per window, final state)."""
    st, wall, ms = _timed_windows(warm, params, app, n, until=until)
    steps = int(st.n_steps) - int(warm.n_steps)
    windows = max(int(st.n_windows) - int(warm.n_windows), 1)
    busy = sum(ms) / 1e3 / wall
    return (f"{label}: {windows} windows ({steps} "
            f"micro-steps{'' if n else ', the whole timed part'}) again "
            f"with CUDA events: wall {wall:.4f} s, {len(ms)} K_WINDOW "
            f"launches, device {sum(ms):.4f} ms ({statistics.mean(ms):.4f} "
            f"ms a launch), {sum(ms) / windows:.4f} ms per window, "
            f"{sum(ms) / max(steps, 1):.4f} ms per micro-step; device busy "
            f"{100 * busy:.1f} %"), sum(ms) / windows, st


# K_WINDOW's traced phases (csrc/common.cuh ClkPhase), in kernel order.
CLK_PHASES = [(27, "open: exchange count"), (28, "open: exchange scans"),
              (29, "open: exchange sort passes (v1: bucket)"),
              (30, "open: exchange place (v1: + host scan)"),
              (0, "open: rest (scan, fold)"), (25, "tick setup"),
              (1, "router enqueue")] + [
    (2 + 4 * r + i, f"round {r} {part}") for r in range(4)
    for i, part in enumerate(("select/NIC", "begin", "gate", "finish"))] + [
    (26, "rx write-back"), (18, "run_timers"), (19, "tick"),
    (20, "transmit+staging"), (21, "TX drain"), (22, "post-step scan"),
    (23, "step close"), (24, "window close")]
# The phases of K_DELIVER's body among them.
RX_PHASES = (25, 1, *range(2, 18), 26)


def phase_trace(warm, params, app, n: int, host: int = 0,
                label: str = "phase trace"):
    """The first `n` windows after `warm` through K_WINDOW's clocked build
    (-DS1_PHASE_CLOCKS): the cycles the thread (or warp) of host `host`
    spends in each phase, its barrier waits among them.  The phase shares
    of those cycles times the windows' device time (CUDA events) give ms.
    Returns (printable lines, each starting with `label`, final state)."""
    import torch
    from shadow1_tpu_torch.core import megakernel as mk
    buf = torch.zeros(mk.CLK_WORDS, dtype=torch.int64,
                      device=warm.pool.stage.device)
    try:
        # One window first, into a scratch buffer, so that loading the
        # clocked build is not timed.
        mk.set_phase_clocks(torch.zeros_like(buf), host)
        _timed_windows(warm, params, app, 1)
        mk.set_phase_clocks(buf, host)
        st, wall, ms = _timed_windows(warm, params, app, n)
    finally:
        mk.set_phase_clocks(None)
    cyc = buf.cpu().tolist()
    traced = max(cyc[31], 1)
    total = sum(cyc[i] for i, _ in CLK_PHASES)
    dev_ms = sum(ms)
    steps = int(st.n_steps) - int(warm.n_steps)
    rows = [(name, cyc[i]) for i, name in CLK_PHASES if cyc[i]]
    windows = int(st.n_windows) - int(warm.n_windows)
    lines = [f"{label}: host {host}, {windows} windows in {len(ms)} "
             f"K_WINDOW calls, {steps} micro-steps ({cyc[31]} traced), "
             f"K_WINDOW device {dev_ms:.4f} ms, {total} cycles traced "
             f"({total / dev_ms / 1e3:.1f} MHz); wall {wall:.4f} s"]
    lines += [f"{label}: {name}: {c / total * 100:.2f} %, "
              f"{c / traced:.1f} cycles and {dev_ms * c / total / traced * 1e3:.3f}"
              f" us per micro-step" for name, c in rows]
    gate = sum(c for name, c in rows if name.endswith("gate")
               or name == "step close")
    lines.append(f"{label}: grid barriers (gates + step close) "
                 f"{gate / total * 100:.2f} % of the traced host's cycles")
    rx = sum(cyc[i] for i in RX_PHASES)
    lines.append(f"{label}: K_DELIVER's phases (tick setup, router "
                 f"enqueue, the rounds, rx write-back) {rx / total * 100:.2f} "
                 f"%, {rx / traced:.1f} cycles and "
                 f"{dev_ms * rx / total / traced * 1e3:.3f} us per "
                 f"micro-step")
    ex = sum(cyc[i] for i in (27, 28, 29, 30))
    lines.append(f"{label}: the window open's exchange (count, scans, sort, "
                 f"place) {ex / max(windows, 1):.1f} cycles and "
                 f"{dev_ms * ex / total / max(windows, 1):.4f} ms a window")
    return lines, st, dev_ms * ex / total / max(windows, 1)


def phold_trace(warm, params, app, n: int) -> list:
    """Phold's K_WINDOW over the first `n` windows after `warm`: their
    device time (CUDA events around each K_WINDOW call) against their
    bound (windows_bound), then traced by phase for two hosts: the one
    with the most events (sends plus receives) in those windows and the
    one at the median.  Each traced run's final state must equal the
    untraced run's.  Returns printable lines."""
    import torch
    ref, wall, ms = _timed_windows(warm, params, app, n)
    sh = {"exchange": [0, 0], "deliver": [0, 0]}
    b, ops, steps = windows_bound(warm, params, app, n, shares=sh)
    windows = int(ref.n_windows) - int(warm.n_windows)
    lines = [f"main path (persistent): the first {n} windows ({steps} "
             f"micro-steps) in {len(ms)} K_WINDOW call(s): device "
             f"{sum(ms):.4f} ms (CUDA events), wall {wall:.4f} s; they must "
             f"move {b} bytes and do {ops} operations: bound "
             f"{bound_ms(b, ops):.6f} ms",
             f"main path (persistent): K_DELIVER's share of those windows "
             f"must move {sh['deliver'][0]} bytes and do "
             f"{sh['deliver'][1]} operations: bound "
             f"{bound_ms(*sh['deliver']) / max(steps, 1):.6f} ms a "
             f"micro-step; the exchange's at their {windows} opens "
             f"{sh['exchange'][0]} bytes and {sh['exchange'][1]} "
             f"operations: bound "
             f"{bound_ms(*sh['exchange']) / max(windows, 1):.6f} ms a "
             f"window"]
    ev = (ref.app.sent + ref.app.recv) - (warm.app.sent + warm.app.recv)
    order = torch.argsort(ev, stable=True)
    busiest, typical = int(order[-1]), int(order[len(order) // 2])
    for host, kind in ((busiest, "most events"), (typical, "median")):
        out, st, _ = phase_trace(warm, params, app, n, host,
                                 label="phold phase trace")
        require_equal(st, ref, f"phold phase trace (host {host}) vs the "
                               f"untraced windows")
        lines.append(f"phold phase trace: host {host} ({kind}: "
                     f"{int(ev[host])} events in {n} windows)")
        lines += out
    return lines


def pairs_world(dev, h: int, persistent: bool):
    """The "pairs" TCP world on `dev`: host 2i+1 sends 64 KiB to host 2i
    over a uniform 10 ms full mesh of min(h, 256) vertices (host i on
    vertex i mod 256, as build_phold maps its hosts), Reno, rx_batch 4,
    sized by the JAX package's assembler rule for fan-in 1
    (config/assemble.py: 6 socket slots, 128-slot slabs), built with the
    API the two packages share (tests/test_torch_window_tcp.py holds its
    shape against the JAX package)."""
    import torch
    from shadow1_tpu_torch.apps import bulk
    from shadow1_tpu_torch.core.params import make_net_params
    from shadow1_tpu_torch.core.state import make_sim_state
    from shadow1_tpu_torch.routing.synthetic import uniform_full_mesh
    v = min(h, 256)
    lat, rel = uniform_full_mesh(v, 10 * MS, 1.0)
    ids = torch.arange(h)
    is_server = ids % 2 == 0
    params = make_net_params(
        latency_ns=lat, reliability=rel, host_vertex=ids % v,
        bw_up_Bps=torch.full((h,), 1 << 30),
        bw_down_Bps=torch.full((h,), 1 << 30), seed=1, stop_time=60 * SEC,
        persistent=persistent, device=dev)
    state = make_sim_state(h, sock_slots=6, pool_capacity=h * 128,
                           uses_tcp=True, device=dev)
    state = state.replace(
        socks=bulk.setup_servers(state.socks, is_server.to(dev)),
        app=bulk.init_state(h, is_client=~is_server, dst=ids - ids % 2,
                            total_bytes=torch.where(is_server, 0, 64 * 1024),
                            start_t=MS, device=dev))
    return state, params, bulk.Bulk()


def run_pairs(dev) -> tuple:
    """The pairs world (PAIRS_H hosts) to PAIRS_NS on both of the port's
    paths, each with its launch counters zeroed just before and read just
    after (one K_WINDOW per run_until call; one exchange per window and one
    K_DELIVER and K_TRANSPORT per micro-step): the final states must be
    equal leaf for leaf.  Then k_window_tcp against window_plain on the
    window with the most events, timed.  Returns that window's ((kernel
    (device ms, call ms), plain (device ms, call ms)), max |diff|)."""
    import torch
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    finals = {}
    for persistent in (True, False):
        state, params, app = pairs_world(dev, PAIRS_H, persistent)
        label = (f"pairs world (H={PAIRS_H}, "
                 f"{'persistent' if persistent else 'per-phase'} path)")
        torch.cuda.synchronize()
        mk.reset_launches()
        with RunCalls() as calls:
            t0 = time.perf_counter()
            out = engine.run_chunked(state, params, app, PAIRS_NS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(mk.LAUNCHES)
        f = tcp_summary(out)
        if persistent:
            bad = launches["window"] != calls.n or \
                any(launches[k] for k in PER_PHASE)
        else:
            bad = launches["window"] or \
                launches["exchange"] != f["n_windows"] or \
                launches["deliver"] != f["n_steps"] or \
                launches["transport"] != f["n_steps"]
        if bad:
            _fail(f"{label}: launches {launches} do not match its windows "
                  f"/ micro-steps")
        if f["done"] != PAIRS_H // 2:
            _fail(f"{label}: {f['done']} of {PAIRS_H // 2} transfers done")
        print(f"{label}: n_steps {f['n_steps']} n_windows {f['n_windows']} "
              f"n_events {f['n_events']} events/s {f['n_events'] / wall:.1f} "
              f"wall {wall:.4f} s ({wall / f['n_steps'] * 1e3:.4f} ms per "
              f"micro-step); bytes received {f['bytes_recv']}, "
              f"{f['done']} transfers done, err {f['err']}; launches "
              f"{launches}", flush=True)
        finals[persistent] = out
    require_equal(finals[True], finals[False],
                  "pairs world, persistent vs per-phase path")
    print("pairs world: final states of the two paths equal", flush=True)
    del finals

    # The window with the most events, found on a third (untimed) run.
    state, params, app = pairs_world(dev, PAIRS_H, True)
    call, best = mk.window_call, [None, -1]

    def probe(st, p, a, t_target, max_windows=1):
        before = (engine.clone_state(st), int(st.n_events))
        out = call(st, p, a, t_target, max_windows)
        n = int(out[0].n_events) - before[1]
        if n > best[1]:
            best[:] = [(before[0], t_target), n]
        return out
    mk.window_call = probe
    try:
        engine.run_chunked(state, params, app, PAIRS_NS)
    finally:
        mk.window_call = call
    (heavy, t_target), n_ev = best

    def args():
        return engine.clone_state(heavy), params, app, t_target
    out_k = mk.window_kernel(*args())
    out_p = mk.window_plain(*args())
    err = require_equal(out_k, out_p, "pairs world: heaviest window")
    times = (time_call(mk.window_kernel, args, kernel="k_window_tcp"),
             time_call(mk.window_plain, args, reps=1))
    (kd, kc), (pd, pc) = times
    steps = int(out_k[0].n_steps) - int(heavy.n_steps)
    print(f"pairs world: k_window_tcp equal to window_plain on the "
          f"heaviest window ({n_ev} events, {steps} micro-steps, window "
          f"{out_k[2][1].item()}..{out_k[2][2].item()} ns); kernel device "
          f"{kd:.4f} ms (call {kc:.4f} ms), plain device {pd:.4f} ms (call "
          f"{pc:.4f} ms)", flush=True)
    return times, err


def check_loopback_transport(dev) -> str:
    """K_TRANSPORT's TCP kernel (k_transport_tcp) with the staging's
    loopback insert against transport_plain, torch.equal on every output,
    at every micro-step of the loopback world's first window (host 0's
    first stream, all of it to itself at 1 ns a hop); the steps run
    through the kernels between the checks.  The compared steps must
    place loopback rows."""
    import torch
    from shadow1_tpu_torch.core import emit, engine
    from shadow1_tpu_torch.core import megakernel as mk
    from shadow1_tpu_torch.transport import tcp as tcp_mod
    state, params, app = loopback_world(persistent=False, device=dev)
    clone = engine.clone_state
    h = state.hosts.num_hosts
    ctx = engine._window_ctx(state, params)
    st = engine._exchange(clone(state), params, fused=True)
    t_h, gmin = engine._scan_all(st, params, app)
    we = min(max(int(st.now), int(gmin)) + params.min_latency_ns, LOOP_NS)
    steps = loops = 0
    rows = torch.arange(h, device=dev)[:, None]
    while int(gmin) < we:
        s1, active, tick_t = engine._tick_setup(clone(st), t_h, we)
        aux0 = engine._aux_times(s1, params, app)
        em = emit.empty(h, engine._n_lanes(app), s1.pool.blk.shape[1], dev)
        s2, em, dn, tp = mk.deliver_kernel(s1, params, app, em, tick_t,
                                           active, we, ctx[1], aux0)
        s2, em = tcp_mod.run_timers(s2, params, em, tp, active)
        s2, em = engine._app_tick(s2, params, app, em, tp, active, we)
        t_app = app.next_time(s2)
        loops += int((em.valid & (em.dst == rows)).sum())

        def args(s=s2, e=em):
            return (clone(s), params, app, emit.Emissions(
                valid=e.valid.clone(), blk=e.blk.clone()), tick_t, tp,
                active, ctx[0], dn, t_app)
        out_k = mk.transport_kernel(*args())
        out_p = mk.transport_plain(*args())
        require_equal(out_k, out_p,
                      f"transport (loopback world, step {steps})")
        st, t_h, gmin = out_k
        steps += 1
    if loops <= 0:
        _fail("loopback world: the compared steps staged no loopback row")
    return (f"tgen kernels: transport_tcp with the loopback insert equal "
            f"at all {steps} micro-steps of the loopback world's first "
            f"window ({loops} loopback rows staged)")


def drive_tgen(dev, persistent: bool, resident: bool | None = None):
    """The tgen world (TGEN_HOSTS, sim.build_tgen's defaults) through
    run_until to TGEN_MID_NS and then to TGEN_NS (only to TGEN_MID_NS on
    the per-phase path), every launch counter zeroed just before and read
    just after; the trajectories must equal the JAX package's and the
    launches one K_WINDOW per run_until call (persistent; `resident`
    forces a design, tgen_design) or one exchange per window and one
    K_DELIVER and K_TRANSPORT per micro-step.  Returns (state at
    TGEN_MID_NS, final state, params, app, launches, wall seconds of the
    whole run)."""
    import torch
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    label = "tgen main path (persistent)" if persistent \
        else "tgen per-phase path"
    if resident is not None:
        label += f", {'resident kernel' if resident else 'warp design'}"
    state, params, app = sim.build_tgen(TGEN_HOSTS, persistent=persistent,
                                        device=dev)
    if persistent and not (params.megakernel and params.persistent):
        _fail("sim.build_tgen's defaults are not megakernel + persistent")
    torch.cuda.synchronize()
    mk.reset_launches()
    mk.set_window_tgen_resident(resident)
    try:
        with RunCalls() as calls:
            t0 = time.perf_counter()
            mid = engine.run_until(state, params, app, TGEN_MID_NS)
            out = engine.run_until(mid, params, app, TGEN_NS) if persistent \
                else mid
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        mk.set_window_tgen_resident(None)
    launches = dict(mk.LAUNCHES)
    m, f = tgen_summary(mid), tgen_summary(out)
    if m != JAX_TGEN_MID:
        _fail(f"{label}: trajectory at {TGEN_MID_NS // SEC} s {m} != JAX "
              f"{JAX_TGEN_MID}")
    if persistent and f != JAX_TGEN_FINAL:
        _fail(f"{label}: trajectory {f} != JAX {JAX_TGEN_FINAL}")
    if persistent:
        bad = launches["window"] != calls.n or \
            any(launches[k] for k in PER_PHASE)
    else:
        bad = launches["window"] or \
            launches["exchange"] != f["n_windows"] or \
            launches["deliver"] != f["n_steps"] or \
            launches["transport"] != f["n_steps"]
    if bad:
        _fail(f"{label}: launches {launches} do not match its run_until "
              f"calls ({calls.n}) / windows / micro-steps")
    t_end = TGEN_NS if persistent else TGEN_MID_NS
    print(f"{label}: 0 -> {t_end // SEC} s: n_steps {f['n_steps']} "
          f"n_windows {f['n_windows']} n_events {f['n_events']} events/s "
          f"{f['n_events'] / wall:.1f} wall {wall:.4f} s "
          f"({wall / f['n_windows'] * 1e3:.4f} ms per window, "
          f"{wall / f['n_steps'] * 1e3:.4f} ms per micro-step); streams "
          f"done {f['done']}, failed {f['failed']}, hosts finished "
          f"{f['finished']}, err {f['err']} "
          f"({int(out.hosts.pkts_dropped_pool.sum())} segments over a full "
          f"slab); launches {launches}; trajectory equals the JAX "
          f"package's", flush=True)
    return mid, out, params, app, launches, wall


def run_loopback(dev) -> str:
    """The loopback world to LOOP_NS on both paths, counters zeroed just
    before and read just after: each trajectory must equal the JAX
    package's, and the two final states each other, leaf for leaf."""
    import torch
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    outs, used = {}, {}
    for persistent in (True, False):
        state, params, app = loopback_world(persistent=persistent,
                                            device=dev)
        mk.reset_launches()
        with RunCalls() as calls:
            outs[persistent] = engine.run_until(state, params, app, LOOP_NS)
            torch.cuda.synchronize()
        used[persistent] = dict(mk.LAUNCHES)
        got = tgen_summary(outs[persistent])
        if got != JAX_LOOP_FINAL:
            _fail(f"loopback world (persistent={persistent}): trajectory "
                  f"{got} != JAX {JAX_LOOP_FINAL}")
    if used[True]["window"] != calls.n or calls.n != 1 or \
            used[False]["deliver"] != JAX_LOOP_FINAL["n_steps"]:
        _fail(f"loopback world: launches {used}")
    require_equal(outs[True], outs[False], "loopback world: persistent vs "
                  "per-phase path")
    return (f"tgen loopback world (H={LOOP_HOSTS}, to {LOOP_NS // SEC} s): "
            f"both paths' trajectories equal the JAX package's "
            f"{JAX_LOOP_FINAL}, final states equal leaf for leaf; launches "
            f"persistent {used[True]}, per-phase {used[False]}")


# ---------------------------------------------------------------------------
# Per-packet jitter in K_TRANSPORT's staging (phase 14)
# ---------------------------------------------------------------------------


def strip_jitter(params):
    """`params` with every route's jitter amplitude 0 and has_jitter off,
    latencies, loss and window length kept: the same world without
    jitter, which a jittered kernel's time is put beside."""
    from shadow1_tpu_torch.core.params import RCOL_JIT_HI, RCOL_JIT_LO
    blk = params.route_blk.clone()
    blk[:, RCOL_JIT_LO:RCOL_JIT_HI + 1] = 0
    return params.replace(route_blk=blk, has_jitter=False)


def jittered_world(kind: str, spec: dict, dev, persistent: bool = False):
    """sim.build_phold ("phold") or sim.build_bulk ("bulk") with `spec`,
    its params made again by make_net_params from the same uniform mesh
    plus a jitter amplitude of up to JITTER_MAX_NS on about 3 of every 4
    vertex pairs (numpy seed 3)."""
    import numpy as np
    import torch
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.core.params import make_net_params
    from shadow1_tpu_torch.routing.synthetic import uniform_full_mesh
    build = sim.build_phold if kind == "phold" else sim.build_bulk
    state, params, app = build(**spec, persistent=persistent, device=dev)
    h = spec["num_hosts"]
    v = min(h, 256) if kind == "phold" else h
    lat, rel = uniform_full_mesh(v, spec.get("latency_ns", 10 * MS),
                                 spec.get("reliability", 1.0))
    rng = np.random.default_rng(3)
    jit = rng.integers(0, JITTER_MAX_NS, (v, v))
    jit[rng.random((v, v)) < 0.25] = 0
    params = make_net_params(
        latency_ns=lat, reliability=rel, host_vertex=torch.arange(h) % v,
        bw_up_Bps=params.bw_up_Bps.cpu(),
        bw_down_Bps=params.bw_down_Bps.cpu(), seed=spec.get("seed", 1),
        stop_time=params.stop_time, bootstrap_end=params.bootstrap_end,
        jitter_ns=jit, persistent=persistent, device=dev)
    return state, params, app


def jitter_moved(after, params, before=None) -> tuple[int, int]:
    """(outbox rows in use in `after` -- only those staged since `before`
    when given --, how many of them carry a latency off their route's
    base latency): the rows a nonzero jitter draw moved."""
    from shadow1_tpu_torch.core.state import (ICOL_SRC, OEXT_LAT_HI,
                                              OEXT_LAT_LO, STAGE_FREE,
                                              dec_i64, ext_base)
    blk = after.blk
    xb = ext_base(blk.shape[1])
    used = after.stage != STAGE_FREE
    if before is not None:
        used &= before.stage == STAGE_FREE
    hv = params.host_vertex.long()
    src = blk[:, ICOL_SRC].long().clamp(0, hv.shape[0] - 1)
    dst = after.dst.long().clamp(0, hv.shape[0] - 1)
    base, _ = params.route_narrow(hv[src], hv[dst])
    staged = dec_i64(blk[:, xb + OEXT_LAT_LO], blk[:, xb + OEXT_LAT_HI])
    moved = used & (staged != base.clamp(min=1)) & (src != dst)
    return int(used.sum()), int(moved.sum())


def transport_each_step(state, params, app, dev, label: str):
    """K_TRANSPORT against its plain version, torch.equal on every output,
    at every micro-step of the window that opens at `state` (a window
    boundary); the micro-steps themselves run through the per-phase
    kernels.  Returns (micro-steps, rows staged, rows moved by jitter,
    args(p): the inputs of the step with the most emissions, under params
    `p`)."""
    from shadow1_tpu_torch.core import emit, engine
    from shadow1_tpu_torch.core import megakernel as mk
    from shadow1_tpu_torch.transport import tcp
    clone = engine.clone_state
    h = state.hosts.num_hosts
    lanes = engine._n_lanes(app)
    ctx = engine._window_ctx(state, params)
    st = engine._exchange(clone(state), params, fused=True)
    t_h, gmin = engine._scan_all(st, params, app)
    we = min(max(int(st.now), int(gmin)) + params.min_latency_ns,
             params.stop_time)
    steps = staged = moved = 0
    best, n_best = None, -1
    while int(gmin) < we:
        s1, active, tick_t = engine._tick_setup(clone(st), t_h, we)
        aux0 = engine._aux_times(s1, params, app)
        s2, em, dn, tp = mk.deliver_plain(
            s1, params, app, emit.empty(h, lanes, s1.pool.blk.shape[1], dev),
            tick_t, active, we, ctx[1], aux0)
        if engine._uses_tcp(app):
            s2, em = tcp.run_timers(s2, params, em, tp, active)
        s2, em = engine._app_tick(s2, params, app, em, tp, active, we)
        rest = (tick_t, tp, active, ctx[0], dn, app.next_time(s2))

        def args(p, s=s2, e=em, r=rest):
            return (clone(s), p, app, clone(e), *r)
        out_k = mk.transport_kernel(*args(params))
        out_p = mk.transport_plain(*args(params))
        require_equal(out_k, out_p, f"{label}, micro-step {steps}")
        n, m = jitter_moved(out_p[0].pool, params, before=s2.pool)
        staged += n
        moved += m
        if int(em.valid.sum()) > n_best:
            best, n_best = args, int(em.valid.sum())
        st, t_h, gmin = mk.microstep_fused(st, params, app, t_h, we, ctx)
        steps += 1
    return steps, staged, moved, best


def jitter_transport(state, params, app, dev, label: str, kernel: str,
                     windows: int = 1) -> tuple[str, float, float]:
    """transport_each_step over `windows` windows from `state`; fails
    unless some staged row was moved by a jitter draw.  Then the kernel's
    device time at the step with the most emissions, with jitter and on
    the same inputs without (strip_jitter).  Returns (printable line,
    device ms with jitter, without)."""
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    steps = staged = moved = 0
    best = None
    for w in range(windows):
        n, st_, mv, args = transport_each_step(state, params, app, dev,
                                               f"{label}, window {w}")
        steps, staged, moved = steps + n, staged + st_, moved + mv
        best = args or best
        state = engine.run_until(state, params, app,
                                 int(state.now) + params.min_latency_ns)
    if moved <= 0 or best is None:
        _fail(f"{label}: no staged row was moved by a jitter draw "
              f"({staged} staged over {steps} micro-steps)")
    plain = strip_jitter(params)
    ms_j = time_call(mk.transport_kernel, lambda: best(params),
                     kernel=kernel)[0]
    ms_n = time_call(mk.transport_kernel, lambda: best(plain),
                     kernel=kernel)[0]
    return (f"jitter kernels: {label}: {kernel} equal to its plain version "
            f"at all {steps} micro-steps of {windows} window(s), {staged} "
            f"rows staged, {moved} of them moved by a nonzero jitter draw; "
            f"device {ms_j:.4f} ms with jitter, {ms_n:.4f} ms on the same "
            f"inputs without"), ms_j, ms_n


def jitter_window(state, params, app, label: str,
                  kernel: str) -> tuple[str, float, float]:
    """K_WINDOW (`kernel`) against window_plain over the window that opens
    at `state`, torch.equal on every leaf, where some row staged in it was
    moved by jitter; then its device time with jitter and on the same
    state without (strip_jitter).  Returns (printable line, ms with
    jitter, without)."""
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    params = params.replace(persistent=True)
    times, _bound, _err = check_window(state, params, app, advance=0,
                                       label=f"jitter kernels: {label}",
                                       kernel=kernel, plain_reps=0)
    kd = times[0][0]
    out = mk.window_plain(engine.clone_state(state), params, app,
                          params.stop_time)[0]
    n, moved = jitter_moved(out.pool, params)
    if moved <= 0:
        _fail(f"{label}: no outbox row at the window's end was moved by a "
              f"jitter draw ({n} in use)")
    plain = strip_jitter(params)
    kn = time_call(mk.window_kernel,
                   lambda: (engine.clone_state(state), plain, app,
                            params.stop_time, 1), kernel=kernel)[0]
    return (f"jitter kernels: {label}: {n} outbox rows in use at the "
            f"window's end, {moved} moved by a nonzero jitter draw; {kernel} "
            f"device "
            f"{kd:.4f} ms with jitter, {kn:.4f} ms on the same state "
            f"without"), kd, kn


def check_jitter_kernels(dev) -> tuple[list, dict]:
    """Phase 14: K_TRANSPORT's jitter draw (csrc/transport.cuh `jittered`)
    against the plain staging on jittered worlds, torch.equal: k_transport
    at every micro-step of a window of the jittered STRESS world
    (transport_small) and of the jittered KO world (the general path);
    k_window over one window of the STRESS world; k_transport_tcp at
    every micro-step of windows of JITTER_CONFIG (assembled by the port's
    config front end) at JITTER_TCP_PROBE_NS, and k_window_tgen over one
    of its windows; k_window_tcp over a window of the jittered LOSSY bulk
    world.  Returns (printable lines, {kernel: (ms with jitter, ms
    without)})."""
    import tempfile
    from shadow1_tpu_torch.config import assemble
    from shadow1_tpu_torch.core import engine
    lines, ms = [], {}

    def note(name, res):
        lines.append(res[0])
        ms[name] = res[1:]

    state, params, app = jittered_world("phold", STRESS, dev)
    state = engine.run_until(state, params, app, JITTER_PROBE_NS)
    note("k_transport", jitter_transport(
        state, params, app, dev, f"STRESS world with jitter at "
        f"{JITTER_PROBE_NS // MS} ms (transport_small)", "k_transport"))
    note("k_window", jitter_window(state, params, app,
                                   "STRESS world with jitter", "k_window"))
    state, params, app = jittered_world("phold", KO, dev)
    state = engine.run_until(state, params, app, JITTER_PROBE_NS)
    note("k_transport general", jitter_transport(
        state, params, app, dev, f"KO world with jitter at "
        f"{JITTER_PROBE_NS // MS} ms (the general path)", "k_transport"))
    with tempfile.TemporaryDirectory() as d:
        asm = assemble.load(write_jitter_config(d), persistent=False,
                            device=dev)
    state = engine.run_until(asm.state, asm.params, asm.app,
                             JITTER_TCP_PROBE_NS)
    note("k_transport_tcp", jitter_transport(
        state, asm.params, asm.app, dev, f"JITTER_CONFIG at "
        f"{JITTER_TCP_PROBE_NS / SEC:g} s", "k_transport_tcp", windows=4))
    for resident, kernel, _tag in TGEN_DESIGNS:
        with tgen_design(resident):
            note(kernel, jitter_window(state, asm.params, asm.app,
                                       "JITTER_CONFIG", kernel))
    state, params, app = jittered_world("bulk", LOSSY, dev)
    state = engine.run_until(state, params, app, JITTER_BULK_PROBE_NS)
    note("k_window_tcp", jitter_window(state, params, app,
                                       "LOSSY bulk world with jitter",
                                       "k_window_tcp"))
    return lines, ms


# ---------------------------------------------------------------------------
# The CLI on config worlds (phases 15-17)
# ---------------------------------------------------------------------------


def run_cli(argv: list, label: str) -> dict:
    """shadow1_tpu_torch.cli's `run` with `argv` (its flags and the
    config) on the card, every launch counter zeroed just before and read
    just after; the run must exit 0, launch only K_WINDOW (one launch a
    run_until call) and print the summary it writes.  Returns the CLI's
    result
    (state, summary, loop seconds), plus the printed summary line, the
    heartbeat.csv bytes, the wall seconds and the launches."""
    import contextlib
    import io
    import torch
    from shadow1_tpu_torch import cli
    from shadow1_tpu_torch.core import megakernel as mk
    args = cli._parser().parse_args(["run", *argv])
    out = io.StringIO()
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), RunCalls() as calls:
        rc, res = cli.run_config(args)
    if res is None:
        _fail(f"{label}: exit code {rc} and no run")
    res["wall"] = time.perf_counter() - t0
    res["launches"] = dict(mk.LAUNCHES)
    res["rc"] = rc
    res["line"] = json.loads(out.getvalue().strip().splitlines()[-1])
    with open(Path(args.data_directory) / "heartbeat.csv", "rb") as f:
        res["heartbeat"] = f.read()
    with open(Path(args.data_directory) / "summary.json") as f:
        res["summary_json"] = json.load(f)
    st = res["state"]
    res["run_calls"] = calls.n
    if res["launches"]["window"] != calls.n or \
            any(res["launches"][k] for k in PER_PHASE):
        _fail(f"{label}: launches {res['launches']} for {calls.n} run_until "
              f"calls ({int(st.n_windows)} windows): want one K_WINDOW "
              f"launch a run_until call and nothing else")
    line = dict(res["summary_json"])
    line.pop("object_census")
    if line != res["line"]:
        _fail(f"{label}: the printed summary {res['line']} is not "
              f"summary.json's {res['summary_json']}")
    return res


def check_cli_constants(res: dict, name: str, label: str) -> str:
    """The CLI run `res` against JAX_CLI[name]: exit code, heartbeat.csv's
    sha256 and summary.json without wall_seconds."""
    import hashlib
    want = JAX_CLI[name]
    got_sum = dict(res["summary_json"])
    got_sum.pop("wall_seconds")
    sha = hashlib.sha256(res["heartbeat"]).hexdigest()
    if res["rc"] != want["rc"] or sha != want["heartbeat_sha256"] or \
            got_sum != want["summary"]:
        _fail(f"{label}: rc {res['rc']}, heartbeat.csv sha256 {sha}, "
              f"summary {got_sum} != the JAX CLI's {want}")
    st = res["state"]
    return (f"{label}: heartbeat.csv ({res['heartbeat'].count(10) - 1} "
            f"rows, sha256 {sha[:16]}...) and summary.json equal to the JAX "
            f"CLI's; {int(st.n_windows)} windows, {int(st.n_steps)} "
            f"micro-steps, {int(st.n_events)} events, launches "
            f"{res['launches']}, wall {res['wall']:.4f} s (run loop "
            f"{res['loop_seconds']:.4f} s); summary {got_sum}")


def cli_schedule(state, params, app, t_end: int):
    """The CLI's launches (run_chunked to each heartbeat second, as
    cli.simulate with the default heartbeat) from `state` to t_end."""
    from shadow1_tpu_torch import cli
    from shadow1_tpu_torch.core import engine
    while int(state.now) < t_end:
        state = engine.run_chunked(state, params, app,
                                   cli.next_sync(state.now, t_end, SEC))
    return state


def cli_designs(argv, label: str, jax_key: str, name: str,
                tmp: str) -> tuple:
    """run_cli on `argv(data directory)` twice: by the world's shape (the
    main path, which must take the resident kernel at every launch) and
    with the warp design forced (which must take it at every launch),
    each held to JAX_CLI[jax_key].  Returns (the main run's result, lines,
    {row: launches}: `name` the warp design's, res_row(name) the resident
    kernel's)."""
    from shadow1_tpu_torch.core import megakernel as mk
    lines, launches, out = [], {}, None
    for resident in (None, False):
        lab = label if resident is None else f"{label}, warp design forced"
        mk.set_window_tgen_resident(resident)
        try:
            res = run_cli(argv(f"{tmp}/{'main' if resident is None else 'warp'}"),
                          lab)
        finally:
            mk.set_window_tgen_resident(None)
        want = {"resident": 0, "warp": 0}
        want["warp" if resident is False else "resident"] = \
            res["launches"]["window"]
        if mk.TGEN_LAUNCHES != want:
            _fail(f"{lab}: K_WINDOW's tgen launches by design "
                  f"{mk.TGEN_LAUNCHES}, want {want}")
        lines.append(check_cli_constants(res, jax_key, lab))
        lines.append(
            f"{lab}: wall {res['wall']:.4f} s (run loop "
            f"{res['loop_seconds']:.4f} s), launches {res['launches']} for "
            f"{res['run_calls']} run_until calls, {int(res['state'].n_windows)}"
            f" windows")
        launches[name if resident is False else res_row(name)] = \
            res["launches"]["window"]
        if resident is None:
            out = res
    return out, lines, launches


def cli_100host(dev, smi: str) -> tuple:
    """Phase 16, the main path: examples/tgen-100host through the CLI to
    its 120 s on the persistent path (the resident kernel), counters
    zeroed just before and read just after: heartbeat.csv and
    summary.json equal the JAX CLI's; wall, events/s, windows and
    launches; the same with the warp design forced (cli_designs).  The
    same schedule (cli.simulate with a heartbeat tracker) on the
    per-phase path ends in the same state, leaf for leaf, with the same
    heartbeat file.  Then the run again with CUDA events around each
    K_WINDOW call (one a run_until call): device ms per launch and per
    window and the device's busy share.  Then the launch (heartbeat
    second) from CLI_PROBE_S: each design's device time on its input
    (the state the CLI's schedule reaches there), its windows' bound, and
    its busiest window -- its windows run one a call with CUDA events --
    each design against window_plain over it (check_window).  Returns
    (the main path's device ms per window, {row: check_window's (times,
    bound, max error)} at that window, {row: launches on the CLI's main
    path})."""
    import tempfile
    import torch
    from shadow1_tpu_torch import cli
    from shadow1_tpu_torch.config import assemble
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    from shadow1_tpu_torch.observe import Tracker
    config = str(Path(__file__).resolve().parent / CLI_100HOST)
    label = "cli: tgen-100host main path (persistent)"
    with tempfile.TemporaryDirectory() as tmp:
        main, lines, launches = cli_designs(
            lambda d: [config, "--data-directory", d, "--quiet"], label,
            "tgen-100host", "window_tgen_cli", tmp)
        for line in lines:
            print(line, flush=True)
        st, stop = main["state"], int(main["summary"]["simulated_seconds"])
        print(
            f"{label} 0 -> {stop} s on {smi}: wall {main['wall']:.4f} s (run "
            f"loop {main['loop_seconds']:.4f} s), {int(st.n_events)} "
            f"events, {int(st.n_events) / main['loop_seconds']:.1f} events/s "
            f"of the run loop, {int(st.n_windows)} windows, "
            f"{int(st.n_steps)} micro-steps, launches {main['launches']}",
            flush=True)
        asm = assemble.load(config, persistent=False, device=dev)
        tr = Tracker(f"{tmp}/pp", asm.hostnames)
        t0 = time.perf_counter()
        pp, _t = cli.simulate(asm.state, asm.params, asm.app, stop * SEC, tr)
        wall_pp = time.perf_counter() - t0
        require_equal(pp, st, "tgen-100host: per-phase vs persistent path")
        if Path(tr.path).read_bytes() != main["heartbeat"]:
            _fail("tgen-100host: the per-phase path's heartbeat.csv differs")
        print(
            f"cli: tgen-100host per-phase path 0 -> {stop} s "
            f"({wall_pp:.4f} s): final state equal to the persistent path's, "
            f"leaf for leaf, and the same heartbeat.csv", flush=True)
        del pp, asm
        # The main path's schedule again, CUDA events around each K_WINDOW
        # call (megakernel.window_call wrapped); each call's windows and
        # micro-steps after it are kept on the card.
        call, marks, rows = mk.window_call, [], []

        def timed(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = call(*a)
            e1.record()
            marks.append((e0, e1))
            rows.append(torch.stack([out[0].n_windows, out[0].n_steps,
                                     out[2][1]]))
            return out
        asm = assemble.load(config, device=dev)
        tr = Tracker(f"{tmp}/busy", asm.hostnames)
        torch.cuda.synchronize()
        mk.window_call = timed
        try:
            t0 = time.perf_counter()
            again, _t = cli.simulate(asm.state, asm.params, asm.app,
                                     stop * SEC, tr)
            wall = time.perf_counter() - t0
        finally:
            mk.window_call = call
        if Path(tr.path).read_bytes() != main["heartbeat"]:
            _fail("tgen-100host: the timed run's heartbeat.csv differs")
        ms = [e0.elapsed_time(e1) for e0, e1 in marks]
        steps, windows = int(again.n_steps), int(again.n_windows)
        print(
            f"{label} again with CUDA events: {len(ms)} launches, {windows} "
            f"windows, wall {wall:.4f} s, k_window_tgen_res device "
            f"{sum(ms):.4f} ms ({statistics.mean(ms):.4f} ms a launch, max "
            f"{max(ms):.4f}), {sum(ms) / windows:.4f} ms per window, "
            f"{sum(ms) / steps:.4f} ms per micro-step; device busy "
            f"{100 * sum(ms) / 1e3 / wall:.1f} %", flush=True)
    rows = torch.stack(rows).tolist()
    n_win = [r[0] - (rows[k - 1][0] if k else 0) for k, r in enumerate(rows)]
    n_st = [r[1] - (rows[k - 1][1] if k else 0) for k, r in enumerate(rows)]
    top = sorted(range(len(ms)), key=lambda k: -ms[k])[:4]
    print("cli: tgen-100host main path, its busiest launches: " + "; ".join(
        f"to {rows[k][2] // SEC + 1} s: {n_win[k]} windows, {n_st[k]} "
        f"micro-steps, {ms[k]:.4f} ms device" for k in top), flush=True)
    # The launch (heartbeat second) CLI_PROBE_S -> +1 s, from the state
    # the CLI's schedule reaches: each design on it, its windows' bound,
    # and its busiest window, each design against window_plain there.
    sec0 = CLI_PROBE_S * SEC
    hb = cli.next_sync(sec0, stop * SEC, SEC)
    params, app = asm.params, asm.app
    at_sec = cli_schedule(asm.state, params, app, sec0)
    cap = -(-(hb - sec0) // params.min_latency_ns)
    launch_ms = {}
    for resident, kernel, _tag in TGEN_DESIGNS:
        with tgen_design(resident):
            launch_ms[kernel] = time_call(
                mk.window_kernel, lambda: (engine.clone_state(at_sec), params,
                                           app, hb, cap), kernel=kernel)[0]
    b, ops, s_b = windows_bound(at_sec, params, app, 0, until=hb)
    # Its windows one a call, on the main path's design.
    st, w_ms, starts = engine.clone_state(at_sec), [], []
    while int(st.now) < hb:
        before = engine.clone_state(st)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        st, _t_h, win = mk.window_call(st, params, app, hb, 1)
        e1.record()
        torch.cuda.synchronize()
        starts.append(before)
        w_ms.append(e0.elapsed_time(e1))
        if min(int(win[0]), int(win[3])) >= hb:
            break
    if int(st.n_steps) - int(at_sec.n_steps) != s_b:
        _fail(f"tgen-100host: the bound's replay of {sec0} -> {hb} ns ran "
              f"{s_b} micro-steps, the windows one a call "
              f"{int(st.n_steps) - int(at_sec.n_steps)}")
    n_w = len(w_ms)
    print(
        f"cli: tgen-100host main path, the launch {sec0 // SEC} -> "
        f"{hb // SEC} s on the same input: {n_w} windows ({s_b} micro-steps);"
        f" device " + ", ".join(f"{k} {v:.4f} ms ({v / n_w:.4f} ms a window)"
                                for k, v in launch_ms.items()) +
        f"; resident / warp {launch_ms['k_window_tgen_res'] / launch_ms['k_window_tgen']:.3f}; "
        f"they must move {b} bytes and do {ops} operations: bound "
        f"{bound_ms(b, ops) / n_w:.6f} ms a window", flush=True)
    top = max(range(n_w), key=w_ms.__getitem__)
    probe = starts[top]
    print(
        f"cli: tgen-100host main path, its busiest window there: window "
        f"{top} of {n_w}, from {int(probe.now)} ns, device {w_ms[top]:.4f} "
        f"ms (one a call, CUDA events)", flush=True)
    checks, prev = {}, None
    for resident, kernel, _tag in TGEN_DESIGNS:
        with tgen_design(resident):
            prev = check_window(
                probe, params, app, advance=0,
                label=f"cli: tgen-100host kernels: {kernel}, window at "
                      f"{int(probe.now) / SEC:.4f} s", kernel=kernel,
                plain_reps=1, until=hb, reuse=prev)
        checks[res_row("window_tgen_cli") if resident
               else "window_tgen_cli"] = prev
    # That window again on the resident kernel after a smaller world's
    # launch in this process: the kernel's dynamic shared-memory limit is
    # the function's, lowered by the smaller record's occupancy query (a
    # new query, as in a fresh process) and launch, so the launch must
    # raise it again.
    from shadow1_tpu_torch import sim
    mk._RES_OCCUPANCY.clear()
    s4, p4, a4 = sim.build_tgen(4, device=dev)
    n_res = mk.TGEN_LAUNCHES["resident"]
    small = engine.run_until(s4, p4, a4, 5 * SEC + 200 * MS)  # clients at 5 s
    with tgen_design(True):
        again = mk.window_kernel(engine.clone_state(probe), params, app, hb,
                                 1)
    if mk.TGEN_LAUNCHES["resident"] - n_res != 2:
        _fail(f"tgen-100host after a 4-host world: resident launches "
              f"{mk.TGEN_LAUNCHES['resident'] - n_res}, want 2")
    require_equal(again, mk.window_plain(engine.clone_state(probe), params,
                                         app, hb, 1),
                  "tgen-100host's window after a 4-host world's launch")
    print(f"cli: tgen-100host kernels: k_window_tgen_res, the window at "
          f"{int(probe.now) / SEC:.4f} s ({mk.tgen_record_bytes(probe, app)}"
          f"-byte record) right after a 4-host world's launch "
          f"({mk.tgen_record_bytes(small, a4)}-byte record) in this "
          f"process: equal to window_plain", flush=True)
    return sum(ms) / windows, checks, launches


# ---------------------------------------------------------------------------
# CUBIC and interface buffers (phases 18-21), APSP on the card (phase 22)
# ---------------------------------------------------------------------------


def buffered(params):
    """stressed(params) with interface buffers: host i unbounded where
    i % 3 == 0, else bounded at 1 + i % 4 packets."""
    import torch
    h = params.iface_buf_pkts.shape[0]
    cap = torch.tensor([0 if i % 3 == 0 else 1 + i % 4 for i in range(h)],
                       dtype=torch.int32)
    return stressed(params).replace(
        iface_buf_pkts=cap.to(params.iface_buf_pkts.device),
        has_iface_buf=True)


def cubic(params):
    return params.replace(cong="cubic")


def lossy_buffered(params):
    """LOSSY's interface buffers: the server (host 0) bounded at 24
    packets, every fourth client unbounded, the others at 2 + i % 3; the
    PDS trail on."""
    import torch
    h = params.iface_buf_pkts.shape[0]
    cap = torch.tensor([24 if i == 0 else 0 if i % 4 == 3 else 2 + i % 3
                        for i in range(h)], dtype=torch.int32)
    return params.replace(iface_buf_pkts=cap.to(params.iface_buf_pkts.device),
                          has_iface_buf=True, pds_trail=True)


def unbuffered(params):
    return params.replace(iface_buf_pkts=params.iface_buf_pkts * 0,
                          has_iface_buf=False)


def router_drops(before, after) -> int:
    return int((after.hosts.pkts_dropped_router
                - before.hosts.pkts_dropped_router).sum())


def cubic_moves(before, after) -> int:
    """Sockets whose CUBIC state moved from `before` to `after`: an epoch
    or Wmax set or reset (a fresh epoch, a fast recovery, an RTO), or a
    window that grew in congestion avoidance within a running epoch."""
    b, a = before.socks, after.socks
    reset = (b.cub_epoch != a.cub_epoch) | (b.cub_wmax != a.cub_wmax)
    grew = (b.cub_epoch != 0) & (a.cub_epoch == b.cub_epoch) & \
        (b.cwnd >= b.ssthresh) & (a.cwnd != b.cwnd)
    return int((reset | grew).sum())


def cubic_registers(seed: int, n: int = CUBIC_REGS) -> dict:
    """n sockets' registers for CUBIC's target and hooks (numpy, seeded):
    cwnd from one segment to the SND_BUF_MAX cap, below and above
    ssthresh and cub_wmax; fresh (0) and running epochs, some long enough
    to hit the target's clamp; srtt 0 or up to 2 s; per-ACK byte counts
    whose step quotient passes 2^31; a mask on 80 % of them."""
    import numpy as np
    mss = 1460
    rng = np.random.default_rng(seed)
    tick = rng.integers(0, 600 * SEC, n, dtype=np.int64)
    span = np.exp(rng.uniform(np.log(1.0), np.log(3600.0 * SEC), n))
    epoch = np.where(rng.random(n) < 0.2, 0, tick - span.astype(np.int64))
    cwnd = np.exp(rng.uniform(np.log(mss), np.log(4 << 20), n))
    cwnd = cwnd.astype(np.int32)
    wmax = (cwnd * rng.uniform(0.3, 3.0, n)).astype(np.int32)
    wmax = np.where(rng.random(n) < 0.2, 0, wmax).astype(np.int32)
    ssth = (cwnd * rng.uniform(0.5, 2.0, n)).astype(np.int32)
    ssth = np.where(rng.random(n) < 0.1, 1 << 30, ssth).astype(np.int32)
    srtt = np.exp(rng.uniform(0, np.log(2.0 * SEC), n)).astype(np.int64)
    srtt = np.where(rng.random(n) < 0.1, 0, srtt)
    acked = np.exp(rng.uniform(0, np.log(4 << 20), n)).astype(np.int32)
    return dict(cwnd=cwnd, ssthresh=ssth, cub_epoch=epoch, cub_wmax=wmax,
                srtt=srtt, tick=tick, acked=acked,
                flight=(cwnd * rng.uniform(0, 1.5, n)).astype(np.int32),
                mask=rng.random(n) < 0.8)


def cubic_edges() -> dict:
    """Registers at the edges: cub_epoch = 0, cub_wmax = 0, srtt = 0,
    epochs long enough to hit the clamp, cwnd below and above cub_wmax,
    the largest per-ACK byte counts."""
    import numpy as np
    mss = 1460
    cwnd = np.array([mss, 2 * mss, 10 * mss, 4 << 20, 44970, 44970, 3000,
                     3000, 1 << 20, 1 << 20], np.int32)
    n = cwnd.size
    return dict(
        cwnd=cwnd, ssthresh=np.full(n, 2 * mss, np.int32),
        cub_epoch=np.array([0, 0, 5 * SEC, 0, 1, 10**15, 0, 7, 0, 0],
                           np.int64),
        cub_wmax=np.array([0, 100_000, 0, 1 << 30, 44970, 60_000, 0, 1, 0,
                           2_000_000], np.int32),
        srtt=np.array([0, 0, 1, 2 * SEC, 0, 10**9, 40 * MS, 0, 0, 1],
                      np.int64),
        tick=np.array([0, SEC, 5 * SEC, 3600 * SEC, 2, 10**15 + 10**14,
                       SEC, 7, 10**18, 3 * SEC], np.int64),
        acked=np.array([mss, 1, 1 << 20, 4 << 20, mss, 2 * mss, 1,
                        2**31 - 1, 1, 4 << 20], np.int32),
        flight=cwnd.copy(), mask=np.ones(n, bool))


CUBIC_FIELDS = ("cwnd", "ssthresh", "cub_epoch", "cub_wmax", "srtt")


def cubic_plain(kind: str, regs: dict):
    """transport/cong.py's CUBIC target or hook `kind` (megakernel
    CONG_PROBE_KINDS) on torch registers, as megakernel.cong_probe
    returns them."""
    import torch
    from shadow1_tpu_torch.transport import cong, tcp

    class View:
        setwhere = tcp._Sock.setwhere
    v = View()
    for f in CUBIC_FIELDS:
        setattr(v, f, regs[f].clone())
    mask, tick = regs["mask"], regs["tick"]
    if kind == "target":
        return cong._cubic_target(v, tick)
    if kind == "new_ack":
        cong._cubic_new_ack(v, mask, torch.where(mask, regs["acked"], 0),
                            tick)
    elif kind == "enter_recovery":
        cong._cubic_enter_recovery(v, mask, regs["flight"], tick)
    else:
        cong._cubic_timeout(v, mask, regs["flight"], tick)
    return {f: getattr(v, f) for f in CUBIC_FIELDS}


def check_cong_hooks(dev) -> str:
    """CUBIC's device window target and hooks (csrc/tcp.cuh, through the
    probe kernel) against cong.py's plain versions run on the card, on
    CUBIC_REGS seeded socket registers each plus cubic_edges(), bitwise;
    every regime of the target must occur."""
    import numpy as np
    import torch
    from shadow1_tpu_torch.core import megakernel as mk
    out = []
    for seed, kind in enumerate(mk.CONG_PROBE_KINDS):
        regs = {k: torch.from_numpy(np.concatenate([a, cubic_edges()[k]]))
                .to(dev) for k, a in cubic_registers(seed).items()}
        got, want = mk.cong_probe(kind, regs), cubic_plain(kind, regs)
        if kind == "target":
            bad = int((got != want).sum())
            lo, hi = int((want == 2 * 1460).sum()), \
                int((want == 4194304).sum())
            if bad or not lo or not hi:
                _fail(f"CUBIC's device target differs from cong.py on "
                      f"{bad} registers (clamped low {lo}, high {hi})")
            out.append(f"target ({lo} clamped low, {hi} high)")
            continue
        bad = {f: int((got[f] != want[f]).sum()) for f in CUBIC_FIELDS}
        if any(bad.values()):
            _fail(f"CUBIC's device {kind} hook differs from cong.py: "
                  f"{bad}")
        moved = int((want["cwnd"] != regs["cwnd"]).sum())
        out.append(f"{kind} ({moved} windows moved)")
    n = CUBIC_REGS + len(cubic_edges()["cwnd"])
    return (f"cubic: the device CUBIC target and hooks (tcp.cuh) equal "
            f"cong.py's on the card, bitwise, on {n} registers each: "
            + ", ".join(out))


def check_cbrt(dev) -> str:
    """csrc/xla_cbrt.cuh cbrt_xla (the probe kernel) against xlamath.cbrt
    run on the card, on every non-negative f32 bit pattern (2^31, in
    chunks of 2^27)."""
    import torch
    from shadow1_tpu_torch.core import xlamath
    from shadow1_tpu_torch.core import megakernel as mk
    bad, t0 = 0, time.perf_counter()
    for lo in range(0, 1 << 31, 1 << 27):
        x = torch.arange(lo, lo + (1 << 27), dtype=torch.int64,
                         device=dev).to(torch.int32).view(torch.float32)
        bad += int((mk.cbrt_probe(x).view(torch.int32)
                    != xlamath.cbrt(x).view(torch.int32)).sum())
    if bad:
        _fail(f"f32 cbrt: the device cbrt_xla and xlamath.cbrt differ on "
              f"{bad} of the 2^31 non-negative f32 values")
    return (f"cubic: the device f32 cbrt (cbrt_xla) equals xlamath.cbrt on "
            f"the card on all 2^31 non-negative f32 values "
            f"({time.perf_counter() - t0:.1f} s)")


def run_both_paths(dev, build, kw, tweak, t_end, want, summarize,
                   label: str):
    """`build(**kw)` with `tweak` on its params to t_end on the persistent
    path (K_WINDOW) and on the per-phase path, every launch counter zeroed
    just before each and read just after: each path launches only its
    kernels, its trajectory (summarize) equals the JAX package's `want`,
    and the two final states are equal leaf for leaf.  Returns (the
    per-phase final state, {path: launches}, printable line)."""
    import torch
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    finals, launches, walls = {}, {}, {}
    for path, persist, kinds in (("persistent", True, {"window"}),
                                 ("per-phase", False, set(PER_PHASE))):
        s0, p0, a0 = build(**kw, persistent=persist, device=dev)
        p0 = tweak(p0)
        torch.cuda.synchronize()
        mk.reset_launches()
        t0 = time.perf_counter()
        finals[path] = engine.run_until(s0, p0, a0, t_end)
        torch.cuda.synchronize()
        walls[path] = time.perf_counter() - t0
        launches[path] = dict(mk.LAUNCHES)
        if {k for k, v in launches[path].items() if v} != kinds:
            _fail(f"{label}, {path} path: launches {launches[path]}")
        got = summarize(finals[path])
        if got != want:
            _fail(f"{label}, {path} path: trajectory {got} != the JAX "
                  f"package's {want}")
    require_equal(finals["persistent"], finals["per-phase"],
                  f"{label}: persistent vs per-phase path")
    return finals["per-phase"], launches, (
        f"{label}: both paths equal to the JAX package's trajectory {want} "
        f"and to each other, leaf for leaf; persistent "
        f"{walls['persistent']:.4f} s, launches {launches['persistent']}; "
        f"per-phase {walls['per-phase']:.4f} s, launches "
        f"{launches['per-phase']}")


def deliver_probe(state, params, app, dev, alt, label: str):
    """K_DELIVER against deliver_plain at every micro-step of the window
    that `state` (a window boundary) opens, torch.equal on every output;
    the micro-step with the most tail drops (then deliveries) is timed --
    the kernel, its plain version, and the kernel on the same inputs
    under `alt` (the other instantiation: Reno, or no buffer) -- and
    bounded.  In a buffered world the window must tail-drop.  Returns
    ((times, bound, max error), alt device ms, line)."""
    from shadow1_tpu_torch.core import emit, engine
    from shadow1_tpu_torch.core import megakernel as mk
    clone = engine.clone_state
    h = state.hosts.num_hosts
    tcp = engine._uses_tcp(app)
    path = mk.deliver_path(state, params, app)
    kernel = DELIVER_KERNELS[path]
    ctx = engine._window_ctx(state, params)
    lanes = engine._n_lanes(app)
    st = engine._exchange(clone(state), params, fused=True)
    t_h, gmin = engine._scan_all(st, params, app)
    we = min(max(int(st.now), int(gmin)) + params.min_latency_ns,
             params.stop_time)
    steps, best, err, drops, dels = 0, None, 0.0, 0, 0
    while int(gmin) < we:
        s1, active, tick_t = engine._tick_setup(clone(st), t_h, we)
        aux0 = engine._aux_times(s1, params, app) if app.rx_batch > 1 \
            else None

        def args(s=s1, act=active, tk=tick_t, a0=aux0, p=params):
            return (clone(s), p, app,
                    emit.empty(h, lanes, s.pool.blk.shape[1], dev), tk, act,
                    we, ctx[1], a0)
        out_k = mk.deliver_kernel(*args())
        out_p = mk.deliver_plain(*args())
        err = max(err, require_equal(out_k, out_p,
                                     f"{label}: micro-step {steps}"))
        d = int((out_p[0].hosts.pkts_dropped_router
                 - s1.hosts.pkts_dropped_router).sum())
        n = int(out_p[2].sum())
        drops, dels = drops + d, dels + n
        if best is None or (d, n) > best[0]:
            best = ((d, n), args, s1, out_p, active)
        st, t_h, gmin = mk.microstep_fused(st, params, app, t_h, we, ctx)
        steps += 1
    if best is None:
        _fail(f"{label}: the window has no micro-step")
    if params.has_iface_buf and drops == 0:
        _fail(f"{label}: no tail drop in the window from {int(state.now)} ns")
    (d, n), args, s1, (s2, em, dn, _tp), active = best
    bound = (deliver_bytes(s1, s2, dn, active, app, em if tcp else None),
             deliver_ops(s1, dn, active, app, tcp))
    times = (time_call(mk.deliver_kernel, args, kernel=kernel),
             time_call(mk.deliver_plain, args))
    alt_ms = time_call(mk.deliver_kernel, lambda: args(p=alt),
                       kernel=kernel)[0]
    (kd, kc), (pd, pc) = times
    return (times, bound, err), alt_ms, (
        f"{label} ({path} path, {kernel}): equal at all {steps} micro-steps "
        f"of the window from {int(state.now)} ns ({dels} deliveries, "
        f"{drops} router drops); at its busiest ({n} deliveries, {d} "
        f"drops) kernel device {kd:.4f} ms (call {kc:.4f} ms), the other "
        f"instantiation on the same inputs {alt_ms:.4f} ms, plain device "
        f"{pd:.4f} ms (call {pc:.4f} ms), bound {bound[0]} bytes, "
        f"{bound[1]} operations ({bound_ms(*bound):.6f} ms)")


def window_probe(state, params, app, alt, label: str, kernel: str,
                 until: int, reuse=None):
    """check_window over the window `state` opens (to `until`; `reuse` as
    there), and the kernel on the same inputs under `alt`.  Returns
    ((times, bound, max error), alt device ms, line)."""
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    check = check_window(state, params, app, advance=0, label=label,
                         kernel=kernel, plain_reps=1, until=until,
                         reuse=reuse)
    alt = alt.replace(persistent=True)

    def args():
        return engine.clone_state(state), alt, app, until, 1
    alt_ms = time_call(mk.window_kernel, args, kernel=kernel)[0]
    return check, alt_ms, (f"{label}: the other instantiation on the same "
                           f"inputs {alt_ms:.4f} ms device")


def record_line(state, app, label: str) -> str:
    """The resident kernel's record of one host for a world: its dynamic
    shared memory (megakernel.tgen_record_bytes; the launch refuses any
    other size)."""
    from shadow1_tpu_torch.core import megakernel as mk
    from shadow1_tpu_torch.core import engine
    h = state.hosts.num_hosts
    return (f"tgen kernels: the resident kernel's record for {label} "
            f"({h} hosts, {state.socks.slots} sockets, "
            f"{state.inbox.stage.shape[0] // h}-slot slabs, "
            f"{engine._n_lanes(app)} lanes of {state.pool.blk.shape[1]} "
            f"columns): {mk.tgen_record_bytes(state, app)} bytes of dynamic "
            f"shared memory a block")


def tgen_probes(state, params, app, alt, label: str, name: str,
                until: int, rows: dict, others: dict, lines: list) -> None:
    """window_probe over the window `state` opens, for each tgen design on
    the same inputs (TGEN_DESIGNS): into rows / others[name] the warp
    design's, into [res_row(name)] the resident kernel's; their lines
    into `lines`."""
    prev = None
    for resident, kernel, _tag in TGEN_DESIGNS:
        row = res_row(name) if resident else name
        with tgen_design(resident):
            rows[row], others[row], line = window_probe(
                state, params, app, alt, f"{label}, {kernel}", kernel, until,
                reuse=prev)
        prev = rows[row]
        lines.append(line)


def pick_window(state, params, app, t_end: int, score, max_steps: int):
    """The windows from `state` (a window boundary) to t_end, one
    window_call each on clones: (the state at the start of the window with
    the highest score(before, after) among those of at most `max_steps`
    micro-steps and at least one, its score); (None, None) if there is
    none."""
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk
    params = params.replace(persistent=True)
    best, best_score = None, None
    st = state
    while int(st.now) < t_end:
        before = engine.clone_state(st)
        st, _t_h, win = mk.window_call(engine.clone_state(st), params, app,
                                       t_end, 1)
        n = int(st.n_steps) - int(before.n_steps)
        sc = score(before, st)
        if 0 < n <= max_steps and (best_score is None or sc > best_score):
            best, best_score = before, sc
        if min(int(win[0]), int(win[3])) >= t_end:
            break
    return best, best_score


def random_graphml(v: int, seed: int = 7, island: int = 8) -> str:
    """A GraphML text of v vertices: 0..v-island-1 connected (a random
    spanning tree, chords and multi-edges), the last `island` a component
    of their own, six self-loops; random latencies (ms, three decimals),
    jitter, edge and vertex loss (tests/test_torch_config.py's
    _random_graphml, with IPs for any v)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    keys = [("ip", "node"), ("packetloss", "node"), ("latency", "edge"),
            ("jitter", "edge"), ("packetloss", "edge")]
    out = ['<graphml xmlns="http://graphml.graphdrawing.org/xmlns">']
    for n, (name, dom) in enumerate(keys):
        out.append(f'<key id="k{n}" for="{dom}" attr.name="{name}"/>')
    out.append('<graph edgedefault="undirected">')
    for i in range(v):
        loss = rng.choice([0.0, 0.0, 0.001, 0.02])
        out.append(f'<node id="n{i}"><data key="k0">11.{i // 256}.{i % 256}'
                   f'.1</data><data key="k1">{loss}</data></node>')

    def edge(a, b):
        lat = round(float(rng.uniform(0.5, 120.0)), 3)
        jit = round(float(rng.choice([0.0, rng.uniform(0.0, 30.0)])), 3)
        loss = float(rng.choice([0.0, 0.0, 0.005, 0.05]))
        out.append(f'<edge source="n{a}" target="n{b}">'
                   f'<data key="k2">{lat}</data><data key="k3">{jit}</data>'
                   f'<data key="k4">{loss}</data></edge>')

    core = v - island
    for i in range(1, core):
        edge(int(rng.integers(0, i)), i)
    for _ in range(2 * core):
        edge(*rng.integers(0, core, 2).tolist())
    for i in range(core + 1, v):
        edge(int(rng.integers(core, i)), i)
    for i in rng.choice(v, 6, replace=False).tolist():
        edge(i, i)
    out.append("</graph></graphml>")
    return "\n".join(out)


def check_apsp(dev) -> str:
    """routing/apsp.py build_matrices on the card against its CPU result
    on random_graphml(APSP_V): the path config/assemble.py sends to the
    device above 1,024 vertices.  Bitwise, every matrix."""
    import torch
    from shadow1_tpu_torch.routing import apsp, graphml
    topo = graphml.load(random_graphml(APSP_V))
    args = (topo.lat_ms, topo.edge_rel)
    kw = dict(self_lat_ms=topo.self_lat_ms, self_rel=topo.self_rel,
              edge_jitter_ms=topo.jitter_ms,
              self_jitter_ms=topo.self_jitter_ms)
    t0 = time.perf_counter()
    cpu = apsp.build_matrices(*args, **kw)
    t1 = time.perf_counter()
    gpu = apsp.build_matrices(*args, **kw, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for c, g, name in zip(cpu, gpu, ("latency", "reliability", "jitter")):
        g = g.cpu()
        if c.dtype != g.dtype or c.shape != g.shape or \
                not torch.equal(c.view(torch.int64 if c.element_size() == 8
                                       else torch.int32),
                                g.view(torch.int64 if g.element_size() == 8
                                       else torch.int32)):
            _fail(f"APSP on the card: the {name} matrix differs from the "
                  f"CPU's ({APSP_V} vertices)")
    routable = apsp.is_routable(cpu[0])
    core = APSP_V - 8
    if bool(routable.all()) or not bool(routable[:core, :core].all()):
        _fail("APSP: the random graph's components are not as built")
    return (f"apsp: build_matrices on the card equals the CPU's, bitwise, "
            f"on a random GraphML of {APSP_V} vertices (latency, "
            f"reliability, jitter); CPU {t1 - t0:.2f} s, card "
            f"{t2 - t1:.2f} s")


def pick_cli_window(state, params, app, seconds, score, good):
    """The CLI's schedule (cli_schedule) from `state` (the config's start)
    to each heartbeat second s of `seconds` in turn, and the best window
    (pick_window, at most PROBE_MAX_STEPS micro-steps) of the launch
    s -> s + 1: the first whose score passes `good`.  Returns (the
    window's start state, its score, s), or Nones."""
    at = state
    for sec in seconds:
        if int(at.now) > sec * SEC:
            at = state
        at = cli_schedule(at, params, app, sec * SEC)
        win, sc = pick_window(at, params, app, (sec + 1) * SEC, score,
                              PROBE_MAX_STEPS)
        if win is not None and good(sc):
            return win, sc, sec
    return None, None, None


def moves_and_drops(before, after) -> tuple:
    """A buffered CUBIC probe window's score: windows that both move
    CUBIC's state and tail-drop first, then by CUBIC moves and drops."""
    m, d = cubic_moves(before, after), router_drops(before, after)
    return (min(m, 1) + min(d, 1), m, d)


def cubic_kernels(dev) -> tuple:
    """Phase 18: the device cbrt, CUBIC's device target and hooks, LOSSY
    with CUBIC on both paths against JAX_LOSSY_CUBIC, and its CUBIC
    instantiations of k_deliver_tcp and k_window_tcp against their plain
    versions over the window that moves CUBIC's state on the most sockets
    (cubic_moves) among the BUF_WINDOWS from LOSSY_CUBIC_PROBE_NS, each
    timed beside the Reno instantiation on the same inputs.  Returns
    (printable lines, {row: (times, bound, err)}, {row: launches},
    {row: other ms})."""
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.core import engine
    lines = [check_cbrt(dev), check_cong_hooks(dev)]
    _pp, launches, line = run_both_paths(
        dev, sim.build_bulk, LOSSY, cubic, LOSSY_CUBIC_NS, JAX_LOSSY_CUBIC,
        tcp_summary, f"cubic: LOSSY (H={LOSSY['num_hosts']}) to "
                     f"{LOSSY_CUBIC_NS // MS} ms with CUBIC")
    lines.append(line)
    state, params, app = sim.build_bulk(**LOSSY, persistent=False,
                                        device=dev)
    params = cubic(params)
    state = engine.run_until(state, params, app, LOSSY_CUBIC_PROBE_NS)
    state, moves = pick_window(
        state, params, app,
        LOSSY_CUBIC_PROBE_NS + BUF_WINDOWS * params.min_latency_ns,
        cubic_moves, PROBE_MAX_STEPS)
    if not moves:
        _fail("cubic kernels: no window from LOSSY_CUBIC_PROBE_NS moves "
              "CUBIC's state")
    lines.append(f"cubic kernels: the LOSSY probe window from "
                 f"{int(state.now)} ns moves CUBIC's state on {moves} "
                 f"sockets")
    reno = params.replace(cong="reno")
    rows, alt = {}, {}
    rows["deliver_tcp_cubic"], alt["deliver_tcp_cubic"], line = \
        deliver_probe(state, params, app, dev, reno,
                      "cubic kernels: deliver (LOSSY, CUBIC)")
    lines.append(line)
    rows["window_tcp_cubic"], alt["window_tcp_cubic"], line = window_probe(
        state, params, app, reno, "cubic kernels: window (LOSSY, CUBIC)",
        "k_window_tcp", params.stop_time)
    lines.append(line)
    return lines, rows, {
        "deliver_tcp_cubic": launches["per-phase"]["deliver"],
        "window_tcp_cubic": launches["persistent"]["window"]}, alt


def cli_cubic(dev, root) -> tuple:
    """Phase 19, the main path of the slice: examples/tgen-100host with
    --tcp-congestion-control cubic through the CLI to its 120 s,
    counters zeroed just before and read just after: heartbeat.csv and
    summary.json equal the JAX CLI's.  Then the config on the persistent
    and the per-phase path, launch by launch as the CLI runs it, equal
    leaf for leaf at every heartbeat second from BURST_FROM_S to
    BURST_TO_S (the opening bursts), CUBIC's moves counted each second;
    and each tgen design (CUBIC) against window_plain over a window of at
    most PROBE_MAX_STEPS micro-steps that moves CUBIC's state, in the
    first launch from CLI_PROBE_S (else from 1 s) that has one, timed
    beside the Reno instantiation.  The CLI runs by shape (the resident
    kernel) and with the warp design forced (cli_designs).  Returns
    (lines, rows, launches, other ms), by row."""
    import tempfile
    from shadow1_tpu_torch.config import assemble
    from shadow1_tpu_torch.core import engine
    config = str(root / CLI_100HOST)
    label = "cli: tgen-100host with CUBIC, the main path"
    with tempfile.TemporaryDirectory() as tmp:
        res, lines, launches = cli_designs(
            lambda d: [config, "--data-directory", d, "--quiet",
                       "--tcp-congestion-control", "cubic"], label,
            "tgen-100host-cubic", "window_tgen_cubic", tmp)
    st = res["state"]
    lines.append(
        f"{label}: {int(st.n_events) / res['loop_seconds']:.1f} events/s "
        f"of the run loop ({res['loop_seconds']:.4f} s), "
        f"{int(st.n_windows)} windows, {int(st.n_steps)} micro-steps")
    del res, st
    runs = {p: assemble.load(config, cong="cubic", persistent=p, device=dev)
            for p in (True, False)}
    states = {p: a.state for p, a in runs.items()}
    moves = {}
    t0 = time.perf_counter()
    for sec in range(1, BURST_TO_S + 1):
        before = states[True]
        for p, a in runs.items():
            states[p] = engine.run_chunked(states[p], a.params, a.app,
                                           sec * SEC)
        moves[sec] = cubic_moves(before, states[True])
        if sec >= BURST_FROM_S:
            try:
                require_equal(states[True], states[False],
                              f"at {sec} s")
            except SystemExit as e:
                _fail(f"tgen-100host with CUBIC: the persistent and the "
                      f"per-phase path differ at the heartbeat second "
                      f"{sec} s: {e}")
    lines.append(
        f"cli: tgen-100host with CUBIC: the persistent and the per-phase "
        f"path equal leaf for leaf at every heartbeat second from "
        f"{BURST_FROM_S} to {BURST_TO_S} s ({int(states[True].n_steps)} "
        f"micro-steps by then; {time.perf_counter() - t0:.1f} s); "
        f"sockets whose CUBIC state moved, by second: {moves}")
    del states
    a = runs[True]
    active = [s for s in range(1, BURST_TO_S) if moves[s + 1]]
    seconds = [s for s in active if s >= CLI_PROBE_S] + \
        [s for s in active if s < CLI_PROBE_S]
    win, sc, sec = pick_cli_window(
        a.state, a.params, a.app, seconds[:6],
        lambda b, e: (cubic_moves(b, e), int(e.n_steps) - int(b.n_steps)),
        lambda sc: sc[0] > 0)
    if win is None:
        _fail(f"tgen-100host with CUBIC: no window of at most "
              f"{PROBE_MAX_STEPS} micro-steps moves CUBIC's state in the "
              f"launches from {seconds[:6]} s")
    rows, alt = {}, {}
    tgen_probes(
        win, a.params, a.app, a.params.replace(cong="reno"),
        f"cli: tgen-100host (CUBIC) kernels: window at "
        f"{int(win.now) / SEC:.4f} s ({sc[0]} sockets' CUBIC state moves)",
        "window_tgen_cubic", (sec + 1) * SEC, rows, alt, lines)
    return lines, rows, launches, alt


def lossy_buf_kernels(dev) -> tuple:
    """Phase 20, TCP: LOSSY with interface buffers (lossy_buffered), under
    Reno and under CUBIC, on both paths to LOSSY_BUF_NS against
    JAX_LOSSY_BUF / JAX_LOSSY_CUBIC_BUF; then, among the BUF_WINDOWS
    windows from there, k_window_tcp<1,0> over the one with the most tail
    drops, and k_deliver_tcp<1,1> (every micro-step) and
    k_window_tcp<1,1> over one that tail-drops and moves CUBIC's state,
    against their plain versions, timed beside the unbuffered
    instantiation on the same inputs.  Returns as buf_kernels."""
    from shadow1_tpu_torch import sim

    def summarize(st):
        return dict(tcp_summary(st),
                    drops_router=int(st.hosts.pkts_dropped_router.sum()))
    lines, rows, alt, launches = [], {}, {}, {}
    for name, want in (("reno", JAX_LOSSY_BUF),
                       ("cubic", JAX_LOSSY_CUBIC_BUF)):
        def tweak(params, name=name):
            return lossy_buffered(params.replace(cong=name))
        label = (f"buffers: LOSSY (H={LOSSY['num_hosts']}) to "
                 f"{LOSSY_BUF_NS // MS} ms with interface buffers, {name}")
        pp, runs, line = run_both_paths(
            dev, sim.build_bulk, LOSSY, tweak, LOSSY_BUF_NS, want,
            summarize, label)
        lines.append(line)
        _s, params, app = sim.build_bulk(**LOSSY, persistent=False,
                                         device=dev)
        params = tweak(params)
        t_end = LOSSY_BUF_NS + BUF_WINDOWS * params.min_latency_ns
        if name == "cubic":
            state, sc = pick_window(pp, params, app, t_end,
                                    moves_and_drops, PROBE_MAX_STEPS)
            ok = sc is not None and sc[0] == 2
        else:
            state, sc = pick_window(
                pp, params, app, t_end,
                lambda b, e: (router_drops(b, e),
                              int(e.n_steps) - int(b.n_steps)),
                PROBE_MAX_STEPS)
            ok = sc is not None and sc[0] > 0
        if not ok:
            _fail(f"{label}: no probe window with tail drops"
                  f"{' that moves CUBIC' if name == 'cubic' else ''} ({sc})")
        lines.append(f"{label}: probe window from {int(state.now)} ns "
                     f"(score {sc})")
        unbuf = unbuffered(params)
        kind = "window_tcp_cubic_buf" if name == "cubic" else \
            "window_tcp_buf"
        if name == "cubic":
            rows["deliver_tcp_cubic_buf"], alt["deliver_tcp_cubic_buf"], \
                line = deliver_probe(
                    state, params, app, dev, unbuf,
                    "buffers kernels: deliver (LOSSY, buffered, CUBIC)")
            lines.append(line)
            launches["deliver_tcp_cubic_buf"] = runs["per-phase"]["deliver"]
        rows[kind], alt[kind], line = window_probe(
            state, params, app, unbuf,
            f"buffers kernels: window (LOSSY, buffered, {name})",
            "k_window_tcp", params.stop_time)
        lines.append(line)
        launches[kind] = runs["persistent"]["window"]
    return lines, rows, launches, alt


def buf_kernels(dev) -> tuple:
    """Phase 20: STRESS with interface buffers (buffered) on both paths
    against JAX_STRESS_BUF; its k_deliver_small and k_window (buffered)
    against their plain versions over the window with the most tail drops
    among the BUF_WINDOWS from BUF_PROBE_NS, and the KO world's k_deliver
    (deliver_host) the same way, each timed beside the unbuffered
    instantiation on the same inputs; then lossy_buf_kernels.  Returns
    (lines, {row: (times, bound, err)}, {row: launches}, {row: other
    ms})."""
    from shadow1_tpu_torch import sim
    from shadow1_tpu_torch.core import engine
    from shadow1_tpu_torch.core import megakernel as mk

    def summarize(st):
        return dict(summary(st),
                    drops_router=int(st.hosts.pkts_dropped_router.sum()))
    lines, rows, alt = [], {}, {}
    _pp, launches, line = run_both_paths(
        dev, sim.build_phold, STRESS, buffered, STRESS_NS, JAX_STRESS_BUF,
        summarize, f"buffers: STRESS (H={STRESS['num_hosts']}) to "
                   f"{STRESS_NS // MS} ms with interface buffers")
    lines.append(line)
    runs = {}
    for world, spec in (("STRESS", STRESS), ("KO", KO)):
        state, params, app = sim.build_phold(**spec, persistent=False,
                                             device=dev)
        params = buffered(params)
        mk.reset_launches()
        state = engine.run_until(state, params, app, BUF_PROBE_NS)
        runs[world] = dict(mk.LAUNCHES)
        # The window with the most tail drops among the next BUF_WINDOWS.
        state, _sc = pick_window(
            state, params, app,
            BUF_PROBE_NS + BUF_WINDOWS * params.min_latency_ns,
            router_drops, PROBE_MAX_STEPS)
        unbuf = unbuffered(params)
        path = mk.deliver_path(state, params, app)
        want = "small" if world == "STRESS" else "general"
        if path != want:
            _fail(f"buffers: the {world} world's K_DELIVER takes the "
                  f"{path} path, not {want}")
        name = "deliver_small_buf" if world == "STRESS" else "deliver_buf"
        rows[name], alt[name], line = deliver_probe(
            state, params, app, dev, unbuf,
            f"buffers kernels: deliver ({world}, buffered)")
        lines.append(line)
        if world == "STRESS":
            rows["window_buf"], alt["window_buf"], line = window_probe(
                state, params, app, unbuf,
                "buffers kernels: window (STRESS, buffered)", "k_window",
                params.stop_time)
            lines.append(line)
    launches = {"deliver_small_buf": launches["per-phase"]["deliver"],
                "window_buf": launches["persistent"]["window"],
                "deliver_buf": runs["KO"]["deliver"]}
    more = lossy_buf_kernels(dev)
    for have, add in zip((lines, rows, launches, alt), more):
        (have.extend if isinstance(have, list) else have.update)(add)
    return lines, rows, launches, alt


def cli_iface(dev, root) -> tuple:
    """Phase 21: the interface-buffer config (write_iface_config) through
    the CLI to its 120 s on the persistent path, counters zeroed just
    before and read just after: heartbeat.csv and summary.json equal the
    JAX CLI's; the same schedule on the per-phase path (counters zeroed
    and read the same way) ends in an equal state with the same
    heartbeat.csv.  Then, from the launch at IFACE_PROBE_S, the window of
    at most PROBE_MAX_STEPS micro-steps with the most tail drops:
    k_deliver_tcp (buffered) at each of its micro-steps and each tgen
    design (buffered) over it against their plain versions, timed beside
    the unbuffered instantiation.  Then the config with
    --tcp-congestion-control cubic through the CLI, held to the JAX
    CLI's the same way, and each tgen design <1,1> over a window of the
    launches from IFACE_PROBE_S that moves CUBIC's state (tail-dropping
    too where one does), timed beside the unbuffered CUBIC
    instantiation.  Each CLI run is made by shape (the resident kernel)
    and with the warp design forced (cli_designs).  Returns (lines, rows,
    launches, other ms)."""
    import tempfile
    import torch
    from shadow1_tpu_torch import cli
    from shadow1_tpu_torch.config import assemble
    from shadow1_tpu_torch.core import megakernel as mk
    from shadow1_tpu_torch.observe import Tracker
    label = (f"cli: interface-buffer config ({IFACE_WEB} web hosts, "
             f"interfacebuffer {IFACE_BYTES})")
    rows, alt = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        config = write_iface_config(f"{tmp}/config", IFACE_WEB, IFACE_BYTES)
        res, lines, launches = cli_designs(
            lambda d: [config, "--data-directory", d, "--quiet"], label,
            "iface", "window_tgen_buf", f"{tmp}/m")
        main_hb, stop = res["heartbeat"], \
            int(res["summary"]["simulated_seconds"])
        asm = assemble.load(config, persistent=False, device=dev)
        tr = Tracker(f"{tmp}/pp", asm.hostnames)
        torch.cuda.synchronize()
        mk.reset_launches()
        t0 = time.perf_counter()
        pp, _t = cli.simulate(asm.state, asm.params, asm.app, stop * SEC, tr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["deliver_tcp_buf"] = mk.LAUNCHES["deliver"]
        if mk.LAUNCHES["window"] or not mk.LAUNCHES["deliver"]:
            _fail(f"{label}, per-phase path: launches {mk.LAUNCHES}")
        require_equal(pp, res["state"], f"{label}: per-phase vs persistent")
        if Path(tr.path).read_bytes() != main_hb:
            _fail(f"{label}: the per-phase path's heartbeat.csv differs")
        lines.append(f"{label}: the per-phase path ({wall:.4f} s, "
                     f"launches {dict(mk.LAUNCHES)}) ends in an equal state "
                     f"with the same heartbeat.csv")
        del pp, res
        label_c = f"{label} with CUBIC"
        res, more, n = cli_designs(
            lambda d: [config, "--data-directory", d, "--quiet",
                       "--tcp-congestion-control", "cubic"], label_c,
            "iface-cubic", "window_tgen_cubic_buf", f"{tmp}/c")
        lines += more
        launches.update(n)
        del res
        a = assemble.load(config, device=dev)
        ac = assemble.load(config, cong="cubic", device=dev)
    sec0 = IFACE_PROBE_S * SEC
    at = cli_schedule(a.state, a.params, a.app, sec0)
    win, _sc = pick_window(
        at, a.params, a.app, sec0 + SEC,
        lambda b, e: (router_drops(b, e), int(e.n_steps) - int(b.n_steps)),
        PROBE_MAX_STEPS)
    if win is None:
        _fail(f"{label}: no window of at most {PROBE_MAX_STEPS} micro-steps "
              f"to probe")
    unbuf = unbuffered(a.params)
    rows["deliver_tcp_buf"], alt["deliver_tcp_buf"], line = deliver_probe(
        win, a.params.replace(persistent=False), a.app, dev,
        unbuf.replace(persistent=False),
        f"{label} kernels: deliver at {int(win.now) / SEC:.4f} s")
    lines.append(line)
    tgen_probes(win, a.params, a.app, unbuf,
                f"{label} kernels: window at {int(win.now) / SEC:.4f} s",
                "window_tgen_buf", sec0 + SEC, rows, alt, lines)
    del a, at, win
    win, sc, sec = pick_cli_window(
        ac.state, ac.params, ac.app,
        range(IFACE_PROBE_S, IFACE_PROBE_S + 4), moves_and_drops,
        lambda sc: sc[1] > 0)
    if win is None:
        _fail(f"{label_c}: no window of at most {PROBE_MAX_STEPS} "
              f"micro-steps moves CUBIC's state from {IFACE_PROBE_S} s")
    tgen_probes(win, ac.params, ac.app, unbuffered(ac.params),
                f"{label_c} kernels: window at {int(win.now) / SEC:.4f} s "
                f"({sc[1]} sockets' CUBIC state moves, {sc[2]} tail drops)",
                "window_tgen_cubic_buf", (sec + 1) * SEC, rows, alt, lines)
    return lines, rows, launches, alt


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
    from shadow1_tpu_torch.config import assemble

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    _phase_done("1")

    # ---- 2. build -------------------------------------------------------
    from shadow1_tpu_torch.core import _build
    t0 = time.perf_counter()
    built = shadow1_tpu_torch.build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})",
          flush=True)
    for name in (*_build.NAMES, *_build.VARIANTS):
        log = (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
        fns = [kernel_name(ln.split("'")[1]) for ln in log
               if "Compiling entry" in ln]
        use = [ln.split("ptxas info    : ")[-1].strip() for ln in log
               if "registers" in ln or "spill" in ln]
        print(f"build: {name} ptxas: " + " | ".join(
            f"{f}: {a}; {b}" for f, a, b in zip(fns, use[0::2],
                                                use[1::2])), flush=True)

    _phase_done("2")

    # ---- 3. kernels against their plain versions ------------------------
    dev = torch.device("cuda")
    state, params, app = sim.build_phold(**BENCH, megakernel=True,
                                         persistent=False, device=dev)
    state = engine.run_until(state, params, app, WARM_NS)
    times, bounds, errs = check_kernels(state, params, app, dev)
    check_window(state, params, app, label="kernels: window (one)",
                 plain_reps=1)
    times["window"], bounds["window"], errs["window"] = check_window(
        state, params, app, span=BUSY_WINDOWS, plain_reps=1)
    # k_window opens its windows with the previous exchange passes (v1,
    # its default); the same windows with ex_run, for the comparison.
    mk.set_window_exchange_v1(False)
    try:
        check_window(state, params, app, span=BUSY_WINDOWS, plain_reps=0,
                     label="kernels: window with ex_run's exchange")
    finally:
        mk.set_window_exchange_v1(None)
    del state
    for line in check_ko(dev):
        print(line, flush=True)

    # f64 log1p of the delay draw on all 2^24 inputs, card vs CPU: the
    # plain torch emulation (per-phase path) and K_WINDOW's device log1p.
    n_bad = n_bad_dev = 0
    for lo in range(0, 1 << 24, 1 << 22):
        k = torch.arange(lo, lo + (1 << 22), dtype=torch.int64)
        u = k.to(torch.float64) * (1.0 / (1 << 24))
        cpu = xlamath.log1p(-u).view(torch.int64)
        gpu = xlamath.log1p(-u.to(dev)).cpu().view(torch.int64)
        dev_fn = mk.log1p_probe(-u.to(dev)).cpu().view(torch.int64)
        n_bad += int((gpu != cpu).sum())
        n_bad_dev += int((dev_fn != cpu).sum())
    if n_bad or n_bad_dev:
        _fail(f"f64 log1p: card and CPU differ on {n_bad} (torch) / "
              f"{n_bad_dev} (K_WINDOW device code) of 2^24 inputs")
    print("kernels: f64 log1p bitwise equal to the CPU on all 2^24 inputs, "
          "as torch on the card and as K_WINDOW's device function",
          flush=True)
    cnt = torch.arange(1, 1 << 20, dtype=torch.int32)
    if not torch.equal(nic.codel_spacing(cnt.to(dev)).cpu(),
                       nic.codel_spacing(cnt)):
        _fail("CoDel spacing (f32 rsqrt): card and CPU differ")

    # A congested, lossy world takes the branches the bench world never
    # does (loss draws, TX parking and drain, rx starvation, CoDel drops,
    # slab overflow, bootstrap, the CPU clamp, the PDS trail): the whole
    # run through K_WINDOW, and through the per-phase kernels, must equal
    # the whole run through the plain versions, leaf for leaf.
    finals = {}
    for path, (fused, persist) in (("K_WINDOW", (True, True)),
                                   ("per-phase", (True, False)),
                                   ("plain", (False, False))):
        s0, p0, a0 = sim.build_phold(**STRESS, megakernel=fused,
                                     persistent=persist, device=dev)
        p0 = stressed(p0)
        mk.reset_launches()
        finals[path] = engine.run_until(s0, p0, a0, STRESS_NS)
        used = {k for k, v in mk.LAUNCHES.items() if v > 0}
        want = {"K_WINDOW": {"window"}, "per-phase": set(PER_PHASE),
                "plain": set()}[path]
        if used != want:
            _fail(f"stressed world, {path} path: launches {mk.LAUNCHES}")
    require_equal(finals["K_WINDOW"], finals["plain"],
                  "stressed world, K_WINDOW")
    require_equal(finals["per-phase"], finals["plain"],
                  "stressed world, per-phase kernels")
    hs = finals["plain"].hosts
    drops = {k: int(getattr(hs, k).sum()) for k in (
        "pkts_dropped_inet", "pkts_dropped_router", "pkts_dropped_pool")}
    if min(drops.values()) <= 0:
        _fail(f"stressed world did not take every drop path: {drops}")
    path = mk.deliver_path(finals["plain"], p0, a0)
    if path != "small":
        _fail(f"the stressed world's K_DELIVER takes the {path} path, not "
              f"deliver_small")
    print(f"kernels: stressed world (H={STRESS['num_hosts']}, "
          f"{STRESS_NS // MS} ms) equal through K_WINDOW, the per-phase "
          f"kernels and the plain versions (K_DELIVER's {path} path); "
          f"{int(hs.pkts_sent.numel())} hosts, "
          f"{int(finals['plain'].n_steps)} micro-steps, "
          f"{int(finals['plain'].n_windows)} windows, drops {drops}",
          flush=True)
    del finals

    _phase_done("3")

    # ---- 4. main path: the defaults, one K_WINDOW launch per run_until --
    state, params, app = sim.build_phold(**BENCH, device=dev)
    if not (params.megakernel and params.persistent):
        _fail("the port's defaults are not megakernel + persistent")
    out, warm, launches, _ = drive(state, params, app, "main path")
    # One launch per run_until call with work: the warm-up's, then one per
    # chunk of run_chunked.
    chunks = -(-(RUN_NS - WARM_NS) // engine.CHUNK_NS)
    if launches["window"] != 1 + chunks or \
            any(launches[k] for k in PER_PHASE):
        _fail(f"main path launches {launches}: want window = {1 + chunks} "
              f"(one per run_until call, for {JAX_FINAL['n_windows']} "
              f"windows) and no per-phase launch")
    line, window_dev_ms = profile_persistent(warm, params, app, RUN_NS,
                                             chunks)
    print(line, flush=True)
    bw, ow, sw = windows_bound(warm, params, app,
                               (RUN_NS - WARM_NS) // params.min_latency_ns)
    print(f"main path (persistent): the timed launch's "
          f"{JAX_FINAL['n_windows'] - JAX_WARM['n_windows']} windows ({sw} "
          f"micro-steps) must move {bw} bytes and do {ow} operations: bound "
          f"{bound_ms(bw, ow):.6f} ms, K_WINDOW device {window_dev_ms:.4f} "
          f"ms (profiler)", flush=True)
    for line in phold_trace(warm, params, app, BUSY_WINDOWS):
        print(line, flush=True)

    _phase_done("4")

    # ---- 5. the per-phase path (persistent=False) ------------------------
    state, params, app = sim.build_phold(**BENCH, persistent=False,
                                         device=dev)
    out_pp, _, launches_pp, _ = drive(state, params, app, "per-phase path")
    if launches_pp["window"] or \
            launches_pp["exchange"] != JAX_FINAL["n_windows"] or \
            launches_pp["deliver"] != JAX_FINAL["n_steps"] or \
            launches_pp["transport"] != JAX_FINAL["n_steps"]:
        _fail(f"per-phase path launches {launches_pp} do not match its "
              f"windows / micro-steps")
    require_equal(out_pp, out, "per-phase path vs persistent path")
    print("per-phase path: final state equal to the persistent path's",
          flush=True)
    for line in profile_window(out_pp, params, app):
        print(line, flush=True)

    _phase_done("5")

    # ---- 6. TCP kernels against their plain versions --------------------
    state, params, app = sim.build_bulk(**BULK, persistent=False,
                                        device=dev)
    state = engine.run_until(state, params, app, TCP_PROBE_NS)
    t_times, t_bounds, t_errs = check_tcp_kernels(state, params, app, dev)
    times.update(t_times)
    bounds.update(t_bounds)
    errs.update(t_errs)
    times["window_tcp"], bounds["window_tcp"], errs["window_tcp"] = \
        check_window(state, params, app, advance=0,
                     label="tcp kernels: window (TCP)", kernel="k_window_tcp",
                     plain_reps=1)
    del state
    for line in check_ack_shed(dev):
        print(f"tcp kernels: {line}", flush=True)
    for line in check_fan_in(dev)[0]:
        print(f"tcp kernels: {line}", flush=True)
    print(check_lossy_tcp(dev), flush=True)

    _phase_done("6")

    # ---- 7. TCP per-phase path: the bulk world, per-phase kernels ------
    out_tcp, _, params, app, launches_tcp, _ = drive_tcp(dev, False)
    for line in profile_window(out_tcp, params, app):
        print(f"tcp {line}", flush=True)

    _phase_done("7")

    # ---- 8. TCP main path: the defaults, one K_WINDOW launch per window -
    out_tp, warm_tp, params, app, launches_tp, _ = drive_tcp(dev, True)
    require_equal(out_tp, out_tcp, "tcp persistent path vs per-phase path")
    print("tcp main path (persistent): final state equal to the per-phase "
          "path's", flush=True)
    del out_tcp, out_tp
    line, window_tcp_ms, _ = busy_windows(warm_tp, params, app, None)
    print(line, flush=True)
    line, _, busy_st = busy_windows(warm_tp, params, app, BUSY_WINDOWS)
    print(line, flush=True)
    # The server's phases with the window open's previous exchange passes
    # (v1) and with ex_run, the default.
    for v1 in (True, False):
        mk.set_window_exchange_v1(v1)
        try:
            lines, trace_st, ex_ms = phase_trace(
                warm_tp, params, app, BUSY_WINDOWS,
                label=f"phase trace ({'v1 exchange' if v1 else 'exchange'})")
        finally:
            mk.set_window_exchange_v1(None)
        for line in lines:
            print(line, flush=True)
        require_equal(trace_st, busy_st,
                      "phase trace vs the untraced windows")
    del trace_st
    del busy_st
    # The exchange's bound at each of those windows' opens (the windows
    # one a call).
    xb = [0, 0]
    st = engine.clone_state(warm_tp)
    t_end = int(st.now) + BUSY_WINDOWS * params.min_latency_ns
    for _ in range(BUSY_WINDOWS):
        b, ops = exchange_bound(st)
        xb[0] += b
        xb[1] += ops
        st = mk.window_call(st, params, app, t_end, 1)[0]
    del st
    print(f"tcp main path (persistent): the exchange in k_window_tcp's "
          f"window open, the first {BUSY_WINDOWS} windows: {ex_ms:.4f} ms a "
          f"window (phase trace share of the device time), bound "
          f"{bound_ms(*xb) / BUSY_WINDOWS:.6f} ms a window ({xb[0]} bytes, "
          f"{xb[1]} operations in all)", flush=True)
    line, (b8, o8), s8 = transport_main_path(warm_tp, params, app,
                                             TR_WINDOWS)
    print(line, flush=True)
    print(f"tcp main path (persistent): the first {TR_WINDOWS} windows "
          f"({s8} micro-steps) must move {b8} bytes and do {o8} operations: "
          f"bound {bound_ms(b8, o8):.6f} ms", flush=True)

    _phase_done("8")

    # ---- 9. the pairs world: more hosts than one thread each would fit --
    run_pairs(dev)

    _phase_done("9")

    # ---- 10. tgen kernels against their plain versions -------------------
    state, params, app = sim.build_tgen(TGEN_HOSTS, device=dev)
    tgen_probe = engine.run_until(state, params, app, PROBE_TGEN_NS)
    print(record_line(tgen_probe, app, "the tgen world"), flush=True)
    asm = assemble.load(str(root / CLI_100HOST), device=dev)
    print(record_line(asm.state, asm.app, "examples/tgen-100host"),
          flush=True)
    del asm
    # Each design over the next window (a row each; the plain version and
    # the bound are taken once, on the same inputs) and over BUSY_WINDOWS
    # windows in one call.
    one = many = None
    for resident, kernel, tag in TGEN_DESIGNS:
        with tgen_design(resident):
            one = check_window(tgen_probe, params, app, advance=0,
                               label=f"tgen kernels: {kernel}, window",
                               kernel=kernel, plain_reps=1, reuse=one)
            many = check_window(tgen_probe, params, app, advance=0,
                                label=f"tgen kernels: {kernel}, windows",
                                kernel=kernel, plain_reps=0,
                                span=BUSY_WINDOWS, reuse=many)
        row = f"window_tgen{tag}"
        times[row], bounds[row], errs[row] = one
    print(check_loopback_transport(dev), flush=True)

    _phase_done("10")

    # ---- 11. tgen per-phase path: the tgen world to TGEN_MID_NS ----------
    mid_pp, _, params_pp, app_pp, _, _ = drive_tgen(dev, False)
    for line in profile_window(mid_pp, params_pp, app_pp):
        print(f"tgen {line}", flush=True)

    _phase_done("11")

    # ---- 12. tgen main path: the defaults, one launch per run_until call
    mid_tg, _, params, app, launches_tg, _ = drive_tgen(dev, True)
    if mk.TGEN_LAUNCHES != {"resident": launches_tg["window"], "warp": 0}:
        _fail(f"tgen main path: launches by design {mk.TGEN_LAUNCHES}: the "
              f"world's shape takes the resident kernel")
    require_equal(mid_tg, mid_pp, f"tgen: persistent vs per-phase path at "
                  f"{TGEN_MID_NS // SEC} s")
    print(f"tgen main path (persistent): state at {TGEN_MID_NS // SEC} s "
          f"equal to the per-phase path's", flush=True)
    del mid_pp
    mid_w, _, _, _, launches_tgw, _ = drive_tgen(dev, True, resident=False)
    require_equal(mid_w, mid_tg, "tgen: the warp design vs the resident "
                  "kernel")
    del mid_w
    # Both designs on the same inputs: TGEN_MID_NS -> TGEN_NS in one call,
    # and BUSY_WINDOWS windows from PROBE_TGEN_NS.
    window_tgen_ms, busy = {}, {}
    for resident, kernel, tag in TGEN_DESIGNS:
        with tgen_design(resident):
            line, window_tgen_ms[tag], _ = busy_windows(
                mid_tg, params, app, None, label=f"tgen main path "
                f"(persistent, {kernel}), {TGEN_MID_NS // SEC} -> "
                f"{TGEN_NS // SEC} s", until=TGEN_NS)
            print(line, flush=True)
            line, busy[tag], busy_st = busy_windows(
                tgen_probe, params, app, BUSY_WINDOWS,
                label=f"tgen main path (persistent, {kernel}), from "
                      f"{PROBE_TGEN_NS / SEC} s")
            print(line, flush=True)
    print(f"tgen main path: device ms per window, resident kernel / warp "
          f"design on the same inputs: {TGEN_MID_NS // SEC} -> "
          f"{TGEN_NS // SEC} s {window_tgen_ms['_res']:.4f} / "
          f"{window_tgen_ms['']:.4f} = "
          f"{window_tgen_ms['_res'] / window_tgen_ms['']:.3f}; the "
          f"{BUSY_WINDOWS} windows from {PROBE_TGEN_NS / SEC} s "
          f"{busy['_res']:.4f} / {busy['']:.4f} = "
          f"{busy['_res'] / busy['']:.3f}", flush=True)
    b12, o12, s12 = windows_bound(tgen_probe, params, app, BUSY_WINDOWS)
    w12 = int(busy_st.n_windows) - int(tgen_probe.n_windows)
    print(f"tgen main path (persistent): those {w12} windows ({s12} "
          f"micro-steps) must move {b12} bytes and do {o12} operations: "
          f"bound {bound_ms(b12, o12) / w12:.6f} ms a window", flush=True)
    # The split of a micro-step by phase: the warp design's server and a
    # client, the resident kernel's server block.
    for resident, host in ((False, 0), (False, 1), (True, 0)):
        with tgen_design(resident):
            lines, trace_st, _ = phase_trace(
                tgen_probe, params, app, BUSY_WINDOWS, host=host,
                label=f"tgen phase trace ({TGEN_DESIGNS[resident][1]}, "
                      f"host {host})")
        for line in lines:
            print(line, flush=True)
        require_equal(trace_st, busy_st,
                      "tgen phase trace vs the untraced windows")
    del trace_st, busy_st, tgen_probe

    _phase_done("12")

    # ---- 13. the loopback world on both paths ----------------------------
    print(run_loopback(dev), flush=True)

    _phase_done("13")

    # ---- 14. the jitter draw in K_TRANSPORT's staging --------------------
    jit_lines, jit_ms = check_jitter_kernels(dev)
    for line in jit_lines:
        print(line, flush=True)

    _phase_done("14")

    # ---- 15. cli: examples/tgen-2host to its 60 s -------------------------
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        res = run_cli([str(root / CLI_2HOST), "--data-directory", tmp,
                       "--quiet"], "cli: tgen-2host")
        print(check_cli_constants(res, "tgen-2host", "cli: tgen-2host"),
              flush=True)
    del res

    _phase_done("15")

    # ---- 16. cli: examples/tgen-100host, the main path ----------------------
    window_cli_ms, cli_checks, launches_cli = cli_100host(dev, smi)
    for row, (t, b, e) in cli_checks.items():
        times[row], bounds[row], errs[row] = t, b, e

    _phase_done("16")

    # ---- 17. cli: the jittered config ---------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        res = run_cli([write_jitter_config(f"{tmp}/config"),
                       "--data-directory", f"{tmp}/out", "--quiet"],
                      "cli: jittered config")
        print(check_cli_constants(res, "jitter", "cli: jittered config"),
              flush=True)
    del res
    print("jitter kernels: device ms with jitter / without, same inputs: "
          + "; ".join(f"{k} {a:.4f} / {b:.4f}"
                      for k, (a, b) in jit_ms.items()), flush=True)

    _phase_done("17")

    # ---- 18. CUBIC: the device cbrt, LOSSY with CUBIC, its kernels --------
    lines, new_rows, new_launches, other_ms = cubic_kernels(dev)
    for line in lines:
        print(line, flush=True)

    _phase_done("18")

    # ---- 19. cli: tgen-100host with CUBIC, the main path -------------------
    lines, rows_, launches_, alt_ = cli_cubic(dev, root)
    for line in lines:
        print(line, flush=True)
    new_rows.update(rows_)
    new_launches.update(launches_)
    other_ms.update(alt_)

    _phase_done("19")

    # ---- 20. interface buffers: STRESS and KO, their kernels ---------------
    # ---- 21. cli: the interface-buffer config ------------------------------
    for phase, part in (("20", lambda: buf_kernels(dev)),
                        ("21", lambda: cli_iface(dev, root))):
        lines, rows_, launches_, alt_ = part()
        for line in lines:
            print(line, flush=True)
        new_rows.update(rows_)
        new_launches.update(launches_)
        other_ms.update(alt_)
        _phase_done(phase)

    # ---- 22. APSP on the card above 1,024 vertices -------------------------
    print(check_apsp(dev), flush=True)

    _phase_done("22")

    # ---- 23. kernels line -----------------------------------------------
    for name, (t, b, e) in new_rows.items():
        times[name], bounds[name], errs[name] = t, b, e
    rows = []
    for name in (*PER_PHASE, "window", *TCP_ROWS, *NEW_ROWS):
        b, ops = bounds[name]
        bytes_ms = b / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        base = TCP_ROWS.get(name) or NEW_ROWS.get(name, name)
        n = new_launches[name] if name in NEW_ROWS else \
            launches[name] if name == "window" else \
            launches_tp["window"] if name == "window_tcp" else \
            launches_tgw["window"] if name == "window_tgen" else \
            launches_tg["window"] if name == "window_tgen_res" else \
            launches_cli[name] if name in launches_cli else \
            launches_tcp[base] if name in TCP_ROWS else launches_pp[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"shadow1_tpu_torch/csrc/{base}.cu",
            "replaces": REPLACES[base], "launches": n,
            "max_abs_err": errs[name], "ms": times[name][0][0],
            "call_ms": times[name][0][1],
            "plain_ms": times[name][1][0], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None})
        if name in NEW_ROWS:
            rows[-1]["other_ms"] = other_ms[name]
    print(f"K_WINDOW in the main path's profile: {window_dev_ms:.4f} ms "
          f"device per launch; K_WINDOW (TCP) on the bulk main path: "
          f"{window_tcp_ms:.4f} ms device per window; K_WINDOW (tgen) on "
          f"the tgen main path {TGEN_MID_NS // SEC} -> {TGEN_NS // SEC} s: "
          f"the resident kernel {window_tgen_ms['_res']:.4f} ms device per "
          f"window, the warp design {window_tgen_ms['']:.4f}; on the CLI's "
          f"tgen-100host main path (the resident kernel): "
          f"{window_cli_ms:.4f} ms device per window", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
