"""Command-line front end of the port: run a shadow.config.xml on the card
(counterpart of shadow1_tpu/cli.py, its `run` subcommand).

    python -m shadow1_tpu_torch run examples/tgen-2host/shadow.config.xml \\
        --data-directory out/

The flags are the JAX CLI's, with its defaults, plus `--device` (default
`cuda`; the tests pass `--device cpu`).  Without a card and without
`--device cpu` the run fails; it never carries on on the CPU.  The run
loop is the JAX CLI's sequential one: `next_sync` to each heartbeat
boundary, `engine.run_chunked`, then the heartbeat; it writes the same
heartbeat.csv and summary.json and prints the same summary line.  Every
JAX flag the port cannot honour yet is refused with RC_USAGE, naming the
flag and the ROADMAP item that will carry it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .core import engine, simtime

SEC = simtime.SIMTIME_ONE_SECOND

# The JAX package's exit codes (shadow1_tpu/supervise.py).
RC_OK = 0          # completed, invariants intact
RC_INVARIANT = 1   # the simulation set an err bit
RC_USAGE = 2       # usage error or refusal
RC_FAILED = 3      # infrastructure failure (here: no CUDA card)

# JAX run flags the port does not carry yet: (flag, its value when not
# given, ROADMAP queue 1 item).  A flag whose value differs is refused.
REFUSED = (
    ("--devices", 1, 9), ("--worlds", 1, 9), ("--sweep", None, 9),
    ("--bucket", False, 4), ("--netem", None, 5), ("--churn", None, 5),
    ("--churn-downtime", 5.0, 5), ("--pcap", False, 8),
    ("--pcap-ring", 1 << 17, 8), ("--log-level", "off", 8),
    ("--log-ring", 0, 8), ("--profile", False, 8), ("--scope", None, 8),
    ("--trace-packets", None, 8), ("--digest-every", None, 8),
    ("--digest-rows", 4096, 8), ("--flight-rows", None, 8),
    ("--checkpoint-every", None, 8), ("--auto-resume", False, 10),
    ("--watchdog", None, 10), ("--progress", False, 6),
)


def _parser():
    p = argparse.ArgumentParser(
        prog="shadow1_tpu_torch",
        description="Run a Shadow shadow.config.xml on the H100 port.")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="run a shadow.config.xml")
    r.add_argument("config", help="shadow.config.xml path")
    r.add_argument("--seed", type=int, default=1,
                   help="root RNG seed (Shadow's --seed)")
    r.add_argument("--stop-time", type=int, default=None,
                   help="override <shadow stoptime> (seconds)")
    r.add_argument("--sock-slots", type=int, default=None,
                   help="per-host socket-table slots (default: auto)")
    r.add_argument("--pool-slab", type=int, default=128,
                   help="packet-pool slots per host")
    r.add_argument("--tcp-congestion-control", choices=("reno", "cubic"),
                   default="reno",
                   help="TCP congestion control")
    r.add_argument("--interface-qdisc", choices=("fifo", "rr"),
                   default="fifo", help="NIC socket-selection discipline")
    r.add_argument("--cpu-threshold", type=int, default=-1,
                   help="microseconds of CPU backlog after which a host "
                        "blocks; -1 disables")
    r.add_argument("--cpu-precision", type=int, default=200,
                   help="CPU wake-time rounding in microseconds")
    r.add_argument("--data-directory", default=None,
                   help="where to write heartbeat.csv and summary.json")
    r.add_argument("--heartbeat-frequency", type=int, default=1,
                   help="heartbeat interval in sim seconds (0 = off)")
    r.add_argument("--quiet", action="store_true")
    r.add_argument("--no-pipeline", action="store_true",
                   help="accepted for the JAX CLI's surface: the port's "
                        "loop is always the sequential one")
    r.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda; cpu runs "
                        "the plain torch path)")
    # The JAX flags the port refuses (REFUSED), parsed as the JAX CLI
    # parses them so that a given value can be told from the default.
    r.add_argument("--devices", type=int, default=1)
    r.add_argument("--worlds", type=int, default=1)
    r.add_argument("--sweep", default=None)
    r.add_argument("--netem", default=None)
    r.add_argument("--churn", type=float, default=None)
    r.add_argument("--churn-downtime", type=float, default=5.0)
    r.add_argument("--pcap-ring", type=int, default=1 << 17)
    r.add_argument("--log-level", choices=("off", "warning", "debug"),
                   default="off")
    r.add_argument("--log-ring", type=int, default=0)
    r.add_argument("--scope", default=None)
    r.add_argument("--trace-packets", default=None)
    r.add_argument("--digest-every", type=int, default=None)
    r.add_argument("--digest-rows", type=int, default=4096)
    r.add_argument("--flight-rows", type=int, default=None)
    r.add_argument("--checkpoint-every", type=float, default=None)
    r.add_argument("--watchdog", type=float, default=None)
    for flag in ("--bucket", "--pcap", "--profile", "--auto-resume",
                 "--progress"):
        r.add_argument(flag, action="store_true")
    return p


def refusal(args) -> str | None:
    """The message for the first flag the port does not carry, or None."""
    for flag, default, item in REFUSED:
        if getattr(args, flag[2:].replace("-", "_")) != default:
            return (f"{flag} is not ported yet (ROADMAP queue 1 item "
                    f"{item})")
    return None


def next_sync(t, stop, hb_ns=None, every_ns=None) -> int:
    """The next launch boundary after sim-time `t`: the smallest of the
    next heartbeat multiple, the next checkpoint-cadence multiple and
    `stop` (shadow1_tpu/replay.py's next_sync; memoryless in `t`)."""
    t, stop = int(t), int(stop)
    nxt = stop
    for step in (hb_ns, every_ns):
        if step:
            step = int(step)
            nxt = min(nxt, (t // step + 1) * step)
    return min(nxt, stop)


def simulate(state, params, app, stop: int, tracker=None):
    """The JAX CLI's sequential run loop: run_chunked to each launch
    boundary (next_sync on the heartbeat grid), then the heartbeat if it
    is due.  Returns (final state, its sim time); the state is on the
    card's stream, synchronised."""
    hb_ns = tracker.sample_interval_ns if tracker else None
    hb_next = 0
    t = int(state.now)
    while t < stop:
        t_next = next_sync(t, stop, hb_ns)
        state = engine.run_chunked(state, params, app, t_next)
        t = t_next
        if tracker is not None and t >= hb_next:
            tracker.heartbeat(state, t)
            hb_next = t + tracker.sample_interval_ns
    if state.device.type == "cuda":
        import torch
        torch.cuda.synchronize(state.device)
    return state, t


def build_world(args):
    """Assemble the world of a `run` invocation (the part of the JAX
    build_world that calls assemble): (Assembled, stop ns)."""
    from .config import assemble
    asm = assemble.load(args.config, seed=args.seed,
                        sock_slots=args.sock_slots, pool_slab=args.pool_slab,
                        qdisc=args.interface_qdisc,
                        cpu_threshold_us=args.cpu_threshold,
                        cpu_precision_us=args.cpu_precision,
                        cong=args.tcp_congestion_control,
                        device=args.device)
    stop = (args.stop_time * SEC) if args.stop_time else asm.stop_time
    if not args.quiet:
        print(f"[shadow1-tpu] {len(asm.hostnames)} hosts, "
              f"{asm.topology.num_vertices} vertices, "
              f"stop={stop / SEC:.0f}s, device={args.device}",
              file=sys.stderr)
    return asm, int(stop)


def run_config(args) -> tuple[int, dict | None]:
    """Execute a `run` invocation: (the JAX CLI's exit code, the run's
    final state, params, app, summary and run-loop wall seconds; None
    when the run was refused)."""
    from . import NoDeviceError
    msg = refusal(args)
    if msg is not None:
        print(f"error: {msg}", file=sys.stderr)
        return RC_USAGE, None
    t_wall = time.perf_counter()
    try:
        asm, stop = build_world(args)
        engine.check_supported(asm.state, asm.params, asm.app)
    except (NotImplementedError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return RC_USAGE, None
    except NoDeviceError as e:
        print(f"error: {e}", file=sys.stderr)
        return RC_FAILED, None
    state, params, app = asm.state, asm.params, asm.app

    tracker = None
    if args.data_directory and args.heartbeat_frequency > 0:
        from .observe import Tracker
        tracker = Tracker(args.data_directory, asm.hostnames,
                          interval_s=args.heartbeat_frequency,
                          per_host_interval_s=asm.heartbeat_freq_s)
    t_loop = time.perf_counter()
    state, t = simulate(state, params, app, stop, tracker)
    loop_s = time.perf_counter() - t_loop
    wall = time.perf_counter() - t_wall

    h, a = state.hosts, state.app
    summary = {
        "simulated_seconds": t / SEC,
        "wall_seconds": round(wall, 3),
        "hosts": len(asm.hostnames),
        "streams_completed": int(a.streams_done.sum()),
        "streams_failed": int(a.streams_failed.sum()),
        "packets_sent": int(h.pkts_sent.sum()),
        "packets_received": int(h.pkts_recv.sum()),
        "bytes_sent": int(h.bytes_sent.sum()),
        "drops_inet": int(h.pkts_dropped_inet.sum()),
        "drops_router": int(h.pkts_dropped_router.sum()),
        "drops_pool": int(h.pkts_dropped_pool.sum()),
        "acks_thinned": int(h.acks_thinned.sum()),
        "err_flags": int(state.err),
    }
    if tracker is not None:
        tracker.summary(summary, state)
    print(json.dumps(summary))
    rc = RC_OK if int(state.err) == 0 else RC_INVARIANT
    return rc, dict(state=state, params=params, app=app, summary=summary,
                    loop_seconds=loop_s)


def main(argv=None) -> int:
    return run_config(_parser().parse_args(argv))[0]


if __name__ == "__main__":
    sys.exit(main())
