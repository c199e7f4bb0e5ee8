"""Same-call comparisons of K_WINDOW builds on the card, for PERF.md.

    python -m shadow1_tpu_torch.window_ab widths
        The resident tgen kernel (csrc/window.cu k_window_tgen_res) built
        at 32, 128 and 256 threads a block (-DS1_RES_BLOCK; 128 is the
        library's own), each on the same inputs in one process, in the
        order 128 256 32 32 256 128: the tgen world 10 -> 120 s, and
        examples/tgen-100host on its CLI schedule 0 -> 120 s and its
        6 -> 7 s launch, as device ms (CUDA events around each K_WINDOW
        call), every result held to the 128-thread build's, leaf for
        leaf; and each build's ptxas line for the kernel's four
        instantiations.

    python -m shadow1_tpu_torch.window_ab bulk OTHER_ROOT [...]
        chip_smoke.py's phold and bulk main paths (its `drive` and
        `drive_tcp`) in each OTHER_ROOT, another checkout of the repo
        (say, a parent commit unpacked with git archive), and in this
        one, each in a process of its own, in that order and then back
        (A B this this B A): the timed part's wall and, on the bulk
        path, K_WINDOW's device ms per window
        (chip_smoke._timed_windows); and each checkout's ptxas lines for
        k_window_tcp.

Needs a CUDA card and nvcc; prints one line per measurement and, last, a
JSON object of them all.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = (128, 256, 32, 32, 256, 128)
CLI_STOP = 120 * 10**9     # examples/tgen-100host's stop time (ns)


def ptxas(log: str, prefix: str) -> list[str]:
    """`kernel: registers; spills` for each kernel in an nvcc -Xptxas -v
    log whose name starts with `prefix`."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import kernel_name
    lines = log.splitlines()
    out, fn = [], None
    for ln in lines:
        if "Compiling entry" in ln:
            fn = kernel_name(ln.split("'")[1])
        elif fn and fn.startswith(prefix) and ("registers" in ln or
                                               "spill" in ln):
            out.append(f"{fn}: {ln.split('ptxas info    : ')[-1].strip()}")
    return out


def widths() -> dict:
    import torch
    from . import sim
    from .config import assemble
    from .core import _build, engine
    from .core import megakernel as mk
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("window_ab: no CUDA device")
    names = {w: "window" if w == 128 else f"window_res{w}" for w in WIDTHS}
    for w, name in names.items():
        if name != "window":
            _build.VARIANTS[name] = ("window", (f"-DS1_RES_BLOCK={w}",))
    t0 = time.perf_counter()
    _build.build_all(tuple(set(names.values())) + ("exchange", "deliver",
                                                   "transport"))
    print(f"widths: build {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"ptxas": {}, "tgen_ms": {}, "cli_run_ms": {}, "cli_ms": {}}
    for w, name in sorted(names.items()):
        lines = ptxas((_build.BUILD_DIR / f"{name}.log").read_text(),
                      "k_window_tgen_res")
        out["ptxas"][w] = lines
        print(f"widths: {w} threads ptxas: " + " | ".join(lines), flush=True)
    dev = torch.device("cuda")
    # The inputs, on the library's own build.
    state, params, app = sim.build_tgen(cs.TGEN_HOSTS, device=dev)
    mid = engine.run_until(state, params, app, cs.TGEN_MID_NS)
    asm = assemble.load(str(ROOT / cs.CLI_100HOST), device=dev)
    at6 = cs.cli_schedule(engine.clone_state(asm.state), asm.params,
                          asm.app, cs.CLI_PROBE_S * cs.SEC)
    runs = {
        "tgen_ms": (mid, params, app, lambda s, p, a: engine.run_until(
            s, p, a, cs.TGEN_NS)),
        "cli_run_ms": (asm.state, asm.params, asm.app, lambda s, p, a:
                       cs.cli_schedule(s, p, a, CLI_STOP)),
        "cli_ms": (at6, asm.params, asm.app, lambda s, p, a:
                   engine.run_chunked(s, p, a, (cs.CLI_PROBE_S + 1) * cs.SEC)),
    }
    load, want = _build.load, {}
    for w in WIDTHS:
        _build.load = lambda n, v=names[w]: load(v if n == "window" else n)
        try:
            for key, (st0, p, a, run) in runs.items():
                call, marks = mk.window_call, []

                def timed(*args):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    r = call(*args)
                    e1.record()
                    marks.append((e0, e1))
                    return r
                mk.reset_launches()
                mk.window_call = timed
                try:
                    st = run(engine.clone_state(st0), p, a)
                    torch.cuda.synchronize()
                finally:
                    mk.window_call = call
                if mk.TGEN_LAUNCHES["resident"] != len(marks) or not marks:
                    raise SystemExit(f"window_ab: {key} at {w} threads did "
                                     f"not run the resident kernel: "
                                     f"{mk.TGEN_LAUNCHES}")
                ms = sum(e0.elapsed_time(e1) for e0, e1 in marks)
                if key in want:
                    cs.require_equal(st, want[key], f"{key} at {w} threads")
                else:
                    want[key] = st
                n_w = int(st.n_windows) - int(st0.n_windows)
                out[key].setdefault(w, []).append(ms)
                print(f"widths: {w} threads, {key[:-3]}: {len(marks)} "
                      f"launches, {n_w} windows, device {ms:.4f} ms "
                      f"({ms / n_w:.6f} ms a window)", flush=True)
        finally:
            _build.load = load
    return out


_TREE = r"""
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from shadow1_tpu_torch import sim
dev = torch.device("cuda")
st, pa, ap = sim.build_phold(**cs.BENCH, device=dev)
_, _, _, phold_wall = cs.drive(st, pa, ap, "phold main path")
_, warm, params, app, launches, wall = cs.drive_tcp(dev, True)
out, _wall, ms = cs._timed_windows(warm, params, app, None)
n_w = int(out.n_windows) - int(warm.n_windows)
print(json.dumps({"phold_wall": phold_wall, "bulk_wall": wall,
                  "bulk_ms_per_window": sum(ms) / n_w, "windows": n_w,
                  "launches": launches["window"]}))
"""


def bulk(others: list[Path]) -> dict:
    trees = {str(o): o.resolve() for o in others}
    trees["this"] = ROOT
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from shadow1_tpu_torch.core import _build; _build.build_all("
         "_build.NAMES)", str(r)]) for r in trees.values()]
    if any(p.wait() for p in procs):
        raise SystemExit("window_ab: a build failed")
    print(f"bulk: builds {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"ptxas": {}, "runs": []}
    for tag, r in trees.items():
        log = (r / "shadow1_tpu_torch" / "_build" / "window.log").read_text()
        out["ptxas"][tag] = ptxas(log, "k_window_tcp")
        print(f"bulk: {tag} ({r}) ptxas: " + " | ".join(out["ptxas"][tag]),
              flush=True)
    order = list(trees)
    for tag in order + order[::-1]:
        res = subprocess.run([sys.executable, "-c", _TREE,
                              str(trees[tag])], capture_output=True,
                             text=True, cwd=trees[tag])
        if res.returncode != 0:
            raise SystemExit(f"window_ab: {tag} failed\n{res.stdout}\n"
                             f"{res.stderr}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["tree"] = tag
        out["runs"].append(row)
        print(f"bulk: {tag}: phold wall {row['phold_wall']:.4f} s, bulk "
              f"wall {row['bulk_wall']:.4f} s, k_window_tcp "
              f"{row['bulk_ms_per_window']:.4f} ms a window ({row['windows']}"
              f" windows, {row['launches']} launches)", flush=True)
    return out


def main(argv: list[str]) -> int:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    if argv[:1] == ["widths"]:
        out = widths()
    elif argv[:1] == ["bulk"] and len(argv) >= 2:
        out = bulk([Path(r) for r in argv[1:]])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    out["device"] = smi
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
