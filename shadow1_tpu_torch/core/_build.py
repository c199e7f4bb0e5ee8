"""Build and load the port's CUDA kernels (route (b): nvcc into a shared
library with a plain C interface, loaded with ctypes).

Each `csrc/<name>.cu` builds into `shadow1_tpu_torch/_build/` under a
name keyed by the hash of its sources (the .cu and every header it
includes) and flags, at first use, from the sources in the checkout
only.  `build_all` starts one nvcc per library at once (VARIANTS are
libraries built from another's source with extra flags).  Flags: sm_90a,
-O3, --fmad=false (no multiply-add contraction, so every float op rounds
as the JAX package's does), never fast math.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
SRC_DIR = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NAMES = ("exchange", "deliver", "transport", "window")
# Libraries built from another one's source with extra flags: K_WINDOW
# with its per-phase cycle counters (csrc/common.cuh Clk), which
# chip_smoke.py loads for its phase trace.
VARIANTS = {"window_clk": ("window", ("-DS1_PHASE_CLOCKS",))}
# --split-compile=0: nvcc optimises and assembles a library's kernels on
# every CPU at once (K_WINDOW holds a dozen instantiations).
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "--split-compile=0")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# The C entry points of each library and their argument types.
_ARGTYPES = {
    "exchange": {"exchange_launch": [_P, _I, _P],
                 "exchange_occupancy": [_P, _P]},
    "deliver": {"deliver_launch": [_P, _P, _P],
                "deliver_fits_small": [_P]},
    "transport": {"transport_launch": [_P, _P, _P]},
    "window": {"window_launch": [_P, _P], "window_tcp_launch": [_P, _I, _P],
               "window_occupancy": [_I, _I, _I, _P, _P],
               "window_res_launch": [_P, _I64, _P],
               "window_res_occupancy": [_I, _I, _I64, _P, _P, _P, _P],
               "log1p_probe_launch": [_P, _P, _I64, _P],
               "cbrt_probe_launch": [_P, _P, _I64, _P],
               "cong_probe_launch": [_I, *[_P] * 10, _I64, _P]},
}

_LOADED: dict = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _sources(name: str) -> list[Path]:
    """`csrc/<name>.cu` and every header it includes, transitively."""
    out, todo = [], [SRC_DIR / f"{name}.cu"]
    while todo:
        p = todo.pop(0)
        if p in out:
            continue
        out.append(p)
        todo += [SRC_DIR / m for m in
                 re.findall(r'^#include "([^"]+)"', p.read_text(), re.M)]
    return out


def _recipe(name: str) -> tuple[str, tuple]:
    """(source name, extra flags) of library `name`."""
    return VARIANTS.get(name, (name, ()))


def lib_path(name: str) -> Path:
    src, extra = _recipe(name)
    h = hashlib.sha256()
    for p in _sources(src):
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS + extra).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=NAMES + tuple(VARIANTS)) -> dict:
    """Compile every missing library, one nvcc per source, all at once.
    Returns {name: seconds} (0.0 for a library already built)."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = lib_path(name)
        if target.exists():
            out[name] = 0.0
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        src, extra = _recipe(name)
        cmd = [nvcc(), *FLAGS, *extra, "-o", str(tmp),
               str(SRC_DIR / f"{src}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    errors = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc rc {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return out


def load(name: str):
    """The ctypes library of kernel `name`, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        target = lib_path(name)
        if not target.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(target))
        for sym, argtypes in _ARGTYPES[_recipe(name)[0]].items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
