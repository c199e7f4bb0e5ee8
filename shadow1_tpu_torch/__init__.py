"""shadow1_tpu_torch: the PyTorch/CUDA port of shadow1_tpu.

The JAX package (`shadow1_tpu/`) is the reference; this package mirrors
its layout module for module (`core/state.py`, `core/engine.py`, ...) and
holds every leaf bitwise against it.  It imports torch and numpy only --
never jax, flax or anything of `shadow1_tpu`.

Scope so far: Shadow's shadow.config.xml worlds whose processes are the
modeled tgen, through `python -m shadow1_tpu_torch run CONFIG` (`cli.py`:
`config/` parses and assembles them, `routing/` holds DNS, GraphML and
the APSP routing with per-edge jitter, `observe.py` writes heartbeat.csv
and summary.json); and the phold (UDP), bulk and tgen (TCP, Reno) worlds
of `sim.build_phold` / `build_bulk` / `build_tgen`, driven through
`core.engine.run_until` / `run_chunked`; with every Pallas kernel of the
JAX package as a hand-written CUDA kernel for sm_90a (`csrc/`):
K_WINDOW, one cooperative launch per window with the app's tick as device
code (the default, `persistent`; phold's tick, or bulk's with the TCP
timers), and the per-phase window-boundary exchange, K_DELIVER and
K_TRANSPORT.  Blocks of
`SimState` the port does not carry yet (log, cap, lineage, nm, fr, tr,
scope, sentinel, dg) are refused by name wherever they would be needed.

Conventions kept from the JAX package at every public function, so the
tests compare like with like:

* time is int64 nanoseconds; packed slabs are int32 (`blk`), with int64
  fields split into 31-bit `enc_lo`/`enc_hi` column pairs;
* uint32 leaves of the JAX state (rng counters, TCP sequence numbers) are
  held in int64 tensors masked to 32 bits: torch's CPU kernels lack `+`
  and `>>` on `torch.uint32`.  `convert.to_numpy` maps them back.

Entry points take `device=None`, which means the CUDA card; with no card
present that call raises.  Nothing falls back to the CPU on its own --
callers (the tests) pass `device="cpu"` explicitly.
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
TIME_DTYPE = I64


class NoDeviceError(RuntimeError):
    """CUDA was asked for and no card is present."""


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card.  Raises NoDeviceError when CUDA is
    asked for and no card is present; never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            "shadow1_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain torch path")
    return dev


def build_kernels() -> dict:
    """Build every CUDA kernel library of the package that is not built
    yet (nvcc's output goes to shadow1_tpu_torch/_build/<name>.log).
    Returns {name: seconds spent building}."""
    from .core import _build
    return _build.build_all()


__version__ = "0.1.0"
