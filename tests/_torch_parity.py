"""Shared helpers of the tests/test_torch_*.py files: carry JAX-package
states into shadow1_tpu_torch and compare the two trees leaf by leaf."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

# The suite runs several test processes side by side (pytest-xdist); a
# small torch thread pool keeps the port's tests from starving the
# timing-sensitive tests of the other processes.
torch.set_num_threads(2)


def _cpu_vendor() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("vendor_id"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


# XLA CPU computes f32 rsqrt (and CoDel's interval / sqrt(count), which it
# rewrites to a product with rsqrt) from the CPU's own `rsqrtss` estimate,
# which differs between vendors.  The port reproduces Intel's estimate
# (core/xlamath.py), so the JAX reference it is held to exists only on an
# Intel host.
needs_intel_rsqrt = pytest.mark.skipif(
    _cpu_vendor() != "GenuineIntel",
    reason="the JAX reference's f32 rsqrt is the host CPU's rsqrtss "
           "estimate; the port reproduces Intel's, and this CPU is not "
           "Intel")


def jax_tree(obj):
    """Nested dict of numpy arrays for a flax struct dataclass (None
    fields dropped), the input format of shadow1_tpu_torch.convert."""
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            if not f.metadata.get("pytree_node", True):
                continue
            v = getattr(obj, f.name)
            if v is not None:
                out[f.name] = jax_tree(v)
        return out
    return np.asarray(obj)


def jax_statics(params) -> dict:
    return {f.name: getattr(params, f.name)
            for f in dataclasses.fields(params)
            if not f.metadata.get("pytree_node", True)}


def first_difference(a, b, path="") -> str | None:
    """Path and values of the first leaf where two nested dicts differ
    (value, dtype or shape), or None when they are equal."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)):
            return f"{path}: one side is a subtree, the other a leaf"
        if sorted(a) != sorted(b):
            return f"{path}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            d = first_difference(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return (f"{path}: shape/dtype {a.shape} {a.dtype} != "
                f"{b.shape} {b.dtype}")
    if a.dtype.kind == "f":
        same = np.array_equal(a.view(f"u{a.itemsize}"),
                              b.view(f"u{b.itemsize}"))
    else:
        same = np.array_equal(a, b)
    if not same:
        idx = np.argwhere(np.asarray(a != b).reshape(a.shape) if a.ndim
                          else np.asarray([a != b]))[:3].tolist()
        return f"{path}: differs at {idx}: {a.reshape(-1)[:8]} vs " \
               f"{b.reshape(-1)[:8]}"
    return None


def assert_same(port_tree: dict, jax_tree_: dict, label: str) -> None:
    d = first_difference(port_tree, jax_tree_)
    assert d is None, f"{label}: first differing leaf {d}"
