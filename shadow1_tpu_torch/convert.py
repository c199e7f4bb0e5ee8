"""Carry state across from the JAX package.

`from_jax` turns the JAX package's `SimState` and `NetParams`, given as
nested dicts of numpy arrays keyed by field name (the test side builds
them with `jax.tree_util`), into the port's dataclasses on a device.
`to_numpy` goes the other way for any port dataclass, so a test can
compare the two trees leaf by leaf.  A JAX state that holds a block the
port does not carry (log, cap, lineage, nm, fr, tr, scope, sentinel,
dg, ...) is refused by name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .apps import phold as phold_app
from .core import state as st
from .core.params import NetParams


def _tensor(x, dev, u32=False):
    a = np.asarray(x)
    if u32 or a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(dev)


def _build(cls, d: dict, dev):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            raise KeyError(f"{cls.__name__}.{f.name} missing from the input")
        kw[f.name] = _tensor(d[f.name], dev, f.name in cls.U32_FIELDS)
    return cls(**kw)


def state_from_jax(d: dict, device=None, app_cls=phold_app.PholdState):
    """SimState from the JAX state's nested dict.  `app_cls` is the app
    state dataclass (phold's by default)."""
    dev = resolve_device(device)
    bad = [k for k in st.UNCARRIED_BLOCKS if d.get(k) is not None]
    if bad:
        raise ValueError(f"the port does not carry the SimState block(s) "
                         f"{', '.join(bad)} yet")

    def scalar(name, dtype):
        return torch.tensor(np.asarray(d[name]).item(), dtype=dtype,
                            device=dev)

    return st.SimState(
        now=scalar("now", st.I64),
        pool=_build(st.PacketPool, d["pool"], dev),
        inbox=_build(st.Inbox, d["inbox"], dev),
        socks=_build(st.SocketTable, d["socks"], dev),
        hosts=_build(st.HostTable, d["hosts"], dev),
        app=None if d.get("app") is None else _build(app_cls, d["app"], dev),
        err=scalar("err", st.I32),
        n_steps=scalar("n_steps", st.I64),
        n_windows=scalar("n_windows", st.I64),
        n_events=scalar("n_events", st.I64))


def params_from_jax(d: dict, statics: dict, device=None) -> NetParams:
    """NetParams from the JAX params' leaves (`d`) and statics."""
    dev = resolve_device(device)
    if d.get("hosts_real") is not None:
        raise ValueError("the port does not carry hosts_real (bucket "
                         "padding) yet")
    kw = {}
    for name in NetParams.LEAVES:
        v = np.asarray(d[name])
        if v.ndim == 0 and name != "seed_key":
            kw[name] = int(v)
        elif name == "seed_key":
            kw[name] = v.astype(np.uint32).reshape(-1)
        else:
            kw[name] = _tensor(v, dev)
    for name in NetParams.STATICS:
        kw[name] = statics[name]
    return NetParams(**kw)


# dtypes of NetParams' scalar leaves in the JAX package (the port keeps
# them as Python ints).
_PARAM_SCALAR_DTYPES = {"qdisc": np.int32}


def to_numpy(obj):
    """Nested dict of numpy arrays for a port dataclass, in the JAX
    package's dtypes (uint32 leaves handed back as uint32, NetParams'
    scalar ints as int64 / int32 arrays)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (int, np.ndarray, np.integer)):
        return np.asarray(obj)
    if dataclasses.is_dataclass(obj):
        u32 = getattr(obj, "U32_FIELDS", frozenset())
        out = {}
        names = obj.LEAVES if isinstance(obj, NetParams) else \
            [f.name for f in dataclasses.fields(obj)]
        for name in names:
            v = getattr(obj, name)
            if v is None:
                continue
            a = to_numpy(v)
            if isinstance(obj, NetParams) and isinstance(v, int):
                a = a.astype(_PARAM_SCALAR_DTYPES.get(name, np.int64))
            if name in u32:
                a = a.astype(np.uint32)
            out[name] = a
        return out
    raise TypeError(f"cannot convert {type(obj)}")
