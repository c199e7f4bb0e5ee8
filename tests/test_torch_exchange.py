"""The port's exchange against the JAX package's exchange_call kernel.

The JAX side runs megakernel.exchange_call -- the Pallas kernel, in
interpret mode on the CPU as tests/test_megakernel.py runs it.  The port
side runs its exchange wrapper on CPU tensors, which takes the plain
version (engine._exchange_core), the function the CUDA kernel is held
against on the card.  Pools are random: stages, rows, times and
destinations drawn from a seed with numpy, with one destination
receiving more movers than its slab has free slots, so the drop path
runs.  Every output leaf must be equal."""

import jax
import numpy as np
import pytest

from shadow1_tpu import sim as jsim
from shadow1_tpu.core import megakernel as jmk
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.core import megakernel as tmk

from _torch_parity import assert_same, jax_statics, jax_tree


def _random_world(h, seed, pds_trail):
    """A JAX phold world of h hosts whose outbox and inbox are filled at
    random (narrow UDP layout, 8-slot slabs)."""
    state, params, _app = jsim.build_phold(num_hosts=h,
                                           pool_capacity=h * 8, seed=seed)
    params = params.replace(pds_trail=pds_trail)
    r = np.random.default_rng(seed)
    pool, ib = state.pool, state.inbox
    p0, pc = pool.blk.shape
    p1, _ic = ib.blk.shape
    blk = r.integers(0, 2**31 - 1, (p0, pc), dtype=np.int64).astype(np.int32)
    dst = r.integers(0, h, p0).astype(np.int32)
    dst[r.random(p0) < 0.3] = 3          # destination 3 overflows
    dst[r.random(p0) < 0.02] = -5        # out of range: clipped to 0
    blk[:, pc - 4] = dst
    stage = r.choice(np.array([0, 1, 2], np.int32), p0, p=[0.3, 0.2, 0.5])
    time = r.integers(0, 2**45, p0).astype(np.int64)
    status = r.integers(0, 1024, p0).astype(np.int32)
    iblk = r.integers(0, 2**31 - 1, (p1, ib.blk.shape[1]),
                      dtype=np.int64).astype(np.int32)
    istage = r.choice(np.array([0, 2, 3], np.int32), p1, p=[0.6, 0.3, 0.1])
    istage[8 * 5:8 * 6] = 2              # destination 5's slab is full
    istatus = r.integers(0, 1024, p1).astype(np.int32)
    pool = pool.replace(blk=blk, stage=stage, time=time, status=status)
    ib = ib.replace(blk=iblk, stage=istage, status=istatus)
    return pool, ib, params


@pytest.mark.parametrize("h,seed,pds", [(16, 1, False), (16, 2, True),
                                        (64, 3, False), (64, 4, True)])
def test_exchange_equals_jax_kernel(h, seed, pds):
    pool, ib, params = _random_world(h, seed, pds)
    jout = jax.jit(lambda p, i: jmk.exchange_call(p, i, h, params))(pool, ib)
    tpool = convert._build(convert.st.PacketPool, jax_tree(pool), "cpu")
    tib = convert._build(convert.st.Inbox, jax_tree(ib), "cpu")
    tparams = convert.params_from_jax(jax_tree(params),
                                      jax_statics(params), device="cpu")
    tout = tmk.exchange_call(tpool, tib, h, tparams)
    names = ("pool", "inbox", "total", "total_prot", "n_free")
    port = {n: convert.to_numpy(v) for n, v in zip(names, tout)}
    ref = {n: jax_tree(v) for n, v in zip(names, jout)}
    assert (ref["total"] > ref["n_free"]).any(), "no destination overflowed"
    assert_same(port, ref, f"exchange h={h} seed={seed} pds={pds}")


def _chip_smoke():
    """chip_smoke.py (the repo root's), whose fan-in inputs the card's
    exchange kernel is held to."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fan_in_world(n_movers, slab, taken):
    """A JAX bulk world of 4 hosts with chip_smoke.fan_in_arrays applied:
    about n_movers full-width rows in flight to host 0 from the three
    others, in shuffled flat order with pure ACKs mixed in, into a slab of
    `slab` slots of which a fraction `taken` is taken."""
    f = _chip_smoke().fan_in_arrays(n_movers, slab=slab, taken=taken)
    h, ko = f["h"], f["ko"]
    state, params, _app = jsim.build_bulk(num_hosts=h, pool_capacity=h * ko,
                                          seed=1)
    pool, ib = state.pool, state.inbox
    assert pool.blk.shape[0] == h * ko and ib.blk.shape[0] == h * ko
    blk = np.array(pool.blk)
    pc = blk.shape[1]
    blk[:, 3], blk[:, 4], blk[:, 8] = f["proto"], f["flags"], f["length"]
    blk[:, pc - 4] = f["dst"]
    pool = pool.replace(blk=blk, stage=f["stage"], time=f["time"])
    ib = ib.replace(stage=f["istage"])
    return pool, ib, params


@pytest.mark.parametrize("taken,gate", [(0.5, True), (0.1, False)])
def test_fan_in_exchange_equals_jax_kernel(taken, gate):
    """The TCP fan-in the card's fan-in probe crafts (chip_smoke.py
    check_fan_in), cut to 1,600 movers into a 2,048-slot slab: with half
    the slab taken the destination overflows and the two-class gate is
    on; with a tenth taken every mover fits and it is off."""
    h = 4
    pool, ib, params = _fan_in_world(1_600, 2_048, taken)
    jout = jax.jit(lambda p, i: jmk.exchange_call(p, i, h, params))(pool, ib)
    tpool = convert._build(convert.st.PacketPool, jax_tree(pool), "cpu")
    tib = convert._build(convert.st.Inbox, jax_tree(ib), "cpu")
    tparams = convert.params_from_jax(jax_tree(params),
                                      jax_statics(params), device="cpu")
    tout = tmk.exchange_call(tpool, tib, h, tparams)
    names = ("pool", "inbox", "total", "total_prot", "n_free")
    port = {n: convert.to_numpy(v) for n, v in zip(names, tout)}
    ref = {n: jax_tree(v) for n, v in zip(names, jout)}
    assert ref["total"][0] >= 1_500, "fewer than 1,500 movers to host 0"
    assert bool((ref["total_prot"] < ref["total"]).any()) == gate, \
        "the two-class gate is not as crafted"
    assert_same(port, ref, f"fan-in exchange taken={taken}")
