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
