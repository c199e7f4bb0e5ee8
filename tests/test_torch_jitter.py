"""Per-packet jitter in the port's staging against the JAX package (CPU).

* `engine._route` with jitter equals the JAX `_route` on 2^20 seeded
  (pair, src, counter) inputs: every (latency, jitter) pair of a
  1,024-vertex route table, with jitter 0, jitter = latency - 1, jitter
  above the latency (the 1 ns clamp), latencies up to 10^12 ns and
  counters past 2^32;
* a jittered, lossy phold world (16 hosts on 4 vertices, some pairs
  without jitter) equals the JAX package's leaf for leaf after 1.5
  simulated seconds, on the port's persistent path (window_call) and on
  its per-phase path; the world really draws nonzero deltas.

The CUDA staging's draw (csrc/transport.cuh `jittered`) is held against
these plain versions on the card by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu import sim as jsim
from shadow1_tpu.core import engine as jeng
from shadow1_tpu.core import params as jparams
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import sim as tsim
from shadow1_tpu_torch.core import engine as teng
from shadow1_tpu_torch.core import params as tparams
from shadow1_tpu_torch.core.state import (ICOL_SRC, OEXT_LAT_HI,
                                          OEXT_LAT_LO, dec_i64, ext_base)

from _torch_parity import assert_same, jax_tree

MS = 1_000_000
SEC = 1_000_000_000


def _route_table(v: int = 1024, seed: int = 11):
    """[V,V] latency (i64 ns), jitter (i64 ns), reliability (f32)."""
    rng = np.random.default_rng(seed)
    n = v * v
    scale = rng.choice([10, 1_000, 10**6, 10**9, 10**12], n)
    lat = np.maximum(1, (rng.random(n) * scale).astype(np.int64))
    kind = rng.integers(0, 5, n)
    jit = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [np.zeros(n, np.int64), lat - 1,
         (rng.random(n) * lat).astype(np.int64),
         lat + rng.integers(1, 10**6, n)],
        rng.integers(0, 1 << 40, n))
    rel = rng.random(n).astype(np.float32)
    return (lat.reshape(v, v), np.maximum(jit, 0).reshape(v, v),
            rel.reshape(v, v))


def test_route_jitter_equals_jax():
    v = 1024
    lat, jit, rel = _route_table(v)
    common = dict(latency_ns=lat, reliability=rel, host_vertex=[0, 1],
                  bw_up_Bps=[1, 1], bw_down_Bps=[1, 1], seed=11,
                  jitter_ns=jit)
    jp = jparams.make_net_params(**common)
    tp = tparams.make_net_params(**common, device="cpu")
    assert jp.has_jitter and tp.has_jitter
    assert np.array_equal(tp.route_blk.numpy(), np.asarray(jp.route_blk))
    rng = np.random.default_rng(12)
    pair = np.arange(v * v)
    vs, vd = pair // v, pair % v
    src = rng.integers(0, 1 << 31, v * v).astype(np.int32)
    ctr = rng.integers(0, 1 << 40, v * v)
    jl, jr = jax.jit(jeng._route)(jp, jnp.asarray(vs, jnp.int32),
                                  jnp.asarray(vd, jnp.int32),
                                  jnp.asarray(src), jnp.asarray(ctr))
    tl, tr = teng._route(tp, torch.from_numpy(vs), torch.from_numpy(vd),
                         torch.from_numpy(src).to(torch.int64),
                         torch.from_numpy(ctr))
    jl, jr = np.asarray(jl), np.asarray(jr)
    assert np.array_equal(tl.numpy(), jl)
    assert np.array_equal(tr.numpy().view(np.uint32), jr.view(np.uint32))
    lat_f, jit_f = lat.reshape(-1), jit.reshape(-1)
    moved = jl != np.maximum(lat_f, 1)
    assert moved.sum() > v * v // 3                 # deltas were drawn
    assert (jl[jit_f == 0] == np.maximum(lat_f[jit_f == 0], 1)).all()
    assert ((jl == 1) & (jit_f > lat_f)).any()      # the 1 ns clamp
    assert (jit_f == lat_f - 1).sum() > v * v // 8


def _jittered_worlds(persistent: bool):
    """A 16-host phold world on 4 vertices with per-pair jitter (0 on a
    quarter of the pairs) and 3 % loss, from both packages."""
    h, v = 16, 4
    rng = np.random.default_rng(21)
    lat = rng.integers(5 * MS, 20 * MS, (v, v))
    lat = np.minimum(lat, lat.T)
    jit = np.where(rng.random((v, v)) < 0.25, 0,
                   rng.integers(0, 4 * MS, (v, v)))
    rel = np.full((v, v), 0.97, np.float32)
    kw = dict(num_hosts=h, msgs_per_host=2, pool_capacity=h * 8, seed=9,
              stop_time=2 * SEC)
    net = dict(latency_ns=lat, reliability=rel,
               host_vertex=np.arange(h) % v, bw_up_Bps=np.full(h, 1 << 30),
               bw_down_Bps=np.full(h, 1 << 30), seed=9, stop_time=2 * SEC,
               jitter_ns=jit)
    js, _, ja = jsim.build_phold(**kw)
    jp = jparams.make_net_params(**net).replace(megakernel=False)
    ts, _, ta = tsim.build_phold(**kw, persistent=persistent, device="cpu")
    tp = tparams.make_net_params(**net, persistent=persistent, device="cpu")
    return (js, jp, ja), (ts, tp, ta)


@functools.lru_cache(maxsize=None)
def _jax_jittered():
    (js, jp, ja), _ = _jittered_worlds(True)
    return jeng.run_until(js, jp, ja, 1500 * MS)


@pytest.mark.parametrize("persistent", [True, False])
def test_jittered_world_equals_jax(persistent):
    (js, jp, _), (ts, tp, ta) = _jittered_worlds(persistent)
    assert_same(convert.to_numpy(tp), jax_tree(jp), "jittered params")
    assert tp.has_jitter and tp.has_loss and tp.persistent is persistent
    tout = teng.run_until(ts, tp, ta, 1500 * MS)
    jout = _jax_jittered()
    assert int(jout.app.recv.sum()) > 100, "no traffic simulated"
    assert int(jout.hosts.pkts_dropped_inet.sum()) > 0
    assert_same(convert.to_numpy(tout), jax_tree(jout),
                f"jittered phold persistent={persistent}")
    # The world drew nonzero deltas: the latency staged into some written
    # outbox row is off its pair's base latency.
    blk = tout.pool.blk
    xb = ext_base(blk.shape[1])
    staged = dec_i64(blk[:, xb + OEXT_LAT_LO], blk[:, xb + OEXT_LAT_HI])
    hv = tp.host_vertex.long()
    base, _ = tp.route_narrow(hv[blk[:, ICOL_SRC].long()],
                              hv[tout.pool.dst.long().clamp(0, 15)])
    written = staged > 0
    assert written.sum() > 16
    assert (staged[written] != base[written]).sum() > written.sum() // 2
