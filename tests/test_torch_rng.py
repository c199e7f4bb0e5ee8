"""The port's random draws against the JAX package, exactly.

* threefry `root_key`/`purpose_key`/`world_key` (numpy, host side) equal
  `jax.random.key_data` of PRNGKey/fold_in over a sweep of seeds,
  purposes and world ids;
* `keyed_bits`/`keyed_uniform` on int64-held uint32 equal rng.py's on
  random ids;
* the f64 log1p of phold's delay draw (core/xlamath.py) equals the JAX
  package's jnp.log1p, bit for bit, on all 2^24 inputs keyed_uniform can
  produce (k * 2^-24), and so does the int64 delay at the bench mean;
* XLA CPU's f32 rsqrt (the rsqrtss estimate + two Newton steps) on
  random positive floats, and CoDel's drop spacing on every count in
  [1, 2^20].  The estimate is the host CPU's own; the port reproduces
  Intel's, so this check runs on Intel hosts only;
* XLA CPU's f32 cbrt (glibc's FMA powf with exponent f32(1/3)), on the
  5,242,880 samples where torch's pow(x, 1/3) differs from it 107,584
  times, and (slow) on every finite non-negative f32 up to 2^21.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu.core import rng as jrng
from shadow1_tpu_torch.apps import phold as tphold
from shadow1_tpu_torch.core import nic as tnic
from shadow1_tpu_torch.core import rng as trng
from shadow1_tpu_torch.core import xlamath

from _torch_parity import needs_intel_rsqrt

SEEDS = [0, 1, 2, 7, 11, 42, 12345, 2**31 - 1, 2**32 - 1, 2**32, 2**40 + 3,
         -1, -12345]


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_equal_jax(seed):
    jk = jrng.root_key(seed)
    tk = trng.root_key(seed)
    np.testing.assert_array_equal(tk, np.asarray(jax.random.key_data(jk)))
    for purpose in range(1, 9):
        np.testing.assert_array_equal(
            trng.purpose_key(tk, purpose),
            np.asarray(jax.random.key_data(jrng.purpose_key(jk, purpose))),
            err_msg=f"seed {seed} purpose {purpose}")
    for world in (0, 1, 2, 5, 1000):
        np.testing.assert_array_equal(
            trng.world_key(tk, world),
            np.asarray(jax.random.key_data(jrng.world_key(jk, world))),
            err_msg=f"seed {seed} world {world}")


@pytest.mark.parametrize("purpose", [trng.PURPOSE_PACKET_DROP,
                                     trng.PURPOSE_HOST_APP])
def test_keyed_bits_and_uniform_equal_jax(purpose):
    r = np.random.default_rng(purpose)
    n = 4096
    a = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    b = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    c = np.int64(r.integers(0, 2**40))
    for seed in (1, 7, 99):
        jk = jrng.purpose_key(jrng.root_key(seed), purpose)
        words = trng.key_words(trng.purpose_key(trng.root_key(seed),
                                                purpose))
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        ta = torch.from_numpy(a.astype(np.int64))
        tb = torch.from_numpy(b.astype(np.int64))
        for ids_j, ids_t in (((ja,), (ta,)),
                             ((ja, jb), (ta, tb)),
                             ((ja, jb, jnp.uint32(c & 0xFFFFFFFF)),
                              (ta, tb, int(c)))):
            jbits = np.asarray(jrng.keyed_bits(jk, *ids_j))
            tbits = trng.keyed_bits(words, *ids_t).numpy()
            np.testing.assert_array_equal(tbits.astype(np.uint32), jbits)
            assert (tbits >= 0).all() and (tbits < 2**32).all()
            ju = np.asarray(jrng.keyed_uniform(jk, *ids_j))
            tu = trng.keyed_uniform(words, *ids_t).numpy()
            assert tu.dtype == np.float32
            np.testing.assert_array_equal(tu.view(np.uint32),
                                          ju.view(np.uint32))


def test_log1p_f64_all_keyed_uniform_inputs():
    """All 2^24 values k * 2^-24: the f64 log1p, and the int64 delay at
    the bench world's 10 ms mean, equal the JAX package's bit for bit."""
    k = np.arange(1 << 24, dtype=np.int64)
    u = k.astype(np.float64) * (1.0 / (1 << 24))
    ref = np.asarray(jax.jit(lambda v: jnp.log1p(-v))(jnp.asarray(u)))
    out = np.empty_like(ref)
    step = 1 << 16
    for lo in range(0, 1 << 24, step):
        out[lo:lo + step] = xlamath.log1p(
            -torch.from_numpy(u[lo:lo + step])).numpy()
    bad = np.flatnonzero(out.view(np.int64) != ref.view(np.int64))
    assert bad.size == 0, (f"f64 log1p differs on {bad.size} inputs, "
                           f"first k = {bad[:5].tolist()}")
    # The delay draw built on it: the k the roadmap found torch.log1p
    # moving by 1 ns, plus a random sample.
    ks = np.concatenate([[0, 1, 6_759_219, (1 << 24) - 1],
                         np.random.default_rng(3).integers(0, 1 << 24,
                                                           1 << 16)])
    uk = jnp.asarray(u[ks]).astype(jnp.float32)
    ref_delay = np.asarray(jnp.maximum(
        (-jnp.log1p(-uk.astype(jnp.float64)) * 10_000_000)
        .astype(jnp.int64), 1))
    delay = tphold._delay_from_u(torch.from_numpy(u[ks]).float(),
                                 10_000_000).numpy()
    np.testing.assert_array_equal(delay, ref_delay)


@needs_intel_rsqrt
def test_rsqrt_and_codel_spacing_equal_jax():
    """XLA rewrites CoDel's f32 interval / sqrt(count) to interval *
    rsqrt(count); the port reproduces XLA CPU's rsqrt bit for bit."""
    cnt = np.arange(1, 1 << 20, dtype=np.int32)
    ref = np.asarray(jax.jit(lambda c: (
        100_000_000 / jnp.sqrt(jnp.maximum(c, 1).astype(jnp.float32)))
        .astype(jnp.int64))(jnp.asarray(cnt)))
    np.testing.assert_array_equal(
        tnic.codel_spacing(torch.from_numpy(cnt)).numpy(), ref)
    bits = np.random.default_rng(0).integers(
        0x00800000, 0x7F800000, 1 << 18).astype(np.uint32)
    x = bits.view(np.float32)
    jr = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    tr = xlamath.rsqrt(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(tr.view(np.uint32), jr.view(np.uint32))


def _cbrt_mismatches(x: np.ndarray) -> int:
    ref = np.asarray(jax.jit(jnp.cbrt)(jnp.asarray(x)))
    out = xlamath.cbrt(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32
    return int((out.view(np.uint32) != ref.view(np.uint32)).sum())


def test_cbrt_f32_equals_jax():
    """2^20 grid points at step 0.25 plus 2^22 uniform draws in [0, 1e7):
    torch.pow(x, 1/3) differs from jnp.cbrt on 107,584 of them, the port's
    cbrt on none; plus signed zeros, infinities, NaN, subnormals (XLA CPU
    treats them as zero) and negative inputs."""
    grid = np.arange(1 << 20, dtype=np.float32) * np.float32(0.25)
    uni = np.random.default_rng(0).uniform(0, 1e7, 1 << 22)
    x = np.concatenate([grid, uni.astype(np.float32)])
    assert x.size == 5_242_880
    assert _cbrt_mismatches(x) == 0
    odd = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 1e-40,
                    1.17e-38, -8.0, -1e-3, 3.4e38, 1.0, 27.0], np.float32)
    assert _cbrt_mismatches(np.concatenate([odd, -x[:4096]])) == 0


@pytest.mark.slow
def test_cbrt_f32_every_input_cubic_takes():
    """Every finite non-negative f32 up to 2^21 (bit patterns 0 ..
    0x4A000000).  CUBIC's K is cbrt(wmax_seg * 0.3 / 0.4) with wmax_seg
    an int32 cwnd over the 1460-byte MSS (transport/cong.py:86), so its
    argument stays below 1.1e6."""
    top = 0x4A000000
    step = 1 << 23
    for lo in range(0, top + 1, step):
        bits = np.arange(lo, min(lo + step, top + 1), dtype=np.uint32)
        n = _cbrt_mismatches(bits.view(np.float32))
        assert n == 0, f"cbrt differs on {n} inputs in [{lo:#x}, +{step:#x})"
