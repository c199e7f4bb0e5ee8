// XLA CPU's f32 cube root on the card: core/xlamath.py `cbrt`, for
// CUBIC's window target (tcp.cuh cubic_target).
//
// XLA CPU computes f32 cbrt(x) as copysign(powf(|x|, f32(1/3)), x) with
// the C library's powf: on glibc with FMA, the algorithm of glibc's
// e_powf.c -- log2 from a 16-entry table and a degree-5 polynomial, exp2
// from a 32-entry table and a degree-3 polynomial, both in f64 with FMA
// contraction, one rounding to f32 at the end.  This is that sequence:
// explicit fma() where glibc's build contracts, __dmul_rn / __dadd_rn
// elsewhere (the library builds with --fmad=false as well), glibc's own
// tables in constant memory.  XLA CPU runs with denormals-are-zero, so a
// subnormal input is scaled to 0 and takes the bits 0 - (23 << 23) into
// the log, as the plain version does.  chip_smoke.py holds it to
// xlamath.cbrt on every non-negative f32.
#pragma once
#include <cstdint>

namespace s1 {

// __powf_log2_data (POWF_LOG2_TABLE_BITS = 4): (1/c, log2 c) per
// subinterval, and the log2 polynomial.
__constant__ double c_powf_invc[16] = {
    0x1.661ec79f8f3bep+0, 0x1.571ed4aaf883dp+0, 0x1.49539f0f010b0p+0,
    0x1.3c995b0b80385p+0, 0x1.30d190c8864a5p+0, 0x1.25e227b0b8ea0p+0,
    0x1.1bb4a4a1a343fp+0, 0x1.12358f08ae5bap+0, 0x1.0953f419900a7p+0,
    0x1.0000000000000p+0, 0x1.e608cfd9a47acp-1, 0x1.ca4b31f026aa0p-1,
    0x1.b2036576afce6p-1, 0x1.9c2d163a1aa2dp-1, 0x1.886e6037841edp-1,
    0x1.767dcf5534862p-1};
__constant__ double c_powf_logc[16] = {
    -0x1.efec65b963019p-2, -0x1.b0b6832d4fca4p-2, -0x1.7418b0a1fb77bp-2,
    -0x1.39de91a6dcf7bp-2, -0x1.01d9bf3f2b631p-2, -0x1.97c1d1b3b7af0p-3,
    -0x1.2f9e393af3c9fp-3, -0x1.960cbbf788d5cp-4, -0x1.a6f9db6475fcep-5,
    0x0.0p+0,              0x1.338ca9f24f53dp-4,  0x1.476a9543891bap-3,
    0x1.e840b4ac4e4d2p-3,  0x1.40645f0c6651cp-2,  0x1.88e9c2c1b9ff8p-2,
    0x1.ce0a44eb17bccp-2};
// __exp2f_data (EXP2F_TABLE_BITS = 5): asuint64(2^(i/32)) - (i << 52) / 32.
__constant__ unsigned long long c_exp2f_tab[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,
    0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,
    0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,
    0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,
    0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,
    0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,
    0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,
    0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,
    0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull};

__device__ __forceinline__ float cbrt_xla(float x) {
  constexpr uint32_t OFF = 0x3F330000u;
  constexpr double A0 = 0x1.27616c9496e0bp-2, A1 = -0x1.71969a075c67ap-2,
                   A2 = 0x1.ec70a6ca7baddp-2, A3 = -0x1.7154748bef6c8p-1,
                   A4 = 0x1.71547652ab82bp+0;
  constexpr double SHIFT = 0x1.8p+47;
  constexpr double C0 = 0x1.c6af84b912394p-5, C1 = 0x1.ebfce50fac4f3p-3,
                   C2 = 0x1.62e42ff0c52d6p-1;
  constexpr double THIRD = 0x1.5555560000000p-2;     // f32(1/3)
  const float ax = fabsf(x);
  uint32_t ix = __float_as_uint(ax);
  // Subnormal |x|: denormals-are-zero makes glibc's x * 2^23 zero.
  if (ix > 0u && ix < 0x00800000u) ix = 0u - (23u << 23);
  // log2_inline: |x| = 2^k z, z in [OFF, 2 OFF), table entry i near z.
  const uint32_t tmp = ix - OFF;
  const int i = (int)((tmp >> 19) & 15u);
  const uint32_t top = tmp & 0xFF800000u;
  const uint32_t iz = ix - top;
  const int k = (int)top >> 23;
  const double z = (double)__uint_as_float(iz);
  const double r = fma(z, c_powf_invc[i], -1.0);
  const double y0 = __dadd_rn((double)k, c_powf_logc[i]);
  const double y = fma(r, A0, A1);
  const double p = fma(r, A2, A3);
  const double r2 = __dmul_rn(r, r);
  double q = fma(r, A4, y0);
  const double r4 = __dmul_rn(r2, r2);
  q = fma(r2, p, q);
  const double logx = fma(y, r4, q);
  const double ylogx = __dmul_rn(logx, THIRD);
  // exp2_inline: 2^ylogx = 2^(ki/32) * 2^rr.
  double kd = __dadd_rn(ylogx, SHIFT);
  const unsigned long long ki = (unsigned long long)__double_as_longlong(kd);
  kd = __dsub_rn(kd, SHIFT);
  const double rr = __dsub_rn(ylogx, kd);
  const unsigned long long t = c_exp2f_tab[ki & 31u] + (ki << 47);
  const double s = __longlong_as_double((long long)t);
  const double zz = fma(rr, C0, C1);
  const double rr2 = __dmul_rn(rr, rr);
  double yy = fma(rr, C2, 1.0);
  yy = fma(zz, rr2, yy);
  float out = __double2float_rn(__dmul_rn(yy, s));
  // powf(0) = 0, powf(inf) = inf, powf(nan) = nan (x * x in glibc).
  if (ix == 0u || !isfinite(ax)) out = __fmul_rn(ax, ax);
  return copysignf(out, x);
}

}  // namespace s1
