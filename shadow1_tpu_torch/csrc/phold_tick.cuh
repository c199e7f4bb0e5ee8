// phold's on_tick as device code, one host per thread, for K_WINDOW
// (window.cu), with the exact f64 log1p of its delay draw.
//
// phold_tick follows shadow1_tpu_torch/apps/phold.py `on_tick` (itself
// the JAX shadow1_tpu/apps/phold.py:133ff) for one host: pop up to
// max(2, rx_batch) datagrams from its socket ring (udp.pop_ring), each
// becoming a pending message with a keyed exponential delay; bound the
// send batch by the host's next live inbox arrival; then run the
// `app_tx_lanes` send lanes, each staging one packet (emit.put) in lane
// SLOT_APP + k of the host's staging rows.  Draws are keyed by (host,
// draw counter, 1 or 2) with rng.keyed_uniform's mix32 hash, so drawing
// only the values a tick uses gives the same values as the torch
// version's batch.
//
// log1p_xla is XLA CPU's f64 log1p (core/xlamath.py): the Cephes
// rational approximation with FMA-contracted Horner steps for |x| <
// sqrt(2) - 1, else glibc's FMA `log` (e_log.c, 128-entry table, five
// FMAs) of 1 + x.  Each FMA there is a native fma() here; every other
// operation is an explicitly rounded intrinsic, and the build passes
// --fmad=false, so nothing else contracts.
#pragma once
#include "deliver.cuh"

namespace s1 {

constexpr int SLOT_APP = 2;          // core/emit.py
constexpr int PHOLD_PORT = 9000;
constexpr int PHOLD_MSG_BYTES = 64;

// Mirrored field for field by the ctypes.Structure in
// shadow1_tpu_torch/core/megakernel.py.
struct PholdArgs {
  int64_t* next_send;
  int32_t* pending;
  int64_t* sent;
  int64_t* recv;
  int64_t* rng_ctr;
  int64_t mean_delay_ns;
  uint32_t k0, k1;         // PURPOSE_HOST_APP key words
  int32_t sock_slot, rx_batch, lanes, n_hosts;
};

// glibc e_log.c data (__log_data, LOG_TABLE_BITS = 7).
__constant__ double c_log_invc[128] = {
    0x1.734f0c3e0de9fp+0, 0x1.713786a2ce91fp+0, 0x1.6f26008fab5a0p+0,
    0x1.6d1a61f138c7dp+0, 0x1.6b1490bc5b4d1p+0, 0x1.69147332f0cbap+0,
    0x1.6719f18224223p+0, 0x1.6524f99a51ed9p+0, 0x1.63356aa8f24c4p+0,
    0x1.614b36b9ddc14p+0, 0x1.5f66452c65c4cp+0, 0x1.5d867b5912c4fp+0,
    0x1.5babccb5b90dep+0, 0x1.59d61f2d91a78p+0, 0x1.5805612465687p+0,
    0x1.56397cee76bd3p+0, 0x1.54725e2a77f93p+0, 0x1.52aff42064583p+0,
    0x1.50f22dbb2bddfp+0, 0x1.4f38f4734ded7p+0, 0x1.4d843cfde2840p+0,
    0x1.4bd3ec078a3c8p+0, 0x1.4a27fc3e0258ap+0, 0x1.4880524d48434p+0,
    0x1.46dce1b192d0bp+0, 0x1.453d9d3391854p+0, 0x1.43a2744b4845ap+0,
    0x1.420b54115f8fbp+0, 0x1.40782da3ef4b1p+0, 0x1.3ee8f5d57fe8fp+0,
    0x1.3d5d9a00b4ce9p+0, 0x1.3bd60c010c12bp+0, 0x1.3a5242b75dab8p+0,
    0x1.38d22cd9fd002p+0, 0x1.3755bc5847a1cp+0, 0x1.35dce49ad36e2p+0,
    0x1.34679984dd440p+0, 0x1.32f5cceffcb24p+0, 0x1.3187775a10d49p+0,
    0x1.301c8373e3990p+0, 0x1.2eb4ebb95f841p+0, 0x1.2d50a0219a9d1p+0,
    0x1.2bef9a8b7fd2ap+0, 0x1.2a91c7a0c1babp+0, 0x1.293726014b530p+0,
    0x1.27dfa5757a1f5p+0, 0x1.268b39b1d3bbfp+0, 0x1.2539d838ff5bdp+0,
    0x1.23eb7aac9083bp+0, 0x1.22a012ba940b6p+0, 0x1.2157996cc4132p+0,
    0x1.201201dd2fc9bp+0, 0x1.1ecf4494d480bp+0, 0x1.1d8f5528f6569p+0,
    0x1.1c52311577e7cp+0, 0x1.1b17c74cb26e9p+0, 0x1.19e010c2c1ab6p+0,
    0x1.18ab07bb670bdp+0, 0x1.1778a25efbcb6p+0, 0x1.1648d354c31dap+0,
    0x1.151b990275fddp+0, 0x1.13f0ea432d24cp+0, 0x1.12c8b7210f9dap+0,
    0x1.11a3028ecb531p+0, 0x1.107fbda8434afp+0, 0x1.0f5ee0f4e6bb3p+0,
    0x1.0e4065d2a9fcep+0, 0x1.0d244632ca521p+0, 0x1.0c0a77ce2981ap+0,
    0x1.0af2f83c636d1p+0, 0x1.09ddb98a01339p+0, 0x1.08cabaf52e7dfp+0,
    0x1.07b9f2f4e28fbp+0, 0x1.06ab58c358f19p+0, 0x1.059eea5ecf92cp+0,
    0x1.04949cdd12c90p+0, 0x1.038c6c6f0ada9p+0, 0x1.02865137932a9p+0,
    0x1.0182427ea7348p+0, 0x1.008040614b195p+0, 0x1.fe01ff726fa1ap-1,
    0x1.fa11cc261ea74p-1, 0x1.f6310b081992ep-1, 0x1.f25f63ceeadcdp-1,
    0x1.ee9c8039113e7p-1, 0x1.eae8078cbb1abp-1, 0x1.e741aa29d0c9bp-1,
    0x1.e3a91830a99b5p-1, 0x1.e01e009609a56p-1, 0x1.dca01e577bb98p-1,
    0x1.d92f20b7c9103p-1, 0x1.d5cac66fb5ccep-1, 0x1.d272caa5ede9dp-1,
    0x1.cf26e3e6b2ccdp-1, 0x1.cbe6da2a77902p-1, 0x1.c8b266d37086dp-1,
    0x1.c5894bd5d5804p-1, 0x1.c26b533bb9f8cp-1, 0x1.bf583eeece73fp-1,
    0x1.bc4fd75db96c1p-1, 0x1.b951e0c864a28p-1, 0x1.b65e2c5ef3e2cp-1,
    0x1.b374867c9888bp-1, 0x1.b094b211d304ap-1, 0x1.adbe885f2ef7ep-1,
    0x1.aaf1d31603da2p-1, 0x1.a82e63fd358a7p-1, 0x1.a5740ef09738bp-1,
    0x1.a2c2a90ab4b27p-1, 0x1.a01a01393f2d1p-1, 0x1.9d79f24db3c1bp-1,
    0x1.9ae2505c7b190p-1, 0x1.9852ef297ce2fp-1, 0x1.95cbaeea44b75p-1,
    0x1.934c69de74838p-1, 0x1.90d4f2f6752e6p-1, 0x1.8e6528effd79dp-1,
    0x1.8bfce9fcc007cp-1, 0x1.899c0dabec30ep-1, 0x1.87427aa2317fbp-1,
    0x1.84f00acb39a08p-1, 0x1.82a49e8653e55p-1, 0x1.8060195f40260p-1,
    0x1.7e22563e0a329p-1, 0x1.7beb377dcb5adp-1, 0x1.79baa679725c2p-1,
    0x1.77907f2170657p-1, 0x1.756cadbd6130cp-1};
__constant__ double c_log_logc[128] = {
    -0x1.7cc7f79e69000p-2, -0x1.76feec20d0000p-2, -0x1.713e31351e000p-2,
    -0x1.6b85b38287800p-2, -0x1.65d5590807800p-2, -0x1.602d076180000p-2,
    -0x1.5a8ca86909000p-2, -0x1.54f4356035000p-2, -0x1.4f637c36b4000p-2,
    -0x1.49da7fda85000p-2, -0x1.445923989a800p-2, -0x1.3edf439b0b800p-2,
    -0x1.396ce448f7000p-2, -0x1.3401e17bda000p-2, -0x1.2e9e2ef468000p-2,
    -0x1.2941b3830e000p-2, -0x1.23ec58cda8800p-2, -0x1.1e9e129279000p-2,
    -0x1.1956d2b48f800p-2, -0x1.141679ab9f800p-2, -0x1.0edd094ef9800p-2,
    -0x1.09aa518db1000p-2, -0x1.047e65263b800p-2, -0x1.feb224586f000p-3,
    -0x1.f474a7517b000p-3, -0x1.ea4443d103000p-3, -0x1.e020d44e9b000p-3,
    -0x1.d60a22977f000p-3, -0x1.cc00104959000p-3, -0x1.c202956891000p-3,
    -0x1.b81178d811000p-3, -0x1.ae2c9ccd3d000p-3, -0x1.a45402e129000p-3,
    -0x1.9a877681df000p-3, -0x1.90c6d69483000p-3, -0x1.87120a645c000p-3,
    -0x1.7d68fb4143000p-3, -0x1.73cb83c627000p-3, -0x1.6a39a9b376000p-3,
    -0x1.60b3154b7a000p-3, -0x1.5737d76243000p-3, -0x1.4dc7b8fc23000p-3,
    -0x1.4462c51d20000p-3, -0x1.3b08abc830000p-3, -0x1.31b996b490000p-3,
    -0x1.2875490a44000p-3, -0x1.1f3b9f879a000p-3, -0x1.160c8252ca000p-3,
    -0x1.0ce7f57f72000p-3, -0x1.03cdc49fea000p-3, -0x1.f57bdbc4b8000p-4,
    -0x1.e370896404000p-4, -0x1.d17983ef94000p-4, -0x1.bf9674ed8a000p-4,
    -0x1.adc79202f6000p-4, -0x1.9c0c3e7288000p-4, -0x1.8a646b372c000p-4,
    -0x1.78d01b3ac0000p-4, -0x1.674f145380000p-4, -0x1.55e0e6d878000p-4,
    -0x1.4485cdea1e000p-4, -0x1.333d94d6aa000p-4, -0x1.22079f8c56000p-4,
    -0x1.10e4698622000p-4, -0x1.ffa6c6ad20000p-5, -0x1.dda8d4a774000p-5,
    -0x1.bbcece4850000p-5, -0x1.9a1894012c000p-5, -0x1.788583302c000p-5,
    -0x1.5715e67d68000p-5, -0x1.35c8a49658000p-5, -0x1.149e364154000p-5,
    -0x1.e72c082eb8000p-6, -0x1.a55f152528000p-6, -0x1.63d62cf818000p-6,
    -0x1.228fb8caa0000p-6, -0x1.c317b20f90000p-7, -0x1.419355daa0000p-7,
    -0x1.81203c2ec0000p-8, -0x1.0040979240000p-9, 0x1.feff384900000p-9,
    0x1.7dc41353d0000p-7, 0x1.3cea3c4c28000p-6, 0x1.b9fc114890000p-6,
    0x1.1b0d8ce110000p-5, 0x1.58a5bd001c000p-5, 0x1.95c8340d88000p-5,
    0x1.d276aef578000p-5, 0x1.07598e598c000p-4, 0x1.253f5e30d2000p-4,
    0x1.42edd8b380000p-4, 0x1.606598757c000p-4, 0x1.7da76356a0000p-4,
    0x1.9ab434e1c6000p-4, 0x1.b78c7bb0d6000p-4, 0x1.d431332e72000p-4,
    0x1.f0a3171de6000p-4, 0x1.067152b914000p-3, 0x1.147858292b000p-3,
    0x1.2266ecdca3000p-3, 0x1.303d7a6c55000p-3, 0x1.3dfc33c331000p-3,
    0x1.4ba366b7a8000p-3, 0x1.5933928d1f000p-3, 0x1.66acd2418f000p-3,
    0x1.740f8ec669000p-3, 0x1.815c0f51af000p-3, 0x1.8e92954f68000p-3,
    0x1.9bb3602f84000p-3, 0x1.a8bed1c2c0000p-3, 0x1.b5b515c01d000p-3,
    0x1.c2967ccbcc000p-3, 0x1.cf635d5486000p-3, 0x1.dc1bd3446c000p-3,
    0x1.e8c01b8cfe000p-3, 0x1.f5509c0179000p-3, 0x1.00e6c121fb800p-2,
    0x1.071b80e93d000p-2, 0x1.0d46b9e867000p-2, 0x1.13687334bd000p-2,
    0x1.1980d67234800p-2, 0x1.1f8ffe0cc8000p-2, 0x1.2595fd7636800p-2,
    0x1.2b9300914a800p-2, 0x1.3187210436000p-2, 0x1.377266dec1800p-2,
    0x1.3d54ffbaf3000p-2, 0x1.432eee32fe000p-2};

// glibc's `log` (FMA build), main path: positive normal x outside
// [1 - 2^-4, 1 + 0x1.09p-4), the only range log1p_xla hands it.
__device__ __forceinline__ double log_glibc(double x) {
  constexpr int64_t OFF = 0x3fe6000000000000LL;
  constexpr double LN2_HI = 0x1.62e42fefa3800p-1;
  constexpr double LN2_LO = 0x1.ef35793c76730p-45;
  constexpr double A0 = -0x1.0000000000001p-1, A1 = 0x1.555555551305bp-2;
  constexpr double A2 = -0x1.fffffffeb4590p-3, A3 = 0x1.999b324f10111p-3;
  constexpr double A4 = -0x1.55575e506c89fp-3;
  const int64_t ix = __double_as_longlong(x);
  const int64_t tmp = ix - OFF;
  const int i = (int)((tmp >> 45) & 0x7F);
  const int64_t k = tmp >> 52;                 // arithmetic shift
  const double z = __longlong_as_double(
      ix - (tmp & (int64_t)0xFFF0000000000000ULL));
  const double kd = (double)k;
  const double r = fma(z, c_log_invc[i], -1.0);
  const double w = fma(kd, LN2_HI, c_log_logc[i]);
  const double hi = __dadd_rn(r, w);
  const double lo = fma(kd, LN2_LO, __dadd_rn(__dsub_rn(w, hi), r));
  const double r2 = __dmul_rn(r, r);
  const double q1 = fma(r, A2, A1);
  const double q2 = fma(r, A4, A3);
  const double t = fma(r2, A0, lo);
  const double r3 = __dmul_rn(r, r2);
  const double p = fma(q2, r2, q1);
  return __dadd_rn(fma(r3, p, t), hi);
}

// XLA CPU's f64 log1p, for x > -1.
__device__ __forceinline__ double log1p_xla(double x) {
  constexpr double NUM[7] = {
    0x1.7bc0962b395cap-15, 0x1.fe818a0fe1a83p-2, 0x1.a509f46f4fa53p+2,
    0x1.de9738b8cb9c9p+4, 0x1.e798eb86c3351p+5, 0x1.c8e7597479a10p+5,
    0x1.40a202d99830ap+4};
  constexpr double DEN[7] = {
    0x1.0000000000000p+0, 0x1.e20359e903e37p+3, 0x1.4c30b52213498p+6,
    0x1.bb86590fcfb56p+7, 0x1.351945dc908a5p+8, 0x1.b0db13e48e066p+7,
    0x1.e0f304466448ep+5};
  constexpr double SMALL = 0x1.a827999fcef32p-2;   // sqrt(2) - 1
  if (fabs(x) >= SMALL) return log_glibc(__dadd_rn(1.0, x));
  double pd = fma(x, DEN[0], DEN[1]);
  double pn = fma(x, NUM[0], NUM[1]);
#pragma unroll
  for (int j = 2; j < 7; ++j) {
    pd = fma(x, pd, DEN[j]);
    pn = fma(x, pn, NUM[j]);
  }
  const double x2 = __dmul_rn(x, x);
  return __dadd_rn(__dadd_rn(__dmul_rn(__dmul_rn(x2, x), __ddiv_rn(pn, pd)),
                             __dmul_rn(x2, -0.5)),
                   x);
}

// phold _delay: max(int64(-log1p(-u) * mean), 1), u keyed (host, ctr, 1).
__device__ __forceinline__ int64_t phold_delay(const PholdArgs& p, int hh,
                                               uint32_t ctr) {
  const float u = keyed_uniform3(p.k0, p.k1, (uint32_t)hh, ctr, 1u);
  const double d = __dmul_rn(-log1p_xla(-(double)u), (double)p.mean_delay_ns);
  const int64_t di = __double2ll_rz(d);
  return di > 1 ? di : 1;
}

// phold _pick_dst: a uniform other host, u keyed (host, ctr, 2); the f32
// product u * (n - 1) truncated as the JAX astype does.
__device__ __forceinline__ int32_t phold_pick_dst(const PholdArgs& p, int hh,
                                                  uint32_t ctr) {
  const float u = keyed_uniform3(p.k0, p.k1, (uint32_t)hh, ctr, 2u);
  int32_t scaled = __float2int_rz(__fmul_rn(u, (float)(p.n_hosts - 1)));
  if (scaled > p.n_hosts - 2) scaled = p.n_hosts - 2;
  return (hh + 1 + scaled) % p.n_hosts;
}

// on_tick for host hh at `tick` (its t_post) in a window ending at
// `window_end`.  Socket ring and inbox slab come from the deliver
// arguments (`udp_head`, `udp_count`, `ib_*`); the staged packets go to
// `em_valid[e]` / `em_blk[e * pc]`, this host's staging rows.
__device__ __forceinline__ void phold_tick(const PholdArgs& p,
                                           const DeliverArgs& d,
                                           int hh, int64_t tick, bool act,
                                           int64_t window_end,
                                           uint8_t* em_valid,
                                           int32_t* em_blk, int e, int pc) {
  for (int j = 0; j < e; ++j) em_valid[j] = 0;
  int32_t pending = p.pending[hh];
  int64_t next_send = p.next_send[hh];
  int64_t sent = p.sent[hh], recv = p.recv[hh];
  uint32_t ctr = (uint32_t)p.rng_ctr[hh];

  // Consume delivered messages: each becomes a pending message.
  const int64_t si = (int64_t)hh * d.slots + p.sock_slot;
  int32_t head = d.udp_head[si], count = d.udp_count[si];
  const int n_pop = p.rx_batch > 2 ? p.rx_batch : 2;
  for (int k = 0; k < n_pop; ++k) {
    if (!act || count <= 0) continue;
    head = (head + 1) % UDP_RING;
    --count;
    const int64_t cand = tick + phold_delay(p, hh, ctr);
    ++pending;
    next_send = imin(next_send, cand);
    ++recv;
    ++ctr;
  }
  d.udp_head[si] = head;
  d.udp_count[si] = count;

  // Send-batch bound: the host's next live inbox arrival, capped at the
  // window end.
  int64_t bound = INV;
  const int64_t base = (int64_t)hh * d.ki;
  each_slot(Solo{}, d.ib_stage + base, d.ki, [&](int k, int32_t st) {
    if (st == STAGE_FREE) return;
    const int32_t* row = d.ib_blk + (base + k) * d.ic;
    bound = imin(bound, imax(dec_i64(row[ICOL_TIME_LO], row[ICOL_TIME_HI]),
                             tick));
  });
  bound = imin(bound, window_end);

  const int xb = pc - OEXT_COLS;
  for (int k = 0; k < p.lanes; ++k) {
    const bool due = act && pending > 0 &&
                     (k == 0 ? next_send <= tick : next_send < bound);
    if (!due) continue;
    const int64_t t_send = k == 0 ? 0 : next_send;
    const int64_t base_t = k == 0 ? tick : next_send;
    int32_t* row = em_blk + (int64_t)(SLOT_APP + k) * pc;
    for (int c = 0; c < pc; ++c) row[c] = 0;
    row[ICOL_SPORT] = PHOLD_PORT;
    row[ICOL_DPORT] = PHOLD_PORT;
    row[ICOL_PROTO] = PROTO_UDP;
    row[ICOL_LEN] = PHOLD_MSG_BYTES;
    row[ICOL_PAYLOAD] = -1;
    row[ICOL_TIME_LO] = enc_lo(t_send);
    row[ICOL_TIME_HI] = enc_hi(t_send);
    row[xb + OEXT_DST] = phold_pick_dst(p, hh, ctr);
    em_valid[SLOT_APP + k] = 1;
    --pending;
    ++sent;
    next_send = pending > 0 ? base_t + phold_delay(p, hh, ctr + 1u) : INV;
    ctr += 2u;
  }
  p.pending[hh] = pending;
  p.next_send[hh] = next_send;
  p.sent[hh] = sent;
  p.recv[hh] = recv;
  p.rng_ctr[hh] = (int64_t)ctr;
}

}  // namespace s1
