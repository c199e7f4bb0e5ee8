"""Float functions bit-identical to the JAX package on XLA CPU, as plain
tensor ops: phold's f64 log1p, CoDel's f32 rsqrt and CUBIC's f32 cbrt.

phold draws its exponential delay as `-log1p(-u) * mean` in f64 and
truncates to int64 ns (apps/phold.py), so the port must reproduce the
JAX package's f64 `log1p` bit for bit: `torch.log1p` differs from it on
many of the 2^24 values `keyed_uniform` can give, enough to move a
delay draw of the bench world by 1 ns.

What XLA CPU computes for f64 `log1p(x)` (read off its optimized LLVM IR
and the machine code it emits on an x86-64 host with FMA):

* |x| < sqrt(2) - 1: the Cephes rational approximation
  x + (-x^2/2 + x^3 * P(x)/Q(x)), P and Q by Horner, where the backend
  contracts every Horner step `c + x * p` into one fused multiply-add;
* otherwise: the C library's `log(1 + x)`.  On glibc with FMA that is
  the table-driven algorithm of glibc's `e_log.c` (128-entry table of
  (1/c, log c), degree-5 polynomial), compiled with FMA contraction.
  `log` below is that algorithm's main path, FMA for FMA, with glibc's
  own table and coefficients (`_LOG_TAB`, `_LOG_A`).

XLA CPU's f32 `a / sqrt(x)` (CoDel's drop spacing, core/nic.py) is
rewritten by XLA's algebraic simplifier to `a * rsqrt(x)`, and f32 rsqrt
lowers to the x86 `rsqrtss` estimate refined by two FMA-contracted Newton
steps.  The estimate is the CPU's own and differs between vendors; the
Intel estimate (the one behind the JAX results this port is held to)
reads only the exponent's parity and the top 10 mantissa bits, and its
12-bit result equals round((2 / sqrt(x_mid) - 1) * 4096) for the
midpoint x_mid of those bits' interval in [1, 4), which `_rsqrt_table`
computes.  `rsqrt` below is that estimate plus the two Newton steps,
each FMA emulated exactly in f64 (an f32 product is exact there; the sum
is rounded to odd, then once to f32).

XLA CPU's f32 `cbrt(x)` is `copysign(powf(|x|, f32(1/3)), x)`, and
`powf` is the C library's: on glibc with FMA, the algorithm of glibc's
`e_powf.c` -- log2 from a 16-entry table and a degree-5 polynomial,
exp2 from a 32-entry table and a degree-3 polynomial, both in f64 with
FMA contraction, one rounding to f32 at the end.  `cbrt` below is that
sequence with glibc's own tables (`_POWF_*`); torch's `pow(x, 1/3)` is
not (it differs on about 2 % of inputs).

Torch has no fused multiply-add and the card's `log` is not glibc's, so
both are rebuilt from exactly rounded IEEE add/sub/mul/div (which every
device computes identically) and int64 bit views.  `fma(a, b, c)` is
emulated exactly: Dekker's error-free product gives a*b = ph + pl, and
c + ph + pl is rounded once with Boldo and Melquiond's round-to-odd
trick.  Every op is its own torch kernel, so nothing contracts behind
the sequence's back.  The tests hold `log1p` against the JAX package on
all 2^24 inputs of the draw; `chip_smoke.py` holds the card against the
CPU on the same inputs.
"""

from __future__ import annotations

import torch

F64 = torch.float64

_SPLIT = 134217729.0          # 2^27 + 1 (Veltkamp splitter)

# Cephes log1p coefficients in XLA's order (highest power first).
_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
        2.2176239823732856465394E2, 3.0909872225312059774938E2,
        2.1642788614495947685003E2, 6.0118660497603843919306E1)
_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
        6.5787325942061044846969E0, 2.9911919328553073277375E1,
        6.0949667980987787057556E1, 5.7112963590585538103336E1,
        2.0039553499201281259648E1)
_SMALL = 0.41421356237309504880   # sqrt(2) - 1

# glibc e_log.c data (__log_data, LOG_TABLE_BITS = 7): ln2 split, the
# polynomial A[0..4], and per subinterval i the pair (invc, logc).
_H = float.fromhex
_LN2_HI = _H("0x1.62e42fefa3800p-1")
_LN2_LO = _H("0x1.ef35793c76730p-45")
_LOG_A = tuple(_H(a) for a in (
    "-0x1.0000000000001p-1", "0x1.555555551305bp-2",
    "-0x1.fffffffeb4590p-3", "0x1.999b324f10111p-3",
    "-0x1.55575e506c89fp-3"))
_LOG_TAB = (
    ('0x1.734f0c3e0de9fp+0', '-0x1.7cc7f79e69000p-2', '0x1.713786a2ce91fp+0', '-0x1.76feec20d0000p-2'),
    ('0x1.6f26008fab5a0p+0', '-0x1.713e31351e000p-2', '0x1.6d1a61f138c7dp+0', '-0x1.6b85b38287800p-2'),
    ('0x1.6b1490bc5b4d1p+0', '-0x1.65d5590807800p-2', '0x1.69147332f0cbap+0', '-0x1.602d076180000p-2'),
    ('0x1.6719f18224223p+0', '-0x1.5a8ca86909000p-2', '0x1.6524f99a51ed9p+0', '-0x1.54f4356035000p-2'),
    ('0x1.63356aa8f24c4p+0', '-0x1.4f637c36b4000p-2', '0x1.614b36b9ddc14p+0', '-0x1.49da7fda85000p-2'),
    ('0x1.5f66452c65c4cp+0', '-0x1.445923989a800p-2', '0x1.5d867b5912c4fp+0', '-0x1.3edf439b0b800p-2'),
    ('0x1.5babccb5b90dep+0', '-0x1.396ce448f7000p-2', '0x1.59d61f2d91a78p+0', '-0x1.3401e17bda000p-2'),
    ('0x1.5805612465687p+0', '-0x1.2e9e2ef468000p-2', '0x1.56397cee76bd3p+0', '-0x1.2941b3830e000p-2'),
    ('0x1.54725e2a77f93p+0', '-0x1.23ec58cda8800p-2', '0x1.52aff42064583p+0', '-0x1.1e9e129279000p-2'),
    ('0x1.50f22dbb2bddfp+0', '-0x1.1956d2b48f800p-2', '0x1.4f38f4734ded7p+0', '-0x1.141679ab9f800p-2'),
    ('0x1.4d843cfde2840p+0', '-0x1.0edd094ef9800p-2', '0x1.4bd3ec078a3c8p+0', '-0x1.09aa518db1000p-2'),
    ('0x1.4a27fc3e0258ap+0', '-0x1.047e65263b800p-2', '0x1.4880524d48434p+0', '-0x1.feb224586f000p-3'),
    ('0x1.46dce1b192d0bp+0', '-0x1.f474a7517b000p-3', '0x1.453d9d3391854p+0', '-0x1.ea4443d103000p-3'),
    ('0x1.43a2744b4845ap+0', '-0x1.e020d44e9b000p-3', '0x1.420b54115f8fbp+0', '-0x1.d60a22977f000p-3'),
    ('0x1.40782da3ef4b1p+0', '-0x1.cc00104959000p-3', '0x1.3ee8f5d57fe8fp+0', '-0x1.c202956891000p-3'),
    ('0x1.3d5d9a00b4ce9p+0', '-0x1.b81178d811000p-3', '0x1.3bd60c010c12bp+0', '-0x1.ae2c9ccd3d000p-3'),
    ('0x1.3a5242b75dab8p+0', '-0x1.a45402e129000p-3', '0x1.38d22cd9fd002p+0', '-0x1.9a877681df000p-3'),
    ('0x1.3755bc5847a1cp+0', '-0x1.90c6d69483000p-3', '0x1.35dce49ad36e2p+0', '-0x1.87120a645c000p-3'),
    ('0x1.34679984dd440p+0', '-0x1.7d68fb4143000p-3', '0x1.32f5cceffcb24p+0', '-0x1.73cb83c627000p-3'),
    ('0x1.3187775a10d49p+0', '-0x1.6a39a9b376000p-3', '0x1.301c8373e3990p+0', '-0x1.60b3154b7a000p-3'),
    ('0x1.2eb4ebb95f841p+0', '-0x1.5737d76243000p-3', '0x1.2d50a0219a9d1p+0', '-0x1.4dc7b8fc23000p-3'),
    ('0x1.2bef9a8b7fd2ap+0', '-0x1.4462c51d20000p-3', '0x1.2a91c7a0c1babp+0', '-0x1.3b08abc830000p-3'),
    ('0x1.293726014b530p+0', '-0x1.31b996b490000p-3', '0x1.27dfa5757a1f5p+0', '-0x1.2875490a44000p-3'),
    ('0x1.268b39b1d3bbfp+0', '-0x1.1f3b9f879a000p-3', '0x1.2539d838ff5bdp+0', '-0x1.160c8252ca000p-3'),
    ('0x1.23eb7aac9083bp+0', '-0x1.0ce7f57f72000p-3', '0x1.22a012ba940b6p+0', '-0x1.03cdc49fea000p-3'),
    ('0x1.2157996cc4132p+0', '-0x1.f57bdbc4b8000p-4', '0x1.201201dd2fc9bp+0', '-0x1.e370896404000p-4'),
    ('0x1.1ecf4494d480bp+0', '-0x1.d17983ef94000p-4', '0x1.1d8f5528f6569p+0', '-0x1.bf9674ed8a000p-4'),
    ('0x1.1c52311577e7cp+0', '-0x1.adc79202f6000p-4', '0x1.1b17c74cb26e9p+0', '-0x1.9c0c3e7288000p-4'),
    ('0x1.19e010c2c1ab6p+0', '-0x1.8a646b372c000p-4', '0x1.18ab07bb670bdp+0', '-0x1.78d01b3ac0000p-4'),
    ('0x1.1778a25efbcb6p+0', '-0x1.674f145380000p-4', '0x1.1648d354c31dap+0', '-0x1.55e0e6d878000p-4'),
    ('0x1.151b990275fddp+0', '-0x1.4485cdea1e000p-4', '0x1.13f0ea432d24cp+0', '-0x1.333d94d6aa000p-4'),
    ('0x1.12c8b7210f9dap+0', '-0x1.22079f8c56000p-4', '0x1.11a3028ecb531p+0', '-0x1.10e4698622000p-4'),
    ('0x1.107fbda8434afp+0', '-0x1.ffa6c6ad20000p-5', '0x1.0f5ee0f4e6bb3p+0', '-0x1.dda8d4a774000p-5'),
    ('0x1.0e4065d2a9fcep+0', '-0x1.bbcece4850000p-5', '0x1.0d244632ca521p+0', '-0x1.9a1894012c000p-5'),
    ('0x1.0c0a77ce2981ap+0', '-0x1.788583302c000p-5', '0x1.0af2f83c636d1p+0', '-0x1.5715e67d68000p-5'),
    ('0x1.09ddb98a01339p+0', '-0x1.35c8a49658000p-5', '0x1.08cabaf52e7dfp+0', '-0x1.149e364154000p-5'),
    ('0x1.07b9f2f4e28fbp+0', '-0x1.e72c082eb8000p-6', '0x1.06ab58c358f19p+0', '-0x1.a55f152528000p-6'),
    ('0x1.059eea5ecf92cp+0', '-0x1.63d62cf818000p-6', '0x1.04949cdd12c90p+0', '-0x1.228fb8caa0000p-6'),
    ('0x1.038c6c6f0ada9p+0', '-0x1.c317b20f90000p-7', '0x1.02865137932a9p+0', '-0x1.419355daa0000p-7'),
    ('0x1.0182427ea7348p+0', '-0x1.81203c2ec0000p-8', '0x1.008040614b195p+0', '-0x1.0040979240000p-9'),
    ('0x1.fe01ff726fa1ap-1', '0x1.feff384900000p-9', '0x1.fa11cc261ea74p-1', '0x1.7dc41353d0000p-7'),
    ('0x1.f6310b081992ep-1', '0x1.3cea3c4c28000p-6', '0x1.f25f63ceeadcdp-1', '0x1.b9fc114890000p-6'),
    ('0x1.ee9c8039113e7p-1', '0x1.1b0d8ce110000p-5', '0x1.eae8078cbb1abp-1', '0x1.58a5bd001c000p-5'),
    ('0x1.e741aa29d0c9bp-1', '0x1.95c8340d88000p-5', '0x1.e3a91830a99b5p-1', '0x1.d276aef578000p-5'),
    ('0x1.e01e009609a56p-1', '0x1.07598e598c000p-4', '0x1.dca01e577bb98p-1', '0x1.253f5e30d2000p-4'),
    ('0x1.d92f20b7c9103p-1', '0x1.42edd8b380000p-4', '0x1.d5cac66fb5ccep-1', '0x1.606598757c000p-4'),
    ('0x1.d272caa5ede9dp-1', '0x1.7da76356a0000p-4', '0x1.cf26e3e6b2ccdp-1', '0x1.9ab434e1c6000p-4'),
    ('0x1.cbe6da2a77902p-1', '0x1.b78c7bb0d6000p-4', '0x1.c8b266d37086dp-1', '0x1.d431332e72000p-4'),
    ('0x1.c5894bd5d5804p-1', '0x1.f0a3171de6000p-4', '0x1.c26b533bb9f8cp-1', '0x1.067152b914000p-3'),
    ('0x1.bf583eeece73fp-1', '0x1.147858292b000p-3', '0x1.bc4fd75db96c1p-1', '0x1.2266ecdca3000p-3'),
    ('0x1.b951e0c864a28p-1', '0x1.303d7a6c55000p-3', '0x1.b65e2c5ef3e2cp-1', '0x1.3dfc33c331000p-3'),
    ('0x1.b374867c9888bp-1', '0x1.4ba366b7a8000p-3', '0x1.b094b211d304ap-1', '0x1.5933928d1f000p-3'),
    ('0x1.adbe885f2ef7ep-1', '0x1.66acd2418f000p-3', '0x1.aaf1d31603da2p-1', '0x1.740f8ec669000p-3'),
    ('0x1.a82e63fd358a7p-1', '0x1.815c0f51af000p-3', '0x1.a5740ef09738bp-1', '0x1.8e92954f68000p-3'),
    ('0x1.a2c2a90ab4b27p-1', '0x1.9bb3602f84000p-3', '0x1.a01a01393f2d1p-1', '0x1.a8bed1c2c0000p-3'),
    ('0x1.9d79f24db3c1bp-1', '0x1.b5b515c01d000p-3', '0x1.9ae2505c7b190p-1', '0x1.c2967ccbcc000p-3'),
    ('0x1.9852ef297ce2fp-1', '0x1.cf635d5486000p-3', '0x1.95cbaeea44b75p-1', '0x1.dc1bd3446c000p-3'),
    ('0x1.934c69de74838p-1', '0x1.e8c01b8cfe000p-3', '0x1.90d4f2f6752e6p-1', '0x1.f5509c0179000p-3'),
    ('0x1.8e6528effd79dp-1', '0x1.00e6c121fb800p-2', '0x1.8bfce9fcc007cp-1', '0x1.071b80e93d000p-2'),
    ('0x1.899c0dabec30ep-1', '0x1.0d46b9e867000p-2', '0x1.87427aa2317fbp-1', '0x1.13687334bd000p-2'),
    ('0x1.84f00acb39a08p-1', '0x1.1980d67234800p-2', '0x1.82a49e8653e55p-1', '0x1.1f8ffe0cc8000p-2'),
    ('0x1.8060195f40260p-1', '0x1.2595fd7636800p-2', '0x1.7e22563e0a329p-1', '0x1.2b9300914a800p-2'),
    ('0x1.7beb377dcb5adp-1', '0x1.3187210436000p-2', '0x1.79baa679725c2p-1', '0x1.377266dec1800p-2'),
    ('0x1.77907f2170657p-1', '0x1.3d54ffbaf3000p-2', '0x1.756cadbd6130cp-1', '0x1.432eee32fe000p-2'),
)
_LOG_OFF = 0x3FE6000000000000
_TABLES: dict = {}


def _tables(device):
    key = str(device)
    if key not in _TABLES:
        invc = [_H(row[j]) for row in _LOG_TAB for j in (0, 2)]
        logc = [_H(row[j]) for row in _LOG_TAB for j in (1, 3)]
        _TABLES[key] = (torch.tensor(invc, dtype=F64, device=device),
                        torch.tensor(logc, dtype=F64, device=device))
    return _TABLES[key]


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    """Veltkamp split: a = hi + lo with both halves at most 26 bits wide.
    Works on tensors and Python floats alike."""
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b, a_split=None):
    """a * b = p + err exactly (Dekker; no FMA needed)."""
    p = a * b
    ah, al = _split(a) if a_split is None else a_split
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _round_odd_sum(a, b):
    """a + b rounded to odd: when the sum is inexact, the neighbour with
    an odd last bit (a nudge through the int64 view)."""
    s, err = _two_sum(a, b)
    bits = s.view(torch.int64)
    nudge = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)          # the exact sum lies further out
    step = torch.where(away, 1, -1)
    return torch.where(nudge, bits + step, bits).view(F64)


def fma(a, b, c, a_split=None):
    """Exactly rounded a * b + c, emulated with IEEE add/mul only.  `a` is
    a tensor; `b` and `c` are tensors or Python floats.  `a_split` passes
    a precomputed `_split(a)` when one multiplier is reused."""
    uh, ul = _two_prod(a, b, a_split)
    th, tl = _two_sum(c, uh)
    return th + _round_odd_sum(tl, ul)


def fma_f32(a, b, c):
    """Exactly rounded f32 a * b + c: the product is exact in f64, the sum
    is rounded to odd in f64, then rounded once to f32."""
    p = a.to(F64) * b.to(F64)
    c64 = c.to(F64) if isinstance(c, torch.Tensor) else float(c)
    return _round_odd_sum(p, c64 + torch.zeros_like(p)).to(torch.float32)


def _rsqrt_table():
    """12-bit mantissas of the rsqrtss estimate: index (E & 1) << 10 | m10
    for x = 2^E * (1 + m10 / 1024 + ...)."""
    import math
    out = []
    for parity in (0, 1):
        for k in range(1024):
            x_mid = (1 + (k + 0.5) / 1024) * (2.0 if parity else 1.0)
            out.append(round((2 / math.sqrt(x_mid) - 1) * 4096))
    return out


_RSQRT_M12 = _rsqrt_table()


def rsqrt_table(device):
    """The estimate's 2048 entries as f32 values in [0.5, 1) on `device`
    (the CUDA kernels take this same tensor)."""
    key = ("rsqrt", str(device))
    if key not in _TABLES:
        bits = torch.tensor([(126 << 23) | (m << 11) for m in _RSQRT_M12],
                            dtype=torch.int32)
        _TABLES[key] = bits.view(torch.float32).to(device)
    return _TABLES[key]


def rsqrt(x):
    """XLA CPU's f32 rsqrt for positive normal f32 x."""
    tab = rsqrt_table(x.device)
    b = x.contiguous().view(torch.int32)
    e = ((b >> 23) & 0xFF) - 127
    idx = ((e & 1) << 10) | ((b >> 13) & 0x3FF)
    m = tab[idx.to(torch.int64)].view(torch.int32) & 0x7FFFFF
    y = (m | ((126 - (e >> 1)) << 23)).view(torch.float32)
    for _ in range(2):
        t = fma_f32(y, x * y, -1.0)
        y = fma_f32(y * -0.5, t, y)
    return y


def log(x):
    """glibc's `log` (FMA build), main path: positive normal x outside
    [1 - 2^-4, 1 + 0x1.09p-4).  log1p's large-|x| branch only reaches
    this range."""
    invc_t, logc_t = _tables(x.device)
    ix = x.contiguous().view(torch.int64)
    tmp = ix - _LOG_OFF
    i = (tmp >> 45) & 0x7F
    k = tmp >> 52
    iz = ix - (tmp & -(1 << 52))
    z = iz.view(F64)
    invc, logc = invc_t[i], logc_t[i]
    kd = k.to(F64)
    r = fma(z, invc, -1.0)
    w = fma(kd, _LN2_HI, logc)
    hi = r + w
    lo = fma(kd, _LN2_LO, (w - hi) + r)
    r2 = r * r
    a0, a1, a2, a3, a4 = _LOG_A
    q1 = fma(r, a2, a1)
    q2 = fma(r, a4, a3)
    t = fma(r2, a0, lo)
    r3 = r * r2
    p = fma(q2, r2, q1)
    return fma(r3, p, t) + hi


# glibc e_powf_log2_data.c / e_exp2f_data.c (__powf_log2_data,
# __exp2f_data with EXP2F_TABLE_BITS = 5): log2 poly A[0..4], per
# subinterval (invc, logc), exp2 poly C[0..2], and the exp2 table
# (asuint64(2^(i/32)) - (i << 52) / 32).
_POWF_OFF = 0x3F330000
_POWF_A = tuple(_H(a) for a in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_POWF_TAB = (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"))
_EXP2F_SHIFT = _H("0x1.8p+47")
_EXP2F_C = tuple(_H(c) for c in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2F_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_THIRD_F32 = 0.3333333432674408     # f32(1/3) = 0x3EAAAAAB


def _powf_tables(device):
    key = ("powf", str(device))
    if key not in _TABLES:
        _TABLES[key] = (
            torch.tensor([_H(r[0]) for r in _POWF_TAB], dtype=F64,
                         device=device),
            torch.tensor([_H(r[1]) for r in _POWF_TAB], dtype=F64,
                         device=device),
            torch.tensor(_EXP2F_TAB, dtype=torch.int64, device=device))
    return _TABLES[key]


def cbrt(x):
    """XLA CPU's f32 cbrt: copysign(powf(|x|, f32(1/3)), x) with glibc's
    FMA powf (the `e_powf.c` main path; the exponent is fixed, so the
    overflow and negative-base branches never apply)."""
    m32 = 0xFFFFFFFF
    invc_t, logc_t, exp2_t = _powf_tables(x.device)
    ax = x.abs()
    ix = ax.contiguous().view(torch.int32).to(torch.int64)
    # Subnormal |x|: glibc scales it by 2^23 and takes the exponent back
    # out, but XLA CPU runs with denormals-are-zero, so the product is 0
    # and the bits become 0 - (23 << 23).
    sub = (ix > 0) & (ix < 0x00800000)
    ix = torch.where(sub, -(23 << 23), ix)
    # log2_inline: |x| = 2^k z, z in [OFF, 2 OFF), table i near z.
    tmp = (ix - _POWF_OFF) & m32
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & m32
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) >> 23
    z = iz.to(torch.int32).view(torch.float32).to(F64)
    a0, a1, a2, a3, a4 = _POWF_A
    r = fma(z, invc_t[i], -1.0)
    y0 = k.to(F64) + logc_t[i]
    y = fma(r, a0, a1)
    p = fma(r, a2, a3)
    r2 = r * r
    q = fma(r, a4, y0)
    r4 = r2 * r2
    q = fma(r2, p, q)
    logx = fma(y, r4, q)
    ylogx = logx * _THIRD_F32
    # exp2_inline: 2^ylogx = 2^(ki/32) * 2^r.
    kd = ylogx + _EXP2F_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - _EXP2F_SHIFT
    r = ylogx - kd
    # t = tab[ki % 32] + (ki << 47) mod 2^64, in 32-bit halves (the
    # result is a positive double, so the high half stays below 2^31).
    t = exp2_t[ki & 31]
    t_hi = ((t >> 32) + ((ki & 0x1FFFF) << 15)) & m32
    s = ((t_hi << 32) | (t & m32)).view(F64)
    c0, c1, c2 = _EXP2F_C
    zz = fma(r, c0, c1)
    r2 = r * r
    yy = fma(r, c2, 1.0)
    yy = fma(zz, r2, yy)
    out = (yy * s).to(torch.float32)
    # powf(0) = 0, powf(inf) = inf, powf(nan) = nan (x * x in glibc).
    special = (ix == 0) | ~torch.isfinite(ax)
    out = torch.where(special, ax * ax, out)
    return torch.copysign(out, x)


def log1p(x):
    """XLA CPU's f64 log1p (see the module docstring), for x > -1."""
    x = x.to(F64)
    xs = _split(x)
    # First Horner step: c1 + x * c0 with the constants split on the host.
    pd = fma(x, _DEN[0], _DEN[1], xs)
    pn = fma(x, _NUM[0], _NUM[1], xs)
    for cd, cn in zip(_DEN[2:], _NUM[2:]):
        pd = fma(x, pd, cd, xs)
        pn = fma(x, pn, cn, xs)
    x2 = x * x
    small = ((x2 * x) * (pn / pd) + x2 * -0.5) + x
    is_small = x.abs() < _SMALL
    big_arg = torch.where(is_small, torch.full_like(x, 2.0), 1.0 + x)
    return torch.where(is_small, small, log(big_arg))
