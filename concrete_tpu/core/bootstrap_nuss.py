"""Large-N programmable bootstrapping: the external product computed in the
Nussbaumer domain — 2L independent M-point int8 toeplitz matmuls.

The direct toeplitz path (core/bootstrap_mxu.py) is an O(N^2) toeplitz matmul;
its per-iteration RHS grows to gigabytes past N=4096, which is why it
refuses large polynomials. Here every polynomial lives as 2L strided chunks
of size M = N/L (math/nussbaumer.py): the negacyclic N-product becomes 2L
POINTWISE M-point negacyclic products — O(N^2/L) MACs and O(N^2/L) table
bytes — with rotation-only (multiplication-free) transforms on either side.
That puts N = 8192 and 16384 on the int8 matmul path; the reference supports
exactly these sizes through FFTW (concrete-core .../math/fft/mod.rs:28).

Exactness: every step is integer arithmetic. Digits are transformed as
exact (wrapping i32) integers; GGSW chunks are transformed mod
2^(bits + log2(2L)) — u64 words for the u32 torus, host-side (lo, hi) u64
pairs (128-bit carriage) for the u64 torus — and limb-packed keeping
ceil((bits + log2(2L)) / 8) byte limbs, enough that the recombined
products are exact mod 2^(8*limbs) >= 2^(bits + log2(2L)), so after the
inverse transform the known factor 2L divides out as a right shift. The
whole pipeline is BIT-IDENTICAL to the direct toeplitz path and the NTT
path on BOTH torus widths (tests/test_nussbaumer.py).

Reference algorithm being replaced: blind_rotate / external_product
(crypto/bootstrap/fourier/mod.rs:463-726) — same semantics, large N run
as batched int8 matrix products.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..math import decomposition, nussbaumer as nb, polynomial
from . import lwe as lwe_ops
from .bootstrap import ServerConfig, pbs_modulus_switch, sample_extract
from . import bootstrap_mxu as bsx


@dataclasses.dataclass(frozen=True)
class NussPlan:
    """Static layout of the Nussbaumer-domain external product."""

    lwe_dimension: int
    glwe_size: int           # k+1
    polynomial_size: int     # N
    l: int                   # chunk count L (2L transform length)
    base_log: int
    level: int
    n_sub: int               # sub-digit chunks of the TRANSFORMED digits
    ks_base_log: int
    ks_level: int
    bits: int = 32

    @classmethod
    def best_l(cls, cfg: ServerConfig) -> int:
        """Config-aware default chunk count: among feasible L, minimize the
        per-iteration int8 product work 2L * n_sub * limbs * M^2, tying to
        the SMALLER L. The choice depends on the config alone, never on the
        device, so keys converted on one host serve on any other.

        >>> from concrete_tpu.core.bootstrap import ServerConfig
        >>> cfg = ServerConfig(lwe_dimension=100, glwe_dimension=1,
        ...     polynomial_size=8192, pbs_base_log=2, pbs_level=3,
        ...     ks_base_log=2, ks_level=5)
        >>> NussPlan.best_l(cfg)
        32
        >>> NussPlan.best_l(ServerConfig(lwe_dimension=100,
        ...     glwe_dimension=1, polynomial_size=16384, pbs_base_log=2,
        ...     pbs_level=3, ks_base_log=2, ks_level=5))
        128
        """
        n = cfg.polynomial_size
        candidates = []
        l = 2
        while l * l <= n:
            m = n // l
            if l * m == n and m % l == 0:
                try:
                    plan = cls.from_config(cfg, l)
                except (NotImplementedError, ValueError):
                    l *= 2
                    continue
                cost = 2 * l * plan.n_sub * plan.limbs_used * m * m
                candidates.append((cost, l))
            l *= 2
        if not candidates:
            raise NotImplementedError(
                f"no feasible Nussbaumer chunking for N={n}")
        return min(candidates)[1]

    @classmethod
    def from_config(cls, cfg: ServerConfig, l: int | None = None) -> "NussPlan":
        if cfg.bits not in (32, 64):
            raise NotImplementedError("nussbaumer path: u32/u64 torus only")
        n = cfg.polynomial_size
        if l is None:
            l = cls.best_l(cfg)
        m = n // l
        if l * m != n or m % l != 0:
            raise ValueError(f"need L | M (N={n}, L={l}, M={m})")
        # transformed digits are sums of L rotated gadget digits:
        # |D| <= L * B/2 = 2^(bl_eff - 1) with bl_eff = bl + log2(L)
        bl_eff = cfg.pbs_base_log + (l.bit_length() - 1)
        n_sub = 1 if bl_eff <= 7 else (bl_eff - 8) // 7 + 2
        plan = cls(
            lwe_dimension=cfg.lwe_dimension,
            glwe_size=cfg.glwe_size,
            polynomial_size=n,
            l=l,
            base_log=cfg.pbs_base_log,
            level=cfg.pbs_level,
            n_sub=n_sub,
            ks_base_log=cfg.ks_base_log,
            ks_level=cfg.ks_level,
            bits=cfg.bits,
        )
        k_rows = plan.row_blocks * plan.m
        if k_rows * 64 * 128 >= 2 ** 31:
            raise NotImplementedError(
                f"int32 accumulation bound exceeded (K={k_rows})")
        if plan.bits == 32 and plan.bits + plan.shift > 64 - plan.shift:
            # u32 torus is carried in u64 words host-side: (v >> shift)
            # mod 2^bits must be below the garbage-bit floor. The u64 torus
            # rides (lo, hi) u64 pairs (128-bit carriage) — no analog limit.
            raise NotImplementedError(f"L={l} too large for u64 carriage")
        return plan

    @property
    def m(self) -> int:
        return self.polynomial_size // self.l

    @property
    def two_l(self) -> int:
        return 2 * self.l

    @property
    def shift(self) -> int:
        """log2(2L): the inverse transform's deferred division."""
        return self.two_l.bit_length() - 1

    @property
    def w_prime(self) -> int:
        """Carried modulus width: results are exact mod 2^w_prime."""
        return self.bits + self.shift

    @property
    def limbs_used(self) -> int:
        return (self.w_prime + 7) // 8

    @property
    def n_words(self) -> int:
        """u32 words per stored transformed-GGSW coefficient (2 for the u32
        torus carried in u64, 3 for the u64 torus carried in 128-bit pairs
        — only the words holding kept byte limbs are stored)."""
        return (self.limbs_used + 3) // 4

    @property
    def limb_hi_drop(self) -> int:
        return 4 * self.n_words - self.limbs_used

    @property
    def row_blocks(self) -> int:
        """R' per frequency = level * (k+1) * n_sub."""
        return self.level * self.glwe_size * self.n_sub

    def sub_multiplier(self, sub: int) -> int:
        return 1 << (bsx.MxuPlan.SUB_CHUNK_BITS * (self.n_sub - 1 - sub))


# --- host-side 128-bit pair arithmetic (u64-torus key preparation) --------
# The u64 torus needs the forward transform carried mod 2^(64 + shift);
# numpy has no u128, so values ride (lo, hi) u64 pairs with explicit
# carries. Host-only code (key conversion), mirrors math/nussbaumer.py.


def _np_pair_add(al, ah, bl_, bh):
    with np.errstate(over="ignore"):
        lo = al + bl_
        return lo, ah + bh + (lo < al).astype(np.uint64)


def _np_pair_sub(al, ah, bl_, bh):
    with np.errstate(over="ignore"):
        borrow = (al < bl_).astype(np.uint64)
        return al - bl_, ah - bh - borrow


def _np_pair_neg(lo, hi):
    with np.errstate(over="ignore"):
        nz = (lo != np.uint64(0)).astype(np.uint64)
        return np.uint64(0) - lo, (np.uint64(0) - hi) - nz


def _np_pair_negroll(lo, hi, shift: int):
    """(lo, hi) * Z^shift in R_M (negacyclic last axis), static shift."""
    m = lo.shape[-1]
    shift %= 2 * m
    neg = shift >= m
    shift %= m
    if shift:
        nl, nh = _np_pair_neg(lo[..., m - shift:], hi[..., m - shift:])
        lo = np.concatenate([nl, lo[..., : m - shift]], axis=-1)
        hi = np.concatenate([nh, hi[..., : m - shift]], axis=-1)
    if neg:
        lo, hi = _np_pair_neg(lo, hi)
    return lo, hi


def _np_forward_pair(lo, hi, l: int):
    """nussbaumer.forward on host (lo, hi) u64 pairs: cyclic 2L-point
    polynomial transform mod 2^128, bit-reversed output order."""
    two_l, m = lo.shape[-2], lo.shape[-1]
    root = m // l
    for s in range(two_l.bit_length() - 1):
        half = two_l >> (s + 1)
        shp = lo.shape[:-2] + (1 << s, 2 * half, m)
        lr, hr = lo.reshape(shp), hi.reshape(shp)
        al_, ah_ = lr[..., :half, :], hr[..., :half, :]
        bl_, bh_ = lr[..., half:, :], hr[..., half:, :]
        sl, sh = _np_pair_add(al_, ah_, bl_, bh_)
        dl, dh = _np_pair_sub(al_, ah_, bl_, bh_)
        rs = [_np_pair_negroll(dl[..., j, :], dh[..., j, :],
                               root * j * (1 << s)) for j in range(half)]
        tl = np.stack([r[0] for r in rs], axis=-2)
        th = np.stack([r[1] for r in rs], axis=-2)
        lo = np.stack([sl, tl], axis=-3).reshape(lo.shape[:-2] + (two_l, m))
        hi = np.stack([sh, th], axis=-3).reshape(hi.shape[:-2] + (two_l, m))
    return lo, hi


def _np_limb_pack_pair(lo, hi, n_bytes: int):
    """Balanced signed-byte limb packing of (lo, hi) u64 pairs over
    n_bytes*8 bits — bootstrap_mxu._limb_pack's carry loop on the 128-bit
    carriage (byte m of the result = balanced limb c_m mod 256)."""
    with np.errstate(over="ignore"):
        for b in range(7, 8 * n_bytes - 8, 8):
            bit = ((lo >> np.uint64(b)) & np.uint64(1)) if b < 64 else \
                  ((hi >> np.uint64(b - 64)) & np.uint64(1))
            t = b + 1
            if t < 64:
                inc = bit << np.uint64(t)
                nl = lo + inc
                hi = hi + (nl < lo).astype(np.uint64)
                lo = nl
            else:
                hi = hi + (bit << np.uint64(t - 64))
    return lo, hi


def _bsk_to_nuss_u64(bsk, plan: NussPlan):
    """u64-torus key conversion: forward transform mod 2^128 on host pairs,
    balanced limb packing over 4*n_words bytes, word-plane storage."""
    n_lwe, lv, ks1 = bsk.shape[0], plan.level, plan.glwe_size
    m, two_l = plan.m, plan.two_l
    n_bytes = 4 * plan.n_words
    with np.errstate(over="ignore"):
        ch = nb.chunk(bsk, plan.l)                      # [.., 2L, M] u64
        gz_lo, gz_hi = _np_forward_pair(ch, np.zeros_like(ch), plan.l)
        rings = np.empty(
            (n_lwe, two_l, plan.row_blocks, ks1, plan.n_words, 2 * m),
            dtype=np.uint32)
        blk = 0
        for lev in range(lv):
            for sub in range(plan.n_sub):
                s_m = bsx.MxuPlan.SUB_CHUNK_BITS * (plan.n_sub - 1 - sub)
                for ki in range(ks1):
                    lo = gz_lo[:, lev, ki]              # [n, k+1, 2L, M]
                    hi = gz_hi[:, lev, ki]
                    if s_m:                             # x 2^(7*sub_weight)
                        hi = (hi << np.uint64(s_m)) | (lo >> np.uint64(64 - s_m))
                        lo = lo << np.uint64(s_m)
                    lo = np.moveaxis(lo, 2, 1)          # [n, 2L, k+1, M]
                    hi = np.moveaxis(hi, 2, 1)
                    p_lo, p_hi = _np_limb_pack_pair(lo, hi, n_bytes)
                    n_lo, n_hi = _np_limb_pack_pair(*_np_pair_neg(lo, hi),
                                                    n_bytes)
                    for w in range(plan.n_words):
                        src_p = p_lo if w < 2 else p_hi
                        src_n = n_lo if w < 2 else n_hi
                        sh = np.uint64(32 * (w % 2))
                        rings[:, :, blk, :, w, :m] = (
                            src_p >> sh).astype(np.uint32)
                        rings[:, :, blk, :, w, m:] = (
                            src_n >> sh).astype(np.uint32)
                    blk += 1
    return rings.reshape(
        n_lwe, two_l * plan.row_blocks, ks1 * plan.n_words, 2 * m)


def bsk_to_nuss(bsk_data, cfg: ServerConfig, l: int | None = None):
    """[n, l, k+1, k+1, N] u32 BSK -> Nussbaumer-domain toeplitz rotation
    rings [n, 2L*R', (k+1)*n_words, 2M] u32.

    Per frequency z (bit-reversed transform order) and row block
    (lev, sub, ki), the ring holds the balanced byte limbs of
    (+/-) G_z * 2^(7*sub_weight) packed into u64 words, where
    G_z = forward(chunk(g)) mod 2^64 — build_tables keeps limbs
    0..limbs_used-1 (exact mod 2^w_prime; higher shifts vanish)."""
    plan = NussPlan.from_config(cfg, l)
    if plan.bits == 64:
        return _bsk_to_nuss_u64(np.asarray(bsk_data, np.uint64), plan)
    n_lwe, lv, ks1 = bsk_data.shape[0], plan.level, plan.glwe_size
    m, two_l = plan.m, plan.two_l
    bsk = np.asarray(bsk_data, dtype=np.uint32)
    with np.errstate(over="ignore"):
        g64 = bsk.astype(np.uint64)
        # [n, l, k+1(row), k+1(col), 2L, M] u64, bit-reversed z order
        gz = nb.forward(nb.chunk(g64, plan.l), plan.l)
        rings = np.empty(
            (n_lwe, two_l, plan.row_blocks, ks1, plan.n_words, 2 * m),
            dtype=np.uint32)
        blk = 0
        for lev in range(lv):
            for sub in range(plan.n_sub):
                mult = np.uint64(plan.sub_multiplier(sub))
                for ki in range(ks1):
                    g = gz[:, lev, ki] * mult     # [n, k+1, 2L, M] wrapping
                    g = np.moveaxis(g, 2, 1)      # [n, 2L, k+1, M]
                    pos = bsx._limb_pack(g)
                    neg = bsx._limb_pack((np.uint64(0) - g))
                    for w in range(plan.n_words):
                        sh = np.uint64(32 * w)
                        rings[:, :, blk, :, w, :m] = (pos >> sh).astype(np.uint32)
                        rings[:, :, blk, :, w, m:] = (neg >> sh).astype(np.uint32)
                    blk += 1
    return rings.reshape(
        n_lwe, two_l * plan.row_blocks, ks1 * plan.n_words, 2 * m)


def _digit_matrix_nuss(plan: NussPlan, diff_cm):
    """Gadget-decompose CHUNK-MAJOR diff [k+1, B, L, M] i32/u32, transform
    each digit polynomial (already chunked — the layout makes chunking
    free), split the (grown) transformed digits into balanced 7-bit chunks
    -> [B, 2L, R'*M] i8 with per-z rows in the (lev, sub, ki) block order
    of bsk_to_nuss. No transposes: the z axis lands where the batched dot
    wants it.

    The forward transform runs in i16 lanes when the grown digits fit
    (|D| <= L * B/2 = 2^(bl_eff-1) <= 2^14): half the HBM bytes of i32 on
    the dominant per-iteration tensor."""
    digits = decomposition.decompose_rounded(
        diff_cm, plan.base_log, plan.level)        # [k+1, B, L, M, lv]
    ks1 = diff_cm.shape[0]
    bl_eff = plan.base_log + (plan.l.bit_length() - 1)
    tdt = jnp.int16 if bl_eff <= 14 else jnp.int32
    pad = jnp.zeros(diff_cm.shape[:-2] + (plan.l, plan.m), tdt)
    parts = []
    for lev in range(plan.level):
        d = digits[..., lev].astype(tdt)           # [k+1, B, L, M]
        dz = nb.forward(jnp.concatenate([d, pad], axis=-2), plan.l)
        for dsub in bsx._split_subdigits(dz.astype(jnp.int32), plan.n_sub):
            for ki in range(ks1):
                parts.append(dsub[ki].astype(jnp.int8))   # [B, 2L, M]
    return jnp.concatenate(parts, axis=-1)         # [B, 2L, R'*M]


def _pair_neg(lo, hi):
    """-(x) mod 2^(2w) on a (lo, hi) word pair: the borrow out of the low
    word is 1 exactly when lo != 0."""
    zero = lo.dtype.type(0)
    nz = (lo != zero).astype(lo.dtype)
    return zero - lo, (zero - hi) - nz


def _pair_add(al, ah, bl_, bh):
    lo = al + bl_
    return lo, ah + bh + (lo < al).astype(al.dtype)


def _pair_sub(al, ah, bl_, bh):
    borrow = (al < bl_).astype(al.dtype)
    return al - bl_, ah - bh - borrow


def _pair_negroll(lo, hi, shift: int):
    """(lo, hi) * Z^shift in R_M, static shift, negacyclic on the last
    axis — the word-pair twin of nussbaumer._neg_roll_static, for values
    wider than one lane (the u64 torus carried mod 2^128)."""
    m = lo.shape[-1]
    shift = shift % (2 * m)
    neg = shift >= m
    shift = shift % m
    if shift:
        nl, nh = _pair_neg(lo[..., m - shift:], hi[..., m - shift:])
        lo = jnp.concatenate([nl, lo[..., : m - shift]], axis=-1)
        hi = jnp.concatenate([nh, hi[..., : m - shift]], axis=-1)
    if neg:
        lo, hi = _pair_neg(lo, hi)
    return lo, hi


def _recombine_nuss_u64(plan: NussPlan, s):
    """u32-torus recombine: limb recombination into u64 lanes (exact mod
    2^w_prime <= 2^64), inverse transform + fold in u64, deferred /2L as a
    right shift -> chunk-major update [k+1, B, L, M] u32."""
    m, lu, ks1 = plan.m, plan.limbs_used, plan.glwe_size
    outs = []
    for kj in range(ks1):
        base = kj * lu * m
        o = s[..., base:base + m].astype(jnp.int64)
        for j in range(1, lu):
            c0 = base + j * m
            o = o + (s[..., c0:c0 + m].astype(jnp.int64) << jnp.int64(8 * j))
        outs.append(jax.lax.bitcast_convert_type(o, jnp.uint64))
    oz = jnp.stack(outs, axis=0)                   # [k+1, 2L, B, M]
    oz = jnp.moveaxis(oz, 2, 1)                    # [k+1, B, 2L, M]
    c = nb.fold(nb.inverse_raw(oz, plan.l), plan.l)    # [k+1, B, L, M] u64
    return (c >> jnp.uint64(plan.shift)).astype(jnp.uint32)  # chunk-major


def _recombine_nuss(plan: NussPlan, s):
    """Dot output s [2L, B, (k+1)*limbs*M] i32 -> chunk-major accumulator
    update [k+1, B, L, M]: per-frequency limb recombination (exact mod
    2^w_prime), inverse polynomial transform over z, fold mod (Y^L - Z),
    deferred division by 2L as a right shift."""
    if plan.bits == 64:
        return _recombine_nuss_torus64(plan, s)
    return _recombine_nuss_u64(plan, s)


def _inverse_fold_pairs(plan: NussPlan, lo, hi):
    """Inverse 2L-point polynomial transform + fold mod (Y^L - Z) on word
    pairs [k+1, B, 2L, M] (nb.inverse_raw + nb.fold on explicit-carry
    pairs). Dtype-generic: u32 pairs for the u32 torus, u64 pairs for the
    u64 torus (128-bit carriage)."""
    m = lo.shape[-1]
    two_l, root = plan.two_l, plan.m // plan.l
    stages = two_l.bit_length() - 1
    for st in reversed(range(stages)):
        half = two_l >> (st + 1)
        shp = lo.shape[:-2] + (1 << st, 2, half, m)
        lr, hr = lo.reshape(shp), hi.reshape(shp)
        ul, uh = lr[..., 0, :, :], hr[..., 0, :, :]
        vl_in, vh_in = lr[..., 1, :, :], hr[..., 1, :, :]
        vs = [_pair_negroll(vl_in[..., j, :], vh_in[..., j, :],
                            -root * j * (1 << st))
              for j in range(half)]
        vl = jnp.stack([v[0] for v in vs], axis=-2)
        vh = jnp.stack([v[1] for v in vs], axis=-2)
        al, ah = _pair_add(ul, uh, vl, vh)
        bl_, bh = _pair_sub(ul, uh, vl, vh)
        out_shape = lo.shape[:-2] + (two_l, m)
        lo = jnp.concatenate([al, bl_], axis=-2).reshape(out_shape)
        hi = jnp.concatenate([ah, bh], axis=-2).reshape(out_shape)
    # fold mod (Y^L - Z): out_t = c_t + Z * c_{t+L}
    zl, zh = _pair_negroll(lo[..., plan.l:, :], hi[..., plan.l:, :], 1)
    return _pair_add(lo[..., :plan.l, :], hi[..., :plan.l, :], zl, zh)


def _recombine_nuss_torus64(plan: NussPlan, s):
    """u64-TORUS recombine: dot output s [2L, B, (k+1)*limbs*M] i32 ->
    chunk-major update [k+1, B, L, M] u64. The per-frequency values are
    exact mod 2^w_prime = 2^(64 + shift) and ride (lo, hi) u64 pairs;
    inverse transform + fold on the pairs, then the deferred /2L shift
    recombines the pair into the u64 result."""
    m, lu, ks1 = plan.m, plan.limbs_used, plan.glwe_size
    los, his = [], []
    for kj in range(ks1):
        base = kj * lu * m
        lo = jnp.zeros(s.shape[:-1] + (m,), jnp.uint64)
        hi = jnp.zeros_like(lo)
        for j in range(lu):
            t = 8 * j
            sm = s[..., base + j * m: base + (j + 1) * m].astype(jnp.int64)
            smu = jax.lax.bitcast_convert_type(sm, jnp.uint64)
            if t == 0:
                c_lo = smu
                c_hi = jax.lax.bitcast_convert_type(
                    sm >> jnp.int64(63), jnp.uint64)
            elif t < 64:
                c_lo = smu << jnp.uint64(t)
                c_hi = jax.lax.bitcast_convert_type(
                    sm >> jnp.int64(64 - t), jnp.uint64)
            else:
                c_lo = jnp.zeros_like(smu)
                c_hi = smu << jnp.uint64(t - 64)
            lo, hi = _pair_add(lo, hi, c_lo, c_hi)
        los.append(lo)
        his.append(hi)
    lo = jnp.moveaxis(jnp.stack(los, axis=0), 2, 1)   # [k+1, B, 2L, M]
    hi = jnp.moveaxis(jnp.stack(his, axis=0), 2, 1)
    lo, hi = _inverse_fold_pairs(plan, lo, hi)
    sh = jnp.uint64(plan.shift)
    return (lo >> sh) | (hi << jnp.uint64(64 - plan.shift))  # chunk-major


def external_product_nuss(cfg: ServerConfig, rings, glwe, l: int | None = None):
    """Nussbaumer-domain external product; glwe [..., k+1, N] u32; rings
    [2L*R', (k+1)*n_words, 2M] u32 (one iteration's bsk_to_nuss slice)."""
    plan = NussPlan.from_config(cfg, l)
    lead = glwe.shape[:-2]
    flat = glwe.reshape((-1,) + glwe.shape[-2:])
    pbn = jnp.moveaxis(flat, 1, 0)                 # [k+1, B, N]
    cm = nb.chunk(pbn, plan.l)[..., :plan.l, :]    # chunk-major
    out = nb.unchunk(_extprod_nuss_cm(plan, rings, cm), plan.l)
    return jnp.moveaxis(out, 0, 1).reshape(lead + glwe.shape[-2:])


def _extprod_nuss_cm(plan: NussPlan, rings, diff_cm):
    """Chunk-major external product core: diff [k+1, B, L, M] ->
    update [k+1, B, L, M]."""
    d8 = _digit_matrix_nuss(plan, diff_cm)         # [B, 2L, R'M]
    return _dot_recombine_nuss(plan, rings, d8)


def _dot_recombine_nuss(plan: NussPlan, rings, d8):
    """Per-frequency table build + batched int8 dot + recombine: the tail of
    one Nussbaumer CMux given the transformed digit matrix d8."""
    rhs = bsx.build_tables(
        rings, plan.m, plan.n_words, 0, plan.limb_hi_drop)
    rhs = rhs.reshape(plan.two_l, plan.row_blocks * plan.m, -1)
    s = jax.lax.dot_general(
        d8, rhs, (((2,), (1,)), ((1,), (0,))),
        preferred_element_type=jnp.int32)          # [2L, B, cols]
    return _recombine_nuss(plan, s)


def _rotdig_nuss(plan: NussPlan, acc_cm, a_hat):
    """d8 of one Nussbaumer CMux step from the chunk-major accumulator:
    chunked negacyclic rotation by a_hat, wrapping diff, transformed digit
    matrix."""
    rot = nb.monomial_mul_chunked(acc_cm, a_hat[None, :], plan.l)
    return _digit_matrix_nuss(plan, rot - acc_cm)


def blind_rotate_nuss(cfg: ServerConfig, bsk_rings, lut, lwe, *,
                      l: int | None = None,
                      ms_offset: int = 0, lut_count_log: int = 0):
    """Blind rotation with the Nussbaumer-domain CMux chain. Bit-identical
    to blind_rotate_mxu / blind_rotate (all exact mod 2^32); the accumulator
    stays in the standard domain (the per-iteration X^a rotation does not
    commute with chunking), digits are transformed per iteration."""
    plan = NussPlan.from_config(cfg, l)
    N, ks1 = plan.polynomial_size, plan.glwe_size
    lead = lwe.shape[:-1]
    lwe_flat = lwe.reshape((-1, lwe.shape[-1]))
    b = lwe_flat.shape[0]
    b_hat = pbs_modulus_switch(lwe_flat[..., -1], N, ms_offset, lut_count_log)
    a_hats = jnp.moveaxis(
        pbs_modulus_switch(lwe_flat[..., :-1], N, ms_offset, lut_count_log),
        -1, 0)

    lut_b = jnp.broadcast_to(
        lut.reshape((-1, ks1, N)) if lut.ndim > 2 else lut[None],
        (b, ks1, N))
    acc = jnp.moveaxis(lut_b, 1, 0)
    acc = polynomial.negacyclic_monomial_div(acc, b_hat[None, :])
    # chunk-major [k+1, B, L, M] for the whole scan: chunking is then free
    # inside the per-iteration digit transform, and the accumulator
    # rotation runs in the chunked layout (nussbaumer.monomial_mul_chunked)
    acc = nb.chunk(acc, plan.l)[..., :plan.l, :]

    def step(acc, xs):
        rings_i, a_hat = xs
        d8 = _rotdig_nuss(plan, acc, a_hat)
        return acc + _dot_recombine_nuss(plan, rings_i, d8), None

    acc, _ = jax.lax.scan(step, acc, (bsk_rings, a_hats))
    acc = nb.unchunk(acc, plan.l)
    return jnp.moveaxis(acc, 0, 1).reshape(lead + (ks1, N))


def bootstrap_nuss(cfg: ServerConfig, bsk_rings, lut, lwe, *,
                   l: int | None = None):
    """Full PBS on the Nussbaumer path (fourier/mod.rs:878-911)."""
    return sample_extract(blind_rotate_nuss(cfg, bsk_rings, lut, lwe, l=l))


def bootstrap_many_lut_nuss(cfg: ServerConfig, bsk_rings, lut, lwe,
                            lut_count_log: int, *, ms_offset: int = 0,
                            l: int | None = None):
    """Multi-LUT PBS on the Nussbaumer path (see bootstrap.bootstrap_many_lut
    and the ModulusSwitchOffset/LutCountLog knobs, fourier/mod.rs:728-748)."""
    from .bootstrap import sample_extract_nth

    acc = blind_rotate_nuss(cfg, bsk_rings, lut, lwe, l=l,
                            ms_offset=ms_offset, lut_count_log=lut_count_log)
    return jnp.stack(
        [sample_extract_nth(acc, t) for t in range(1 << lut_count_log)],
        axis=0)


def bootstrap_keyswitch_nuss(cfg: ServerConfig, bsk_rings, ksk, lut, lwe, *,
                             l: int | None = None):
    """PBS + keyswitch: the per-gate pipeline (server_key/mod.rs:133-166)."""
    big = bootstrap_nuss(cfg, bsk_rings, lut, lwe, l=l)
    return lwe_ops.keyswitch_any(
        ksk, big, base_log=cfg.ks_base_log, level_count=cfg.ks_level)


@functools.lru_cache(maxsize=None)
def jit_bootstrap_keyswitch_nuss(cfg: ServerConfig, l: int | None = None):
    return jax.jit(functools.partial(bootstrap_keyswitch_nuss, cfg, l=l))
