"""Toeplitz-matmul programmable bootstrapping: the external product as an
exact negacyclic *toeplitz matmul mod 2^32* (or 2^64) on int8 operands.

The external product ``sum_{lev,i} d_{lev,i} (*) g_{lev,i,j}`` is a
contraction with K = l*(k+1)*N when written against negacyclic toeplitz
blocks of the GGSW polynomials: one deep-K s8 x s8 -> s32 matrix product
per CMux, which XLA hands to the device's integer matrix units. The backend
keeps the name "mxu" for that product.

Exactness (bit-identical to the NTT path, crypto/bootstrap/fourier/mod.rs
semantics without the FFT rounding noise):
- gadget digits are |d| <= B/2; digits wider than int8 are split exactly as
  d = 2^s*d_hi + d_lo (both sub-digits int8; the split is algebraic identity,
  so no convention change and no noise change);
- each u32 torus coefficient of the key is decomposed into 4 *balanced*
  signed-byte limbs c_m in [-128,127] with carry propagation, so
  sum_m c_m 2^{8m} == v (mod 2^32);
- the i8 x i8 -> i32 accumulation over K rows is bounded by
  K * 64 * 128 < 2^31 (checked by MxuPlan), i.e. exact in int32;
- the final limb recombination sum_m S_m << 8m in wrapping int32 arithmetic
  IS the result mod 2^32.

Per-iteration dataflow (one CMux of the blind rotation, batch B), all XLA:
    rotate+decompose : barrel-rotate the accumulator by the per-lane a_hat,
                       wrapping diff, signed gadget decomposition -> digit
                       matrix D [B, R*N] int8
    table build      : expand the iteration's GGSW rotation rings into the
                       int8 toeplitz table [R*N, (k+1)*limbs*N] by
                       log-doubling rolls
    product          : one s8 x s8 -> s32 dot_general
    recombine        : wrapping limb recombination, accumulate into the
                       GLWE accumulator.

Reference algorithm: blind_rotate (fourier/mod.rs:666-726), external_product
(:463-645), cmux (:648-664). The per-iteration "skip if mask == 0" branch is
dropped (a zero rotation contributes exactly 0 — branchless identical).

Example:
    >>> from concrete_tpu.core.bootstrap import ServerConfig
    >>> from concrete_tpu.core.bootstrap_mxu import MxuPlan
    >>> cfg = ServerConfig(lwe_dimension=4, glwe_dimension=1, polynomial_size=64,
    ...     pbs_base_log=7, pbs_level=2, ks_base_log=4, ks_level=3)
    >>> plan = MxuPlan.from_config(cfg)
    >>> (plan.row_blocks, plan.n_limbs, plan.limbs_used)
    (4, 4, 4)
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..math import decomposition, polynomial
from . import lwe as lwe_ops
from .bootstrap import (
    ServerConfig,
    pbs_modulus_switch,
    sample_extract,
    sample_extract_nth,
)

# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MxuPlan:
    """Static layout info for the toeplitz-matmul external product."""

    lwe_dimension: int
    glwe_size: int          # k+1
    polynomial_size: int
    base_log: int
    level: int
    n_sub: int              # sub-digits per gadget digit (int8-fitting chunks)
    ks_base_log: int
    ks_level: int
    bits: int = 32          # torus width: 32 (boolean) or 64 (highlevel)
    limb_drop: int = 0      # low GGSW byte limbs dropped (reduced precision)

    # balanced 7-bit chunking: d = sum_j 2^{7j} e_j, every e_j in [-64, 64]
    SUB_CHUNK_BITS = 7

    @classmethod
    def from_config(cls, cfg: ServerConfig) -> "MxuPlan":
        if cfg.bits not in (32, 64):
            raise NotImplementedError("mxu bootstrap path: u32/u64 torus only")
        # |digit| <= B/2; int8 operands must stay within [-128, 127] and every
        # sub-digit within +-64 so i32 accumulation stays exact.
        if cfg.polynomial_size > 4096:
            raise NotImplementedError(
                "toeplitz RHS is O(N^2) per CMux; beyond N=4096 the exact-NTT"
                " backend is the right path (auto backend falls back)")
        bl = cfg.pbs_base_log
        n_sub = 1 if bl <= 7 else (bl - 8) // 7 + 2
        k_rows = cfg.pbs_level * (cfg.glwe_dimension + 1) * n_sub * cfg.polynomial_size
        if k_rows * 64 * 128 >= 2 ** 31:
            raise NotImplementedError(
                f"int32 MXU accumulation bound exceeded (K={k_rows}): "
                "use the ntt backend for this configuration")
        return cls(
            lwe_dimension=cfg.lwe_dimension,
            glwe_size=cfg.glwe_size,
            polynomial_size=cfg.polynomial_size,
            base_log=bl,
            level=cfg.pbs_level,
            n_sub=n_sub,
            ks_base_log=cfg.ks_base_log,
            ks_level=cfg.ks_level,
            bits=cfg.bits,
            limb_drop=getattr(cfg, "mxu_limb_drop", 0),
        )

    def sub_multiplier(self, sub: int) -> int:
        """2^{7j} weight of sub-digit `sub` (sub=0 = most significant)."""
        return 1 << (self.SUB_CHUNK_BITS * (self.n_sub - 1 - sub))

    @property
    def n_words(self) -> int:
        """u32 words per torus coefficient (1 for u32, 2 for u64)."""
        return self.bits // 32

    @property
    def n_limbs(self) -> int:
        """signed-byte limbs per torus coefficient."""
        return self.bits // 8

    @property
    def limbs_used(self) -> int:
        """GGSW byte limbs actually carried by the RHS/recombine
        (n_limbs - limb_drop; the dropped low limbs round the key operand)."""
        return self.n_limbs - self.limb_drop

    @property
    def row_blocks(self) -> int:
        """R = number of N-row blocks in the digit matrix."""
        return self.level * self.glwe_size * self.n_sub


# ---------------------------------------------------------------------------
# key conversion: BSK -> per-iteration limb-packed rotation rings
# ---------------------------------------------------------------------------


def _limb_pack(v):
    """Pack the balanced signed-byte limb decomposition of u32/u64 `v` into
    same-width words (byte m = limb c_m mod 256; carries propagate upward and
    the top carry wraps, so the bytes recompose to v exactly)."""
    bits = v.dtype.itemsize * 8
    one = v.dtype.type(1)
    w = v
    with np.errstate(over="ignore"):
        for b in range(7, bits - 8, 8):
            w = w + (((w >> v.dtype.type(b)) & one) << v.dtype.type(b + 1))
    return w


def bsk_to_mxu(bsk_data, cfg: ServerConfig):
    """[n, l, k+1, k+1, N] u32 BSK -> toeplitz rotation rings
    [n, R, k+1, 2N] u32 (limb-packed; ring = [limbs(+g'), limbs(-g')]).

    Row-block order (lev, sub, ki) with sub=0 the 2^s-scaled high half when
    the digit split is active. Precomputing the negated half avoids per-byte
    negation in the hot loop (balanced limbs of -g != -limbs of g).
    """
    plan = MxuPlan.from_config(cfg)
    dt = np.uint32 if plan.bits == 32 else np.uint64
    bsk = np.asarray(bsk_data, dtype=dt)
    n, l, ks1, _, N = bsk.shape
    rings = np.empty(
        (n, plan.row_blocks, ks1, plan.n_words, 2 * N), dtype=np.uint32)
    blk = 0
    with np.errstate(over="ignore"):
        for lev in range(l):
            for sub in range(plan.n_sub):
                mult = dt(plan.sub_multiplier(sub))
                for ki in range(ks1):
                    g = bsk[:, lev, ki, :, :] * mult  # [n, k+1, N] wrapping
                    pos = _limb_pack(g)
                    neg = _limb_pack((dt(0) - g).astype(dt))
                    for w in range(plan.n_words):
                        sh = dt(32 * w)
                        rings[:, blk, :, w, :N] = (pos >> sh).astype(np.uint32)
                        rings[:, blk, :, w, N:] = (neg >> sh).astype(np.uint32)
                    blk += 1
    return rings.reshape(n, plan.row_blocks, ks1 * plan.n_words, 2 * N)



# ---------------------------------------------------------------------------
# toeplitz table build
# ---------------------------------------------------------------------------


def _kept_limbs(n_words: int, limb_drop: int, limb_hi_drop: int = 0):
    """Kept (word, byte) pairs in ascending global-limb order.

    limb_drop removes LOW limbs (reduced-precision fast mode);
    limb_hi_drop removes HIGH limbs — used by the Nussbaumer-domain tables,
    whose values only occupy w' = bits + log2(2L) < 8*n_limbs bits (dropping
    limbs with shift >= ceil(w'/8)*8 is exact mod 2^(8*kept))."""
    return [(w, m) for w in range(n_words) for m in range(4)
            if limb_drop <= 4 * w + m < 4 * n_words - limb_hi_drop]


def build_tables(rings, N: int, n_words: int = 1, limb_drop: int = 0,
                 limb_hi_drop: int = 0):
    """rings [R, planes, 2N] u32 -> RHS [R*N, ks1*L*N] i8: row (blk, r),
    column (kj, limb, c) holds byte limb of (X^r * ring_plane)[c] — the
    negacyclic toeplitz matrix T[r, c] = limb(ring[(c - r) mod 2N]), built
    by log-doubling rolls of the rotation ring.
    planes = (k+1)*n_words word-planes; L = 4*n_words - limb_drop kept
    limbs (the lowest `limb_drop` byte limbs are dropped: reduced-precision
    external product, see ServerConfig.mxu_limb_drop)."""
    r_blocks, planes, _ = rings.shape
    ks1 = planes // n_words
    x = rings[:, :, None, :]  # [R, planes, 1, 2N]
    rows = 1
    while rows < N:
        x = jnp.concatenate([x, jnp.roll(x, rows, axis=-1)], axis=2)
        rows *= 2
    cols = x[..., :N]  # [R, planes, N(rows), N(cols)]
    mask = np.uint32(0xFF)
    kept = _kept_limbs(n_words, limb_drop, limb_hi_drop)
    limbs = jnp.stack(
        [((cols[:, kj * n_words + w] >> np.uint32(8 * m)) & mask).astype(jnp.int8)
         for kj in range(ks1) for (w, m) in kept],
        axis=1,
    )  # [R, (kj, limb), N, N]
    rhs = jnp.moveaxis(limbs, 1, 2)  # [R, N, (kj, limb), N]
    return rhs.reshape(r_blocks * N, ks1 * len(kept) * N)


# ---------------------------------------------------------------------------
# rotation + digit extraction
# ---------------------------------------------------------------------------


def _split_subdigits(digit, n_sub: int):
    """Balanced SUB_CHUNK_BITS-wide chunks of a signed gadget digit,
    returned MSB-first: d = sum_j 2^(7j) e_j with |e_j| <= 64, so every
    chunk fits a signed byte for the int8 product. The single definition of
    the (lev, sub, ki) sub-digit order, shared by the direct and the
    Nussbaumer digit matrices. `digit` is any i32 jnp array."""
    if n_sub == 1:
        return (digit,)
    w = MxuPlan.SUB_CHUNK_BITS
    half = np.int32(1 << (w - 1))
    msk = np.int32((1 << w) - 1)
    rem = digit
    chunks = []
    for _ in range(n_sub - 1):
        e = ((rem + half) & msk) - half   # balanced low chunk in [-64, 64)
        rem = (rem - e) >> np.int32(w)
        chunks.append(e)
    chunks.append(rem)                    # |rem| <= 64 by the n_sub choice
    return tuple(reversed(chunks))        # MSB-first


def rotdig(plan: MxuPlan, acc, a_hat):
    """Digit matrix of (X^a_hat * acc - acc): acc [k+1, B, N] u32/u64,
    a_hat [B] ints -> [B, R*N] i8."""
    rot = polynomial.negacyclic_monomial_mul(acc, a_hat[None, :])
    return _digit_matrix(plan, rot - acc)


# ---------------------------------------------------------------------------
# external product / cmux step as one int8 matrix product
# ---------------------------------------------------------------------------


def _digit_matrix(plan: MxuPlan, diff):
    """Signed gadget decomposition of `diff` [k+1, B, N] u32 into the int8
    digit matrix [B, R*N] matching the (lev, sub, ki) row-block order,
    assembled by concatenation along the contraction axis."""
    digits = decomposition.decompose_rounded(diff, plan.base_log, plan.level)
    # digits: [k+1, B, N, l] i32, level index on the last axis
    ks1 = diff.shape[0]
    parts = []
    for lev in range(plan.level):
        d = digits[..., lev]                       # [k+1, B, N]
        for dsub in _split_subdigits(d, plan.n_sub):
            for ki in range(ks1):
                parts.append(dsub[ki].astype(jnp.int8))   # [B, N]
    return jnp.concatenate(parts, axis=1)                 # [B, R*N]


def recombine_limb_planes(plan: MxuPlan, s):
    """[B, (kj, m, c)] i32 dot output -> [k+1, B, N] torus values.

    Wrapping limb recombination (i32 for the u32 torus, i64 for u64) — the
    mod-2^bits reduction IS the two's-complement wrap. Shared by the
    single-device dot and the tp-sharded pipeline (partial sums psum'd
    before recombining). With limb_drop > 0 only the kept high limbs are
    present; their global shifts start at 8*limb_drop (reduced-precision
    mode)."""
    N, ks1, lu = plan.polynomial_size, plan.glwe_size, plan.limbs_used
    acc_t = jnp.int32 if plan.bits == 32 else jnp.int64
    out_t = jnp.uint32 if plan.bits == 32 else jnp.uint64
    outs = []
    for kj in range(ks1):
        base = kj * lu * N
        o = s[:, base: base + N].astype(acc_t)
        if plan.limb_drop:
            o = o << acc_t(8 * plan.limb_drop)
        for j in range(1, lu):
            c0 = base + j * N
            sm = s[:, c0:c0 + N].astype(acc_t)
            o = o + (sm << acc_t(8 * (plan.limb_drop + j)))  # wrapping mod 2^bits
        outs.append(o)
    out = jnp.stack(outs, axis=0)                           # [k+1, B, N]
    return jax.lax.bitcast_convert_type(out, out_t)


def _toeplitz_matmul(plan: MxuPlan, d8, rhs):
    """d8 [B, R*N] i8  x  rhs [R*N, (k+1)*n_limbs*N] i8 -> [k+1, B, N]
    u32/u64: the exact external-product sum mod 2^bits (one s8 x s8 -> s32
    dot over K = R*N, wrapping limb recombination)."""
    s = jax.lax.dot_general(
        d8, rhs, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )                                                       # [B, (kj, m, c)]
    return recombine_limb_planes(plan, s)


def external_product_mxu(cfg: ServerConfig, rings, glwe):
    """Toeplitz-matmul external product; glwe [..., k+1, N] u32;
    rings [R, k+1, 2N] u32 from bsk_to_mxu (one iteration's slice)."""
    plan = MxuPlan.from_config(cfg)
    lead = glwe.shape[:-2]
    flat = glwe.reshape((-1,) + glwe.shape[-2:])
    pbn = jnp.moveaxis(flat, 1, 0)                 # [k+1, B, N] poly-major
    d8 = _digit_matrix(plan, pbn)
    rhs = build_tables(rings, plan.polynomial_size, plan.n_words, plan.limb_drop)
    out = _toeplitz_matmul(plan, d8, rhs)          # [k+1, B, N]
    return jnp.moveaxis(out, 0, 1).reshape(lead + glwe.shape[-2:])


def cmux_mxu(cfg: ServerConfig, rings, ct0, ct1):
    """ct0 + extprod(ggsw, ct1 - ct0) (fourier/mod.rs:648-664)."""
    return ct0 + external_product_mxu(cfg, rings, ct1 - ct0)


# ---------------------------------------------------------------------------
# blind rotation / bootstrap
# ---------------------------------------------------------------------------


def blind_rotate_mxu(cfg: ServerConfig, bsk_rings, lut, lwe, *,
                     ms_offset: int = 0, lut_count_log: int = 0):
    """Blind rotation with the toeplitz-matmul CMux chain.

    bsk_rings: [n, R, k+1, 2N] u32 (bsk_to_mxu); lut [..., k+1, N] u32;
    lwe [..., n+1] u32. Returns the rotated accumulator [..., k+1, N].
    Bit-identical to bootstrap.blind_rotate (both are exact mod 2^32).
    """
    from . import checks

    checks.check_bsk_mxu(bsk_rings, cfg)
    checks.check_lwe(lwe, cfg.lwe_dimension)
    checks.check_glwe(lut, cfg.glwe_size, cfg.polynomial_size, "accumulator")
    plan = MxuPlan.from_config(cfg)
    N, ks1 = plan.polynomial_size, plan.glwe_size
    lead = lwe.shape[:-1]
    lwe_flat = lwe.reshape((-1, lwe.shape[-1]))
    b = lwe_flat.shape[0]
    b_hat = pbs_modulus_switch(
        lwe_flat[..., -1], N, ms_offset, lut_count_log)      # [B]
    a_hats = pbs_modulus_switch(
        lwe_flat[..., :-1], N, ms_offset, lut_count_log)     # [B, n]
    a_hats = jnp.moveaxis(a_hats, -1, 0)                     # [n, B]

    lut_b = jnp.broadcast_to(
        lut.reshape((-1, ks1, N)) if lut.ndim > 2 else lut[None],
        (b, ks1, N),
    )
    # poly-major [k+1, B, N]: the batch and coefficient axes stay trailing
    acc = jnp.moveaxis(lut_b, 1, 0)
    acc = polynomial.negacyclic_monomial_div(acc, b_hat[None, :])

    def step(acc, xs):
        rings_i, a_hat = xs                                  # [R,k+1,2N], [B]
        d8 = rotdig(plan, acc, a_hat)
        rhs = build_tables(rings_i, N, plan.n_words, plan.limb_drop)
        return acc + _toeplitz_matmul(plan, d8, rhs), None

    acc, _ = jax.lax.scan(step, acc, (bsk_rings, a_hats))
    return jnp.moveaxis(acc, 0, 1).reshape(lead + (ks1, N))


def bootstrap_mxu(cfg: ServerConfig, bsk_rings, lut, lwe):
    """Full PBS on the toeplitz-matmul path (fourier/mod.rs:878-911)."""
    return sample_extract(blind_rotate_mxu(cfg, bsk_rings, lut, lwe))


def bootstrap_many_lut_mxu(cfg: ServerConfig, bsk_rings, lut, lwe,
                           lut_count_log: int, *, ms_offset: int = 0):
    """Multi-LUT PBS on the toeplitz-matmul path (see
    bootstrap.bootstrap_many_lut)."""
    acc = blind_rotate_mxu(cfg, bsk_rings, lut, lwe, ms_offset=ms_offset,
                           lut_count_log=lut_count_log)
    return jnp.stack(
        [sample_extract_nth(acc, t) for t in range(1 << lut_count_log)], axis=0
    )


def bootstrap_keyswitch_mxu(cfg: ServerConfig, bsk_rings, ksk, lut, lwe):
    """PBS + keyswitch: the per-gate pipeline (server_key/mod.rs:133-166).

    ``ksk`` is either the u32/u64 keyswitch key tensor (i32 contraction) or
    an int8 limb-prepared key from lwe.ksk_to_limbs (a bit-identical int8
    contraction); ServerKey prepares it when ks_base_log <= 7."""
    big = bootstrap_mxu(cfg, bsk_rings, lut, lwe)
    return lwe_ops.keyswitch_any(
        ksk, big, base_log=cfg.ks_base_log, level_count=cfg.ks_level)


@functools.lru_cache(maxsize=None)
def jit_bootstrap_keyswitch_mxu(cfg: ServerConfig):
    return jax.jit(functools.partial(bootstrap_keyswitch_mxu, cfg))
