"""MXU toeplitz-matmul bootstrap path: bit-exact equivalence with the NTT
path (both are exact arithmetic mod 2^32) and end-to-end gate correctness."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from concrete_tpu.core import bootstrap as bs
from concrete_tpu.core import bootstrap_mxu as bsx
from concrete_tpu.core import glwe as glwe_mod
from concrete_tpu.core import lwe as lwe_mod
from concrete_tpu.core.ggsw import StandardBootstrapKey, bsk_to_ntt
from concrete_tpu.csprng import EncryptionRandomGenerator, SecretRandomGenerator

from common import TINY, TINY_K2


def _setup(params, seed=7):
    sgen = SecretRandomGenerator(seed)
    lwe_sk = lwe_mod.LweSecretKey.generate_binary(params.lwe_dimension, sgen)
    glwe_sk = glwe_mod.GlweSecretKey.generate_binary(
        params.glwe_dimension, params.polynomial_size, sgen
    )
    gen = EncryptionRandomGenerator(seed + 1, seed + 2)
    bsk = StandardBootstrapKey.generate(
        lwe_sk, glwe_sk, params.pbs_base_log, params.pbs_level,
        params.glwe_modular_std_dev.std_dev, gen,
    )
    cfg = bs.ServerConfig.from_boolean_parameters(params)
    return lwe_sk, glwe_sk, bsk, cfg, gen


@pytest.mark.parametrize("params", [TINY, TINY_K2], ids=["tiny", "tiny_k2"])
def test_external_product_mxu_matches_ntt(params):
    """Both paths compute the exact integer external product mod 2^32 —
    outputs must be bit-identical (incl. the digit-split path at
    pbs_base_log=8)."""
    lwe_sk, glwe_sk, bsk, cfg, gen = _setup(params)
    rng = np.random.default_rng(3)
    batch = 5
    glwe = jnp.asarray(
        rng.integers(0, 1 << 32,
                     size=(batch, cfg.glwe_size, cfg.polynomial_size),
                     dtype=np.uint32)
    )
    from concrete_tpu.core.ggsw import ggsw_to_ntt

    ggsw_raw = np.asarray(bsk.data[0])          # first key bit's GGSW
    ggsw_ntt = ggsw_to_ntt(ggsw_raw, cfg.primes, cfg.bits)
    want = np.asarray(bs.external_product(cfg, ggsw_ntt, glwe))

    rings = bsx.bsk_to_mxu(bsk.data, cfg)[0]
    got = np.asarray(bsx.external_product_mxu(cfg, jnp.asarray(rings), glwe))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", [TINY, TINY_K2], ids=["tiny", "tiny_k2"])
def test_blind_rotate_mxu_matches_ntt(params):
    lwe_sk, glwe_sk, bsk, cfg, gen = _setup(params)
    rng = np.random.default_rng(5)
    batch = 4
    lwe = jnp.asarray(
        rng.integers(0, 1 << 32, size=(batch, cfg.lwe_dimension + 1),
                     dtype=np.uint32)
    )
    lut = bs.trivial_lut_constant(cfg, np.uint32(1 << 29))
    bsk_ntt = bsk_to_ntt(bsk.data, cfg.primes, cfg.bits)
    want = np.asarray(bs.blind_rotate(cfg, bsk_ntt, lut, lwe))
    rings = jnp.asarray(bsx.bsk_to_mxu(bsk.data, cfg))
    got = np.asarray(bsx.blind_rotate_mxu(cfg, rings, lut, lwe))
    np.testing.assert_array_equal(got, want)


def test_full_pbs_mxu_decrypts():
    """End-to-end PBS on the MXU path refreshes +-1/8 encodings."""
    params = TINY
    lwe_sk, glwe_sk, bsk, cfg, gen = _setup(params)
    eighth = np.uint32(1 << 29)
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=32)
    pts = np.where(bits == 1, eighth, np.uint32(0) - eighth).astype(np.uint32)
    cts = lwe_sk.encrypt(pts, params.lwe_modular_std_dev.std_dev, gen)

    rings = jnp.asarray(bsx.bsk_to_mxu(bsk.data, cfg))
    lut = bs.trivial_lut_constant(cfg, eighth)
    out = np.asarray(bsx.bootstrap_mxu(cfg, rings, lut, jnp.asarray(cts)))
    big_key = glwe_sk.into_lwe_key()
    dec = big_key.decrypt(out)
    # sign test: decrypted value close to +-1/8
    signed = dec.astype(np.int32)
    want = np.where(bits == 1, 1, -1)
    got = np.where(signed > 0, 1, -1)
    np.testing.assert_array_equal(got, want)


def test_blind_rotate_mxu_matches_ntt_u64():
    """The u64-torus MXU path (2 word-planes, 8 limbs) is bit-identical to
    the exact-NTT path — the highlevel (concrete-crate analog) regime."""
    from concrete_tpu.csprng import SecretRandomGenerator

    cfg = bs.ServerConfig(
        lwe_dimension=10, glwe_dimension=1, polynomial_size=64,
        pbs_base_log=10, pbs_level=3, ks_base_log=4, ks_level=3, bits=64)
    sgen = SecretRandomGenerator(3)
    lwe_sk = lwe_mod.LweSecretKey.generate_binary(cfg.lwe_dimension, sgen, bits=64)
    glwe_sk = glwe_mod.GlweSecretKey.generate_binary(
        cfg.glwe_dimension, cfg.polynomial_size, sgen, bits=64)
    gen = EncryptionRandomGenerator(4, 5)
    bsk = StandardBootstrapKey.generate(
        lwe_sk, glwe_sk, cfg.pbs_base_log, cfg.pbs_level, 2.0 ** -40, gen)
    rng = np.random.default_rng(0)
    lwe = jnp.asarray(rng.integers(
        0, 1 << 62, size=(4, cfg.lwe_dimension + 1), dtype=np.uint64))
    lut = bs.trivial_lut_constant(cfg, np.uint64(1 << 60))
    want = np.asarray(bs.blind_rotate(
        cfg, bsk_to_ntt(bsk.data, cfg.primes, 64), lut, lwe))
    rings = jnp.asarray(bsx.bsk_to_mxu(bsk.data, cfg))
    got = np.asarray(bsx.blind_rotate_mxu(cfg, rings, lut, lwe))
    np.testing.assert_array_equal(got, want)


def test_external_product_mxu_three_way_split():
    """base_log=16 digits need a 3-way int8 chunking (u64 torus)."""
    from concrete_tpu.csprng import SecretRandomGenerator

    cfg = bs.ServerConfig(
        lwe_dimension=4, glwe_dimension=1, polynomial_size=64,
        pbs_base_log=16, pbs_level=2, ks_base_log=4, ks_level=3, bits=64)
    assert bsx.MxuPlan.from_config(cfg).n_sub == 3
    sgen = SecretRandomGenerator(3)
    glwe_sk = glwe_mod.GlweSecretKey.generate_binary(
        cfg.glwe_dimension, cfg.polynomial_size, sgen, bits=64)
    gen = EncryptionRandomGenerator(4, 5)
    from concrete_tpu.core.ggsw import encrypt_constant_ggsw, ggsw_to_ntt

    ggsw = encrypt_constant_ggsw(
        glwe_sk, 1, cfg.pbs_base_log, cfg.pbs_level, 2.0 ** -45, gen)
    rng = np.random.default_rng(0)
    glwe = jnp.asarray(rng.integers(
        0, 1 << 62, size=(3, cfg.glwe_size, cfg.polynomial_size), dtype=np.uint64))
    want = np.asarray(bs.external_product(
        cfg, ggsw_to_ntt(ggsw, cfg.primes, 64), glwe))
    rings = jnp.asarray(bsx.bsk_to_mxu(ggsw[None], cfg)[0])
    got = np.asarray(bsx.external_product_mxu(cfg, rings, glwe))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("drop", [1, 2])
def test_external_product_mxu_limb_drop_rounds_rings(drop):
    """limb_drop=d must equal the exact external product against rings whose
    d lowest packed bytes are zeroed — i.e. every toeplitz entry rounded to
    the nearest multiple of 2^{8d} (balanced limbs round to nearest)."""
    import dataclasses as dc

    from concrete_tpu.core.ggsw import encrypt_constant_ggsw

    cfg = bs.ServerConfig(
        lwe_dimension=4, glwe_dimension=1, polynomial_size=64,
        pbs_base_log=7, pbs_level=2, ks_base_log=4, ks_level=3)
    sgen = SecretRandomGenerator(3)
    glwe_sk = glwe_mod.GlweSecretKey.generate_binary(
        cfg.glwe_dimension, cfg.polynomial_size, sgen)
    gen = EncryptionRandomGenerator(4, 5)
    ggsw = encrypt_constant_ggsw(
        glwe_sk, 1, cfg.pbs_base_log, cfg.pbs_level, 2.0 ** -25, gen)
    rng = np.random.default_rng(0)
    glwe = jnp.asarray(rng.integers(
        0, 1 << 32, size=(3, cfg.glwe_size, cfg.polynomial_size),
        dtype=np.uint32))

    rings = bsx.bsk_to_mxu(ggsw[None], cfg)[0]
    cfg_fast = dc.replace(cfg, mxu_limb_drop=drop)
    got = np.asarray(
        bsx.external_product_mxu(cfg_fast, jnp.asarray(rings), glwe))

    # the packed-word bytes ARE the balanced limbs (carries folded), so
    # zeroing the low d bytes is exactly the rounding the fast RHS applies
    masked = rings & np.uint32(0xFFFFFFFF << (8 * drop) & 0xFFFFFFFF)
    want = np.asarray(
        bsx.external_product_mxu(cfg, jnp.asarray(masked), glwe))
    np.testing.assert_array_equal(got, want)


def test_fast_mode_gates_tiny():
    """Boolean gates stay correct under the reduced-precision fast mode
    (level slice + limb drop) on the CPU/jnp path."""
    from concrete_tpu import boolean

    cks = boolean.ClientKey.new(TINY_K2, secret_seed=11)
    sks = boolean.ServerKey.new(cks, mask_seed=12, noise_seed=13)
    fast = sks.with_fast_mode(limb_drop=1, levels=2)
    assert fast.cfg.pbs_level == 2 and fast.cfg.mxu_limb_drop == 1
    a = cks.encrypt([True, True, False, False], mask_seed=14, noise_seed=15)
    b = cks.encrypt([True, False, True, False], mask_seed=16, noise_seed=17)
    # ntt backend (CPU default): levels reduction only
    np.testing.assert_array_equal(
        cks.decrypt(np.array(fast.and_(a, b))), [True, False, False, False])
    # force the mxu (jnp fallback) path so limb_drop is exercised end-to-end
    import dataclasses as dc

    fast_mxu = dc.replace(fast, backend="mxu", _bsk_ntt=None, _bsk_mxu=None)
    np.testing.assert_array_equal(
        cks.decrypt(np.array(fast_mxu.or_(a, b))), [True, True, True, False])


def test_external_product_mxu_limb_drop_u64():
    """u64 torus limb_drop: dropping d global byte limbs equals the exact
    external product against rings whose low-word packed bytes are zeroed
    (the u64 reduced-precision regime has d up to 6)."""
    import dataclasses as dc

    from concrete_tpu.core.ggsw import encrypt_constant_ggsw

    drop = 2
    cfg = bs.ServerConfig(
        lwe_dimension=4, glwe_dimension=1, polynomial_size=64,
        pbs_base_log=7, pbs_level=2, ks_base_log=4, ks_level=3, bits=64)
    sgen = SecretRandomGenerator(3)
    glwe_sk = glwe_mod.GlweSecretKey.generate_binary(
        cfg.glwe_dimension, cfg.polynomial_size, sgen, bits=64)
    gen = EncryptionRandomGenerator(4, 5)
    ggsw = encrypt_constant_ggsw(
        glwe_sk, 1, cfg.pbs_base_log, cfg.pbs_level, 2.0 ** -45, gen)
    rng = np.random.default_rng(0)
    glwe = jnp.asarray(rng.integers(
        0, 1 << 64, size=(3, cfg.glwe_size, cfg.polynomial_size),
        dtype=np.uint64))

    rings = bsx.bsk_to_mxu(ggsw[None], cfg)[0]   # [R, ks1*2, 2N] u32 words
    cfg_fast = dc.replace(cfg, mxu_limb_drop=drop)
    got = np.asarray(
        bsx.external_product_mxu(cfg_fast, jnp.asarray(rings), glwe))

    # zero the low `drop` packed bytes of every LOW word plane (w == 0)
    masked = rings.copy()
    lowmask = np.uint32(0xFFFFFFFF << (8 * drop) & 0xFFFFFFFF)
    masked = masked.reshape(rings.shape[0], -1, 2, rings.shape[-1])
    masked[:, :, 0, :] &= lowmask
    masked = masked.reshape(rings.shape)
    want = np.asarray(
        bsx.external_product_mxu(cfg, jnp.asarray(masked), glwe))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The XLA forms of the CMux step stages against independent numpy / Python
# references: numpy toeplitz tables and products, numpy negacyclic rotation,
# Python-int limb recombination and gadget recomposition.
# ---------------------------------------------------------------------------


def _np_rotate(acc, a_hat):
    """X^a * p per lane, numpy: acc [k+1, B, N] unsigned, a_hat [B]."""
    out = np.empty_like(acc)
    n = acc.shape[-1]
    for b, a in enumerate(np.asarray(a_hat).astype(np.int64) % (2 * n)):
        p = np.roll(acc[:, b, :], int(a % n), axis=-1)
        p[:, : a % n] = np.zeros_like(p[:, : a % n]) - p[:, : a % n]
        out[:, b, :] = np.zeros_like(p) - p if a >= n else p
    return out


def _np_closest(x, base_log, level, bits):
    """Round unsigned `x` to the nearest multiple of 2^(bits - bl*l) (ties
    up), as Python ints."""
    shift = bits - base_log * level
    v = x.astype(object)
    if shift:
        v = ((v + (1 << (shift - 1))) >> shift) << shift
    return v % (1 << bits)


def _check_digit_matrix(plan, d8, diff):
    """d8 [B, R*N] must be a valid balanced gadget decomposition of diff
    [k+1, B, N]: every (sub-)digit in its int8 range, and the digits
    recompose to closest_representable(diff) mod 2^bits."""
    bits = plan.bits
    ks1, b, n = diff.shape
    d = np.asarray(d8).astype(np.int64).reshape(
        b, plan.level, plan.n_sub, ks1, n)
    if plan.n_sub == 1:
        assert np.abs(d).max() <= 1 << (plan.base_log - 1)
    else:
        assert np.abs(d).max() <= 64
    sub_w = 1 << (7 * (plan.n_sub - 1 - np.arange(plan.n_sub)))
    digits = (d * sub_w[None, None, :, None, None]).sum(axis=2)   # [B,l,k+1,N]
    total = np.zeros((ks1, b, n), dtype=object)
    for lev in range(plan.level):
        w = 1 << (bits - plan.base_log * (lev + 1))
        total = total + np.moveaxis(digits[:, lev], 0, 1).astype(object) * w
    total = total % (1 << bits)
    want = _np_closest(np.asarray(diff), plan.base_log, plan.level, bits)
    np.testing.assert_array_equal(total, want)


def _np_recombine(plan, s):
    """Python-int limb recombination: [B, (kj, limb, c)] i32 ->
    [k+1, B, N] mod 2^bits."""
    n, lu, ks1 = plan.polynomial_size, plan.limbs_used, plan.glwe_size
    s = np.asarray(s).astype(object)
    out = []
    for kj in range(ks1):
        acc = np.zeros((s.shape[0], n), dtype=object)
        for j in range(lu):
            c0 = (kj * lu + j) * n
            acc = acc + s[:, c0:c0 + n] * (1 << (8 * (plan.limb_drop + j)))
        out.append(acc % (1 << plan.bits))
    dt = np.uint32 if plan.bits == 32 else np.uint64
    return np.stack(out).astype(dt)


def _np_toeplitz_tables(rings, n, n_words=1, limb_drop=0):
    """numpy build of the int8 RHS: row (blk, r), column (kj, limb, c) is
    byte limb m of word w of ring[(c - r) mod 2N]."""
    rings = np.asarray(rings)
    r_blocks, planes, _ = rings.shape
    ks1 = planes // n_words
    idx = (np.arange(n)[None, :] - np.arange(n)[:, None]) % (2 * n)  # [r, c]
    kept = [(w, m) for w in range(n_words) for m in range(4)
            if 4 * w + m >= limb_drop]
    out = np.empty((r_blocks, n, ks1, len(kept), n), dtype=np.int8)
    for blk in range(r_blocks):
        for kj in range(ks1):
            for li, (w, m) in enumerate(kept):
                word = rings[blk, kj * n_words + w][idx]           # [r, c]
                out[blk, :, kj, li, :] = ((word >> np.uint32(8 * m))
                                          & np.uint32(0xFF)).astype(np.int8)
    return out.reshape(r_blocks * n, ks1 * len(kept) * n)


def _np_toeplitz_product(plan, rings, d8):
    """numpy external-product sum: decode each ring word-group to its value
    (balanced limbs >= limb_drop), build T[r, c] = value[(c - r) mod 2N] and
    accumulate d8-block @ T in wrapping uint64 -> [k+1, B, N] mod 2^bits."""
    rings = np.asarray(rings)
    n, nw, ks1 = plan.polynomial_size, plan.n_words, plan.glwe_size
    idx = (np.arange(n)[None, :] - np.arange(n)[:, None]) % (2 * n)
    d = np.asarray(d8).astype(np.int64).astype(np.uint64)
    out = np.zeros((ks1, d.shape[0], n), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for blk in range(plan.row_blocks):
            for kj in range(ks1):
                val = np.zeros(2 * n, dtype=np.uint64)
                for m in range(plan.limb_drop, 4 * nw):
                    byte = (rings[blk, kj * nw + m // 4].astype(np.int64)
                            >> (8 * (m % 4))) & 0xFF
                    sext = np.where(byte >= 128, byte - 256, byte)
                    val += (sext << (8 * m)).astype(np.uint64)
                out[kj] += d[:, blk * n:(blk + 1) * n] @ val[idx]
    if plan.bits == 32:
        return (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def _rand_a_hat(rng, b, n):
    """Degrees in [0, 2N) including the wrap edges 0, N and 2N-1."""
    return np.concatenate([rng.integers(0, 2 * n, size=b - 3),
                           [0, n, 2 * n - 1]])


@pytest.mark.parametrize("r_blocks,ks1,N", [(6, 2, 128), (2, 3, 128)])
def test_build_tables_matches_numpy_toeplitz(r_blocks, ks1, N):
    """The log-doubling table build equals a direct numpy toeplitz
    expansion of the rotation rings."""
    rng = np.random.default_rng(7)
    rings = rng.integers(0, 1 << 32, size=(r_blocks, ks1, 2 * N),
                         dtype=np.uint32)
    got = np.asarray(bsx.build_tables(jnp.asarray(rings), N))
    np.testing.assert_array_equal(got, _np_toeplitz_tables(rings, N))


def test_ntt_cmux_step_matches_naive_polymul():
    """One NTT-backend CMux step (rotation + stacked-prime external
    product) equals the schoolbook negacyclic external product of the
    numpy-rotated accumulator's gadget digits against the GGSW."""
    from concrete_tpu.core.bootstrap import _external_product_stacked
    from concrete_tpu.core.ggsw import ggsw_to_ntt
    from concrete_tpu.math import decomposition
    from concrete_tpu.math import ntt as ntt_mod
    from concrete_tpu.math.polynomial import polymul_wrapping_naive

    cfg = bs.ServerConfig(
        lwe_dimension=4, glwe_dimension=1, polynomial_size=64,
        pbs_base_log=6, pbs_level=2, ks_base_log=4, ks_level=3)
    rng = np.random.default_rng(11)
    B, ks1, N, l = 8, cfg.glwe_size, cfg.polynomial_size, cfg.pbs_level
    acc = rng.integers(0, 1 << 32, size=(ks1, B, N), dtype=np.uint32)
    a_hat = _rand_a_hat(rng, B, N)
    ggsw = rng.integers(0, 1 << 32, size=(l, ks1, ks1, N), dtype=np.uint32)

    sp = ntt_mod.make_stacked_plans(N, cfg.primes)
    rot = jnp.asarray(_np_rotate(acc, a_hat))
    got = np.asarray(jnp.asarray(acc) + _external_product_stacked(
        cfg, sp, ggsw_to_ntt(ggsw, cfg.primes, 32), rot - jnp.asarray(acc)))

    diff = np.asarray(rot) - acc
    digits = np.asarray(decomposition.decompose_rounded(
        jnp.asarray(diff), cfg.pbs_base_log, l))          # [k+1, B, N, l]
    plan = bsx.MxuPlan(lwe_dimension=4, glwe_size=ks1, polynomial_size=N,
                       base_log=6, level=l, n_sub=1, ks_base_log=4,
                       ks_level=3)
    d8 = np.concatenate([digits[ki, :, :, lev].astype(np.int8)
                         for lev in range(l) for ki in range(ks1)], axis=1)
    _check_digit_matrix(plan, d8, diff)
    want = acc.copy()
    with np.errstate(over="ignore"):
        for lev in range(l):
            for ki in range(ks1):
                d = digits[ki, :, :, lev].astype(np.int64).astype(np.uint32)
                for kj in range(ks1):
                    want[kj] += polymul_wrapping_naive(
                        d, np.broadcast_to(ggsw[lev, ki, kj], d.shape))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,l,bl,drop", [(1, 3, 7, 0), (2, 2, 8, 0),
                                         (1, 2, 7, 1)])
def test_cmux_step_matches_numpy_toeplitz(k, l, bl, drop):
    """acc + toeplitz product (table build + int8 dot + limb recombine)
    equals the numpy toeplitz product against the decoded rings, across
    glwe dims, digit splits and limb drops."""
    cfg = bs.ServerConfig(
        lwe_dimension=4, glwe_dimension=k, polynomial_size=64,
        pbs_base_log=bl, pbs_level=l, ks_base_log=4, ks_level=3,
        mxu_limb_drop=drop)
    plan = bsx.MxuPlan.from_config(cfg)
    rng = np.random.default_rng(k * 10 + l)
    R, ks1, N = plan.row_blocks, plan.glwe_size, cfg.polynomial_size
    B = 8
    rings = rng.integers(0, 1 << 32, size=(R, ks1, 2 * N), dtype=np.uint32)
    glwe = rng.integers(0, 1 << 32, size=(ks1, B, N), dtype=np.uint32)
    acc = rng.integers(0, 1 << 32, size=(ks1, B, N), dtype=np.uint32)
    d8 = bsx._digit_matrix(plan, jnp.asarray(glwe))
    _check_digit_matrix(plan, d8, glwe)
    rhs = bsx.build_tables(jnp.asarray(rings), N, plan.n_words,
                           plan.limb_drop)
    got = np.asarray(jnp.asarray(acc) + bsx._toeplitz_matmul(plan, d8, rhs))
    want = acc + _np_toeplitz_product(plan, rings, d8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ks1,n,bl,l", [(5, 256, 7, 2), (2, 128, 7, 3),
                                        (3, 64, 4, 2)])
def test_rotdig_matches_numpy_rotation(ks1, n, bl, l):
    """rotdig = gadget digits of (X^a_hat * acc - acc): checked against a
    numpy negacyclic rotation and Python-int recomposition, including
    degrees in [N, 2N) (the negated wrap half)."""
    plan = bsx.MxuPlan(
        lwe_dimension=4, glwe_size=ks1, polynomial_size=n, base_log=bl,
        level=l, n_sub=1, ks_base_log=2, ks_level=3)
    rng = np.random.default_rng(9)
    acc = rng.integers(0, 1 << 32, size=(ks1, 16, n), dtype=np.uint32)
    a_hat = _rand_a_hat(rng, 16, n)
    d8 = bsx.rotdig(plan, jnp.asarray(acc), jnp.asarray(a_hat))
    _check_digit_matrix(plan, d8, _np_rotate(acc, a_hat) - acc)


@pytest.mark.parametrize("ks1,n,bl,l,drop", [(5, 256, 7, 2, 0),
                                             (2, 128, 7, 3, 0),
                                             (3, 64, 7, 2, 1)])
def test_recombine_then_rotdig_matches_python_int(ks1, n, bl, l, drop):
    """acc + recombine_limb_planes(s) equals the Python-int limb sum, and
    the next step's rotation digits recompose to its rotation delta."""
    plan = bsx.MxuPlan(
        lwe_dimension=4, glwe_size=ks1, polynomial_size=n, base_log=bl,
        level=l, n_sub=1, ks_base_log=2, ks_level=3, limb_drop=drop)
    rng = np.random.default_rng(13)
    B = 16
    acc = rng.integers(0, 1 << 32, size=(ks1, B, n), dtype=np.uint32)
    s = rng.integers(-(1 << 30), 1 << 30,
                     size=(B, ks1 * plan.limbs_used * n), dtype=np.int32)
    a_hat = _rand_a_hat(rng, B, n)
    acc_new = np.asarray(jnp.asarray(acc)
                         + bsx.recombine_limb_planes(plan, jnp.asarray(s)))
    np.testing.assert_array_equal(acc_new, acc + _np_recombine(plan, s))
    d8 = bsx.rotdig(plan, jnp.asarray(acc_new), jnp.asarray(a_hat))
    _check_digit_matrix(plan, d8, _np_rotate(acc_new, a_hat) - acc_new)


@pytest.mark.parametrize("ks1,n,bl,l,n_sub", [(3, 128, 8, 2, 2),
                                              (2, 64, 12, 2, 2)])
def test_recombine_then_rotdig_nsub_matches_python_int(ks1, n, bl, l, n_sub):
    """The same composition with sub-digit splitting (DEFAULT's bl=8
    regime): balanced 7-bit chunks, MSB-first."""
    plan = bsx.MxuPlan(
        lwe_dimension=4, glwe_size=ks1, polynomial_size=n, base_log=bl,
        level=l, n_sub=n_sub, ks_base_log=2, ks_level=3)
    rng = np.random.default_rng(41)
    B = 16
    acc = rng.integers(0, 1 << 32, size=(ks1, B, n), dtype=np.uint32)
    s = rng.integers(-(1 << 30), 1 << 30,
                     size=(B, ks1 * plan.limbs_used * n), dtype=np.int32)
    a_hat = _rand_a_hat(rng, B, n)
    acc_new = np.asarray(jnp.asarray(acc)
                         + bsx.recombine_limb_planes(plan, jnp.asarray(s)))
    np.testing.assert_array_equal(acc_new, acc + _np_recombine(plan, s))
    d8 = bsx.rotdig(plan, jnp.asarray(acc_new), jnp.asarray(a_hat))
    _check_digit_matrix(plan, d8, _np_rotate(acc_new, a_hat) - acc_new)


@pytest.mark.parametrize("ks1,n,bl,l,n_sub", [(3, 128, 8, 2, 2),
                                              (2, 64, 12, 2, 2),
                                              (2, 64, 15, 2, 3)])
def test_rotdig_nsub_matches_numpy_rotation(ks1, n, bl, l, n_sub):
    """rotdig with sub-digit splitting (n_sub=2 — DEFAULT's base_log=8 —
    and the general n_sub=3 chunk loop) against the numpy references."""
    plan = bsx.MxuPlan(
        lwe_dimension=4, glwe_size=ks1, polynomial_size=n, base_log=bl,
        level=l, n_sub=n_sub, ks_base_log=2, ks_level=3)
    rng = np.random.default_rng(23)
    acc = rng.integers(0, 1 << 32, size=(ks1, 16, n), dtype=np.uint32)
    a_hat = _rand_a_hat(rng, 16, n)
    d8 = bsx.rotdig(plan, jnp.asarray(acc), jnp.asarray(a_hat))
    _check_digit_matrix(plan, d8, _np_rotate(acc, a_hat) - acc)


@pytest.mark.parametrize("drop", [0, 2])
def test_recombine_limb_planes_u64_matches_python_int(drop):
    """The i64 limb recombination of the u64 torus equals the Python-int
    sum over the full i32 dot-output range, including sign extension of
    every limb and carries across the 32-bit word boundary."""
    plan = bsx.MxuPlan(
        lwe_dimension=4, glwe_size=3, polynomial_size=64, base_log=7,
        level=2, n_sub=1, ks_base_log=2, ks_level=3, bits=64,
        limb_drop=drop)
    rng = np.random.default_rng(29)
    s = rng.integers(-(1 << 31), 1 << 31,
                     size=(16, 3 * plan.limbs_used * 64)).astype(np.int32)
    # adversarial rows: all-max, all-min, alternating-sign extremes
    s[0, :] = np.int32(2**31 - 1)
    s[1, :] = np.int32(-(2**31))
    s[2, ::2], s[2, 1::2] = np.int32(2**31 - 1), np.int32(-(2**31))
    got = np.asarray(bsx.recombine_limb_planes(plan, jnp.asarray(s)))
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, _np_recombine(plan, s))


@pytest.mark.parametrize("ks1,n,bl,l,n_sub", [(3, 64, 7, 3, 1),
                                              (2, 128, 10, 3, 2),
                                              (2, 64, 16, 2, 3)])
def test_rotdig_u64_matches_numpy_rotation(ks1, n, bl, l, n_sub):
    """u64-torus rotdig against the numpy references, with carry/borrow
    extremes at the 32-bit word boundary and the rounding-bit edge where
    bl*l = 32 (bl=16, l=2)."""
    plan = bsx.MxuPlan(
        lwe_dimension=4, glwe_size=ks1, polynomial_size=n, base_log=bl,
        level=l, n_sub=n_sub, ks_base_log=2, ks_level=3, bits=64)
    rng = np.random.default_rng(31)
    acc = rng.integers(0, 1 << 64, size=(ks1, 16, n), dtype=np.uint64)
    acc[0, 0, :4] = [0, 1, 0xFFFF_FFFF, 0x1_0000_0000]
    acc[0, 1, :4] = [0xFFFF_FFFF_FFFF_FFFF, 0x8000_0000,
                     0x7FFF_FFFF_FFFF_FFFF, 0x8000_0000_0000_0000]
    a_hat = _rand_a_hat(rng, 16, n)
    d8 = bsx.rotdig(plan, jnp.asarray(acc), jnp.asarray(a_hat))
    _check_digit_matrix(plan, d8, _np_rotate(acc, a_hat) - acc)


def test_rotdig_u64_wide_prefix_matches_numpy_rotation():
    """u64 digits with more than 32 prefix bits (bl=12, l=3: 36 bits, two
    sub-digits) — the plain XLA form has no prefix limit."""
    plan = bsx.MxuPlan(
        lwe_dimension=4, glwe_size=2, polynomial_size=64, base_log=12,
        level=3, n_sub=2, ks_base_log=2, ks_level=3, bits=64)
    rng = np.random.default_rng(33)
    acc = rng.integers(0, 1 << 64, size=(2, 16, 64), dtype=np.uint64)
    a_hat = _rand_a_hat(rng, 16, 64)
    d8 = bsx.rotdig(plan, jnp.asarray(acc), jnp.asarray(a_hat))
    _check_digit_matrix(plan, d8, _np_rotate(acc, a_hat) - acc)


def test_blind_rotate_mxu_u64_random_key_matches_ntt():
    """The u64 toeplitz blind rotation equals the exact-NTT blind rotation
    bit for bit on a random bootstrap-key-shaped tensor (bl=10: the n_sub=2
    u64 digit ladder)."""
    cfg = bs.ServerConfig(
        lwe_dimension=6, glwe_dimension=1, polynomial_size=64,
        pbs_base_log=10, pbs_level=3, ks_base_log=4, ks_level=3, bits=64)
    rng = np.random.default_rng(37)
    B = 8
    bsk_raw = rng.integers(0, 1 << 64,
                           size=(cfg.lwe_dimension, cfg.pbs_level,
                                 cfg.glwe_size, cfg.glwe_size,
                                 cfg.polynomial_size), dtype=np.uint64)
    lut = jnp.asarray(rng.integers(0, 1 << 64,
                                   size=(cfg.glwe_size, cfg.polynomial_size),
                                   dtype=np.uint64))
    lwe = jnp.asarray(rng.integers(0, 1 << 64, size=(B, cfg.lwe_dimension + 1),
                                   dtype=np.uint64))
    want = np.asarray(bs.blind_rotate(
        cfg, bsk_to_ntt(bsk_raw, cfg.primes, 64), lut, lwe))
    got = np.asarray(bsx.blind_rotate_mxu(
        cfg, jnp.asarray(bsx.bsk_to_mxu(bsk_raw, cfg)), lut, lwe))
    np.testing.assert_array_equal(got, want)
