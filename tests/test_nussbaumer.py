"""Nussbaumer-domain external product: exactness and bit-identity.

The Nussbaumer path (math/nussbaumer.py + core/bootstrap_nuss.py) computes
the negacyclic N-product as 2L M-point toeplitz matmuls with rotation-only
transforms. Everything is exact integer arithmetic, so the contract is
BIT-IDENTITY: against the direct MXU toeplitz path where both exist
(N <= 4096), and against the exact-NTT path at large N (8192) where the
direct path refuses (its O(N^2) RHS). Reference surface being covered:
polynomial sizes up to 16384, concrete-core .../math/fft/mod.rs:28.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from concrete_tpu.core import bootstrap as bs
from concrete_tpu.core import bootstrap_mxu as bsx
from concrete_tpu.core import bootstrap_nuss as bsn
from concrete_tpu.math import nussbaumer as nb
from concrete_tpu.math.polynomial import polymul_wrapping_naive


def test_transform_polymul_exact():
    """chunk/forward/pointwise/inverse/fold == schoolbook mod 2^32, with the
    2L headroom carried in u64 lanes."""
    rng = np.random.default_rng(0)

    def mulm_naive(fa, fb):
        fa, fb = np.asarray(fa), np.asarray(fb)
        out = np.zeros_like(fa)
        for idx in np.ndindex(fa.shape[:-1]):
            out[idx] = polymul_wrapping_naive(fa[idx], fb[idx])
        return out

    for (n, l) in [(16, 2), (64, 4), (256, 8)]:
        a32 = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        b32 = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        want = polymul_wrapping_naive(a32, b32)
        with np.errstate(over="ignore"):
            got = nb.negacyclic_polymul_nuss(
                a32.astype(np.uint64), b32.astype(np.uint64), l,
                mulm_naive).astype(np.uint32)
        np.testing.assert_array_equal(want, got)


def test_roundtrip_identity():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 32, 128, dtype=np.uint32).astype(np.uint64)
    for l in (2, 4, 8):
        with np.errstate(over="ignore"):
            back = nb.inverse_raw(nb.forward(nb.chunk(x, l), l), l)
            want = nb.chunk(x, l) * np.uint64(2 * l)
        np.testing.assert_array_equal(np.asarray(back), want)


@pytest.mark.parametrize("n,k,N,bl,lv,L", [
    (6, 1, 64, 7, 2, 2),
    (5, 2, 128, 7, 3, 4),
    (4, 1, 256, 8, 2, 8),     # digit sub-split both before and after
])
def test_bit_identity_vs_mxu(n, k, N, bl, lv, L):
    rng = np.random.default_rng(2)
    cfg = bs.ServerConfig(lwe_dimension=n, glwe_dimension=k,
                          polynomial_size=N, pbs_base_log=bl, pbs_level=lv,
                          ks_base_log=4, ks_level=3)
    bsk_raw = rng.integers(0, 1 << 32, size=(n, lv, k + 1, k + 1, N),
                           dtype=np.uint32)
    rings_m = jnp.asarray(bsx.bsk_to_mxu(bsk_raw, cfg))
    rings_n = jnp.asarray(bsn.bsk_to_nuss(bsk_raw, cfg, L))
    lut = jnp.asarray(rng.integers(0, 1 << 32, size=(k + 1, N),
                                   dtype=np.uint32))
    lwe = jnp.asarray(rng.integers(0, 1 << 32, size=(4, n + 1),
                                   dtype=np.uint32))
    want = np.asarray(bsx.blind_rotate_mxu(cfg, rings_m, lut, lwe))
    got = np.asarray(bsn.blind_rotate_nuss(cfg, rings_n, lut, lwe, l=L))
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("n,k,N,bl,lv,L", [
    (4, 1, 64, 7, 2, 2),
    (3, 2, 128, 7, 2, 4),
    (3, 1, 256, 10, 2, 8),    # u64 digit ladder with sub-splitting
])
def test_bit_identity_vs_mxu_u64(n, k, N, bl, lv, L):
    """u64-TORUS Nussbaumer path (the highlevel crate's regime,
    concrete/src/lib.rs:22): the forward transform rides host-side 128-bit
    pairs, the recombine rides u64 device pairs — must be bit-identical to
    the direct u64 toeplitz path."""
    rng = np.random.default_rng(7)
    cfg = bs.ServerConfig(lwe_dimension=n, glwe_dimension=k,
                          polynomial_size=N, pbs_base_log=bl, pbs_level=lv,
                          ks_base_log=4, ks_level=3, bits=64)
    plan = bsn.NussPlan.from_config(cfg, L)
    assert plan.w_prime == 64 + plan.shift
    assert plan.n_words == 3
    bsk_raw = rng.integers(0, 1 << 64, size=(n, lv, k + 1, k + 1, N),
                           dtype=np.uint64)
    rings_m = jnp.asarray(bsx.bsk_to_mxu(bsk_raw, cfg))
    rings_n = jnp.asarray(bsn.bsk_to_nuss(bsk_raw, cfg, L))
    lut = jnp.asarray(rng.integers(0, 1 << 64, size=(k + 1, N),
                                   dtype=np.uint64))
    lwe = jnp.asarray(rng.integers(0, 1 << 64, size=(4, n + 1),
                                   dtype=np.uint64))
    want = np.asarray(bsx.blind_rotate_mxu(cfg, rings_m, lut, lwe))
    got = np.asarray(bsn.blind_rotate_nuss(cfg, rings_n, lut, lwe, l=L))
    np.testing.assert_array_equal(want, got)


@pytest.mark.slow
def test_bit_identity_vs_ntt_large_n():
    """N=8192: the direct MXU path refuses (O(N^2) RHS); the Nussbaumer path
    must match the exact-NTT oracle bit for bit."""
    rng = np.random.default_rng(3)
    n, k, N, bl, lv = 3, 1, 8192, 7, 1
    cfg = bs.ServerConfig(lwe_dimension=n, glwe_dimension=k,
                          polynomial_size=N, pbs_base_log=bl, pbs_level=lv,
                          ks_base_log=4, ks_level=3)
    with pytest.raises(NotImplementedError):
        bsx.MxuPlan.from_config(cfg)
    from concrete_tpu.core.ggsw import bsk_to_ntt

    bsk_raw = rng.integers(0, 1 << 32, size=(n, lv, k + 1, k + 1, N),
                           dtype=np.uint32)
    rings_n = jnp.asarray(bsn.bsk_to_nuss(bsk_raw, cfg))  # auto L
    bsk_ntt = bsk_to_ntt(bsk_raw, cfg.primes, 32)
    lut = jnp.asarray(rng.integers(0, 1 << 32, size=(k + 1, N),
                                   dtype=np.uint32))
    lwe = jnp.asarray(rng.integers(0, 1 << 32, size=(2, n + 1),
                                   dtype=np.uint32))
    want = np.asarray(bs.blind_rotate(cfg, bsk_ntt, lut, lwe))
    got = np.asarray(bsn.blind_rotate_nuss(cfg, rings_n, lut, lwe))
    np.testing.assert_array_equal(want, got)


def test_plan_validation():
    cfg = bs.ServerConfig(lwe_dimension=4, glwe_dimension=1,
                          polynomial_size=64, pbs_base_log=7, pbs_level=2,
                          ks_base_log=4, ks_level=3)
    plan = bsn.NussPlan.from_config(cfg, 4)
    assert plan.m == 16 and plan.two_l == 8 and plan.shift == 3
    assert plan.w_prime == 35 and plan.limbs_used == 5
    with pytest.raises(ValueError):
        bsn.NussPlan.from_config(cfg, 16)  # L > M
    assert nb.pick_l(8192) >= 8 and 8192 % nb.pick_l(8192) == 0


def test_best_l_model():
    """Config-aware default L: minimize 2L*n_sub*limbs*M^2, tying to the
    smaller L."""
    mk = lambda N, bl: bs.ServerConfig(
        lwe_dimension=8, glwe_dimension=1, polynomial_size=N,
        pbs_base_log=bl, pbs_level=3, ks_base_log=2, ks_level=5)
    # bl=2: n_sub stays 1 through L=32 (bl_eff=7); L=64 doubles n_sub for
    # the same MACs -> 32 wins the tie by coming first
    assert bsn.NussPlan.best_l(mk(8192, 2)) == 32
    # bl=7: L=64 has the fewest MACs
    assert bsn.NussPlan.best_l(mk(8192, 7)) == 64
    # N=16384: L=128 halves the MACs of L=32
    l16 = bsn.NussPlan.best_l(mk(16384, 2))
    assert l16 == 128


def test_server_key_nuss_backend():
    """Full boolean gate through ServerKey with backend='nuss': decrypts to
    the right truth table and is bit-identical to the ntt backend."""
    import dataclasses

    from concrete_tpu import boolean
    from common import TINY

    cks, sks = boolean.gen_keys(TINY, secret_seed=1, mask_seed=2,
                                noise_seed=3)
    assert bsn.NussPlan.from_config(
        bs.ServerConfig.from_boolean_parameters(TINY)).l >= 2
    sks_nuss = dataclasses.replace(sks, backend="nuss")
    sks_ntt = dataclasses.replace(sks, backend="ntt")
    a = np.array([False, True, False, True])
    b = np.array([False, False, True, True])
    ca = cks.encrypt(a, mask_seed=20, noise_seed=21)
    cb = cks.encrypt(b, mask_seed=22, noise_seed=23)
    got = sks_nuss.and_(ca, cb)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(sks_ntt.and_(ca, cb)))
    np.testing.assert_array_equal(cks.decrypt(got), a & b)
    # mux pipeline too (two stacked PBS through the nuss path)
    got_mux = sks_nuss.mux(ca, cb, ca)
    np.testing.assert_array_equal(
        np.asarray(got_mux), np.asarray(sks_ntt.mux(ca, cb, ca)))


def _rand_ggsw_ntt(rng, cfg, bits):
    """A random coefficient-domain GGSW [l, k+1, k+1, N] and its NTT form."""
    from concrete_tpu.core.ggsw import ggsw_to_ntt

    dt = np.uint32 if bits == 32 else np.uint64
    g = rng.integers(0, 1 << bits, size=(cfg.pbs_level, cfg.glwe_size,
                                          cfg.glwe_size, cfg.polynomial_size),
                     dtype=dt)
    return g, ggsw_to_ntt(g, cfg.primes, bits)


@pytest.mark.parametrize("ks1,N,L", [(2, 256, 4), (3, 128, 4), (2, 512, 8)])
def test_external_product_nuss_matches_ntt(ks1, N, L):
    """The Nussbaumer external product (transformed digits, per-frequency
    int8 dot, u64 limb recombine + inverse transform + fold) equals the
    exact-NTT external product across chunkings and glwe sizes."""
    rng = np.random.default_rng(19)
    cfg = bs.ServerConfig(lwe_dimension=4, glwe_dimension=ks1 - 1,
                          polynomial_size=N, pbs_base_log=7, pbs_level=2,
                          ks_base_log=4, ks_level=3)
    g, g_ntt = _rand_ggsw_ntt(rng, cfg, 32)
    glwe = jnp.asarray(rng.integers(0, 1 << 32, size=(8, ks1, N),
                                    dtype=np.uint32))
    rings = jnp.asarray(bsn.bsk_to_nuss(g[None], cfg, L)[0])
    got = np.asarray(jax.jit(lambda r, x: bsn.external_product_nuss(
        cfg, r, x, l=L))(rings, glwe))
    want = np.asarray(jax.jit(lambda g, x: bs.external_product(
        cfg, g, x))(g_ntt, glwe))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ks1,N,L,bl,lv", [
    (2, 256, 4, 7, 2),
    (3, 128, 4, 5, 3),
    (2, 512, 8, 7, 2),     # bl_eff = 10 -> n_sub = 2 sub-split
])
def test_rotdig_nuss_matches_numpy_reference(ks1, N, L, bl, lv):
    """The front half of a Nussbaumer CMux (chunked rotation, digits,
    forward transform, sub-digit split): undoing the split and the
    transform in numpy gives 2L x the gadget digits of the numpy-rotated
    delta, which recompose to its closest representable value — including
    degrees in the negated wrap half."""
    rng = np.random.default_rng(23)
    cfg = bs.ServerConfig(lwe_dimension=4, glwe_dimension=ks1 - 1,
                          polynomial_size=N, pbs_base_log=bl, pbs_level=lv,
                          ks_base_log=4, ks_level=3)
    plan = bsn.NussPlan.from_config(cfg, L)
    B, M = 16, N // L
    acc = rng.integers(0, 1 << 32, size=(ks1, B, N), dtype=np.uint32)
    a_hat = np.concatenate([rng.integers(0, 2 * N, size=B - 3),
                            [0, N, 2 * N - 1]])
    acc_cm = jnp.asarray(nb.chunk(acc, L)[..., :L, :])
    d8 = np.asarray(bsn._rotdig_nuss(plan, acc_cm, jnp.asarray(a_hat)))

    # numpy rotation delta in the standard layout
    rot = np.empty_like(acc)
    for b, a in enumerate(a_hat):
        p = np.roll(acc[:, b], int(a % N), axis=-1)
        p[:, : a % N] = np.uint32(0) - p[:, : a % N]
        rot[:, b] = np.uint32(0) - p if a >= N else p
    diff = rot - acc
    # undo the sub-digit split -> transformed digits [B, 2L, lev, ki, M]
    d = d8.astype(np.int64).reshape(B, 2 * L, lv, plan.n_sub, ks1, M)
    w = 1 << (7 * (plan.n_sub - 1 - np.arange(plan.n_sub)))
    dz = (d * w[None, None, None, :, None, None]).sum(axis=3)
    # undo the transform: inverse_raw(forward(chunk(x))) == 2L * chunk(x)
    dz = np.moveaxis(dz, 1, -2)                       # [B, lev, ki, 2L, M]
    back = np.asarray(nb.inverse_raw(dz, L))
    assert not np.any(back % (2 * L))
    digits = nb.unchunk(back[..., :L, :] // (2 * L), L)   # [B, lev, ki, N]
    assert not np.any(back[..., L:, :])
    assert np.abs(digits).max() <= 1 << (bl - 1)
    total = np.zeros((B, ks1, N), dtype=object)
    for lev in range(lv):
        total = total + digits[:, lev].astype(object) * (1 << (32 - bl * (lev + 1)))
    shift = 32 - bl * lv
    want = diff.astype(object)
    if shift:
        want = ((want + (1 << (shift - 1))) >> shift) << shift
    np.testing.assert_array_equal(total % (1 << 32),
                                  np.moveaxis(want % (1 << 32), 0, 1))


@pytest.mark.parametrize("ks1,N,L", [(2, 256, 4), (3, 128, 4), (2, 512, 8)])
def test_external_product_nuss_u64_matches_ntt(ks1, N, L):
    """The u64-torus Nussbaumer external product (128-bit key carriage,
    u64 word-pair recombine) equals the exact-NTT external product."""
    rng = np.random.default_rng(29)
    cfg = bs.ServerConfig(lwe_dimension=4, glwe_dimension=ks1 - 1,
                          polynomial_size=N, pbs_base_log=7, pbs_level=2,
                          ks_base_log=4, ks_level=3, bits=64)
    g, g_ntt = _rand_ggsw_ntt(rng, cfg, 64)
    glwe = jnp.asarray(rng.integers(0, 1 << 64, size=(8, ks1, N),
                                    dtype=np.uint64))
    rings = jnp.asarray(bsn.bsk_to_nuss(g[None], cfg, L)[0])
    got = np.asarray(jax.jit(lambda r, x: bsn.external_product_nuss(
        cfg, r, x, l=L))(rings, glwe))
    want = np.asarray(jax.jit(lambda g, x: bs.external_product(
        cfg, g, x))(g_ntt, glwe))
    np.testing.assert_array_equal(got, want)
