"""Crypto-core conformance: encrypt/decrypt roundtrips, keyswitch, external
product, CMux, modulus switch, sample extract, full PBS — with NPE as the
statistical oracle (reference test strategy, SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from concrete_tpu import npe
from concrete_tpu.dispersion import StandardDev, Variance
from concrete_tpu.core import bootstrap as bs
from concrete_tpu.core import lwe as lwe_mod
from concrete_tpu.core import glwe as glwe_mod
from concrete_tpu.core.ggsw import encrypt_constant_ggsw, ggsw_to_ntt
from concrete_tpu.csprng import EncryptionRandomGenerator, SecretRandomGenerator
from concrete_tpu.testing import assert_noise_bounded, assert_delta_std_dev
from concrete_tpu.torus import torus_modular_distance

from common import TINY, TINY_K2


def _keys(params, seed=1):
    sgen = SecretRandomGenerator(seed)
    lwe_sk = lwe_mod.LweSecretKey.generate_binary(params.lwe_dimension, sgen)
    glwe_sk = glwe_mod.GlweSecretKey.generate_binary(
        params.glwe_dimension, params.polynomial_size, sgen
    )
    return lwe_sk, glwe_sk


def test_lwe_roundtrip_and_noise_distribution():
    lwe_sk, _ = _keys(TINY)
    gen = EncryptionRandomGenerator(2, 3)
    std = StandardDev(2.0 ** -15)
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 1 << 32, size=1000, dtype=np.uint32)
    cts = lwe_sk.encrypt(pts, std.std_dev, gen)
    dec = lwe_sk.decrypt(cts)
    assert_delta_std_dev(dec, pts, std, 32)
    # measured noise sigma within half a bit of the configured sigma
    noise = torus_modular_distance(dec, pts, 32)
    assert abs(np.log2(noise.std()) - np.log2(std.std_dev)) < 0.5


def test_lwe_trivial_zero_noise():
    """std=0 noise => decryption is exact."""
    lwe_sk, _ = _keys(TINY)
    gen = EncryptionRandomGenerator(2, 3)
    pts = np.arange(16, dtype=np.uint32) << 28
    cts = lwe_sk.encrypt(pts, 0.0, gen)
    np.testing.assert_array_equal(lwe_sk.decrypt(cts), pts)


def test_lwe_arithmetic_ops():
    lwe_sk, _ = _keys(TINY)
    gen = EncryptionRandomGenerator(2, 3)
    pts = np.array([1 << 28, 3 << 28], dtype=np.uint32)
    cts = jnp.asarray(lwe_sk.encrypt(pts, 0.0, gen))
    got = lwe_sk.decrypt(np.array(lwe_mod.add(cts[0], cts[1])))
    assert got == np.uint32(4 << 28)
    got = lwe_sk.decrypt(np.array(lwe_mod.neg(cts[0])))
    assert got == np.uint32((-(1 << 28)) % (1 << 32))
    got = lwe_sk.decrypt(np.array(lwe_mod.scalar_mul(cts[0], 3)))
    assert got == np.uint32(3 << 28)
    got = lwe_sk.decrypt(np.array(lwe_mod.add_plaintext(cts[0], np.uint32(1 << 28))))
    assert got == np.uint32(2 << 28)
    # affine: 2*ct0 + 1*ct1 + bias
    got = lwe_sk.decrypt(
        np.array(lwe_mod.affine_transform(cts, np.array([2, 1]), np.uint32(1 << 28)))
    )
    assert got == np.uint32(6 << 28)


def test_keyswitch_noise_vs_npe():
    params = TINY
    sgen = SecretRandomGenerator(7)
    in_key = lwe_mod.LweSecretKey.generate_binary(64, sgen)
    out_key = lwe_mod.LweSecretKey.generate_binary(32, sgen)
    gen = EncryptionRandomGenerator(8, 9)
    ks_std = StandardDev(2.0 ** -20)
    ksk = lwe_mod.LweKeyswitchKey.generate(in_key, out_key, 4, 5, ks_std.std_dev, gen)

    pts = np.random.default_rng(1).integers(0, 1 << 32, size=500, dtype=np.uint32)
    ct_std = StandardDev(2.0 ** -18)
    cts = in_key.encrypt(pts, ct_std.std_dev, gen)
    switched = np.array(
        jax.jit(
            lambda c: lwe_mod.keyswitch(jnp.asarray(ksk.data), c, base_log=4, level_count=5)
        )(jnp.asarray(cts))
    )
    dec = out_key.decrypt(switched)
    predicted = npe.estimate_keyswitch_noise_with_constant_terms(
        64, ct_std, ks_std, 4, 5, 32
    )
    assert_noise_bounded(dec, pts, predicted, 32, slack_bits=0.75)


def test_glwe_roundtrip():
    _, glwe_sk = _keys(TINY_K2)
    gen = EncryptionRandomGenerator(4, 5)
    std = StandardDev(2.0 ** -20)
    rng = np.random.default_rng(2)
    msgs = rng.integers(0, 1 << 32, size=(10, TINY_K2.polynomial_size), dtype=np.uint32)
    cts = glwe_sk.encrypt(msgs, std.std_dev, gen)
    dec = glwe_sk.decrypt(cts)
    assert_delta_std_dev(dec, msgs, std, 32)


def test_glwe_zero_noise_exact():
    _, glwe_sk = _keys(TINY_K2)
    gen = EncryptionRandomGenerator(4, 5)
    msgs = np.random.default_rng(3).integers(
        0, 1 << 32, size=(3, TINY_K2.polynomial_size), dtype=np.uint32
    )
    cts = glwe_sk.encrypt(msgs, 0.0, gen)
    np.testing.assert_array_equal(glwe_sk.decrypt(cts), msgs)


@pytest.mark.parametrize("params", [TINY, TINY_K2], ids=["k1", "k2"])
def test_external_product_with_known_bit(params):
    """extprod(GGSW(b), GLWE(m)) decrypts to ~b*m (zero noise => near-exact)."""
    _, glwe_sk = _keys(params)
    cfg = bs.ServerConfig.from_boolean_parameters(params)
    gen = EncryptionRandomGenerator(11, 12)
    n = params.polynomial_size
    rng = np.random.default_rng(4)
    # message on a coarse lattice so decomposition rounding error is small
    msgs = (rng.integers(0, 256, size=(4, n), dtype=np.uint32)) << 24
    for bit in (0, 1):
        ggsw = encrypt_constant_ggsw(
            glwe_sk, bit, params.pbs_base_log, params.pbs_level, 0.0, gen
        )
        ggsw_ntt = ggsw_to_ntt(ggsw, cfg.primes, 32)
        glwe_ct = glwe_sk.encrypt(msgs, 0.0, gen)
        out = np.array(
            jax.jit(lambda g, c: bs.external_product(cfg, g, c))(
                ggsw_ntt, jnp.asarray(glwe_ct)
            )
        )
        dec = glwe_sk.decrypt(out)
        expected = (msgs * np.uint32(bit)).astype(np.uint32)
        # rounding error bound: decomposition truncation q/B^l * (small factor)
        err = np.abs(torus_modular_distance(dec, expected, 32))
        bound = 2.0 ** (-params.pbs_base_log * params.pbs_level) * (
            1.0 + params.lwe_dimension
        )
        assert err.max() < bound, (bit, err.max(), bound)


def test_cmux_selects():
    params = TINY
    _, glwe_sk = _keys(params)
    cfg = bs.ServerConfig.from_boolean_parameters(params)
    gen = EncryptionRandomGenerator(13, 14)
    n = params.polynomial_size
    rng = np.random.default_rng(5)
    m0 = (rng.integers(0, 16, size=(2, n), dtype=np.uint32)) << 28
    m1 = (rng.integers(0, 16, size=(2, n), dtype=np.uint32)) << 28
    ct0 = glwe_sk.encrypt(m0, 0.0, gen)
    ct1 = glwe_sk.encrypt(m1, 0.0, gen)
    for bit, want in ((0, m0), (1, m1)):
        ggsw = encrypt_constant_ggsw(
            glwe_sk, bit, params.pbs_base_log, params.pbs_level, 0.0, gen
        )
        ggsw_ntt = ggsw_to_ntt(ggsw, cfg.primes, 32)
        out = np.array(
            jax.jit(lambda g, a, b: bs.cmux(cfg, g, a, b))(
                ggsw_ntt, jnp.asarray(ct0), jnp.asarray(ct1)
            )
        )
        dec = glwe_sk.decrypt(out)
        err = np.abs(torus_modular_distance(dec, want, 32))
        assert err.max() < 2.0 ** -10


def test_pbs_modulus_switch_semantics():
    """Rounding to 2N: matches round(x * 2N / q) mod 2N."""
    n_poly = 128
    rng = np.random.default_rng(6)
    x = rng.integers(0, 1 << 32, size=2000, dtype=np.uint32)
    got = np.array(bs.pbs_modulus_switch(jnp.asarray(x), n_poly)) % (2 * n_poly)
    # one-guard-bit rounding == floor(x * 2N / q + 0.5); exact in f64 here
    expected = np.floor(
        x.astype(np.float64) * (2 * n_poly) / 2.0 ** 32 + 0.5
    ).astype(np.int64) % (2 * n_poly)
    np.testing.assert_array_equal(got, expected)


def test_sample_extract_constant_term():
    """sample_extract(GLWE(m)) is an LWE of m[0] under the flattened key."""
    _, glwe_sk = _keys(TINY_K2)
    gen = EncryptionRandomGenerator(15, 16)
    n = TINY_K2.polynomial_size
    msgs = np.random.default_rng(7).integers(0, 1 << 32, size=(5, n), dtype=np.uint32)
    cts = glwe_sk.encrypt(msgs, 0.0, gen)
    extracted = np.array(bs.sample_extract(jnp.asarray(cts)))
    big_key = glwe_sk.into_lwe_key()
    dec = big_key.decrypt(extracted)
    np.testing.assert_array_equal(dec, msgs[:, 0])


def test_full_pbs_noise_vs_npe():
    """PBS output noise (before keyswitch) within the NPE bound."""
    params = TINY
    lwe_sk, glwe_sk = _keys(params)
    cfg = bs.ServerConfig.from_boolean_parameters(params)
    gen = EncryptionRandomGenerator(17, 18)
    from concrete_tpu.core.ggsw import StandardBootstrapKey, bsk_to_ntt

    bsk_std = params.glwe_modular_std_dev
    bsk = StandardBootstrapKey.generate(
        lwe_sk, glwe_sk, params.pbs_base_log, params.pbs_level, bsk_std.std_dev, gen
    )
    bsk_ntt = bsk_to_ntt(bsk.data, cfg.primes, 32)

    # bootstrap a batch of encryptions of +-1/8 with the constant test poly
    eighth = np.uint32(1 << 29)
    msgs = np.array([eighth] * 50 + [np.uint32((7 << 29) % (1 << 32))] * 50)
    cts = lwe_sk.encrypt(msgs, params.lwe_modular_std_dev.std_dev, gen)
    lut = bs.trivial_lut_constant(cfg, eighth)
    out = np.array(
        jax.jit(lambda b, c: bs.bootstrap(cfg, b, lut, c))(bsk_ntt, jnp.asarray(cts))
    )
    big_key = glwe_sk.into_lwe_key()
    dec = big_key.decrypt(out)
    expected = np.where(msgs == eighth, eighth, np.uint32(-(1 << 29) % (1 << 32)))
    predicted = npe.estimate_pbs_noise(
        params.lwe_dimension,
        params.polynomial_size,
        params.glwe_dimension,
        params.pbs_base_log,
        params.pbs_level,
        bsk_std,
        32,
    )
    assert_noise_bounded(dec, expected, predicted, 32, slack_bits=0.75)
    # and every sample decodes to the right boolean
    assert (np.abs(torus_modular_distance(dec, expected, 32)) < 1 / 16).all()


def test_keyswitch_limbs_bit_identical_both_widths():
    """The limb-plane keyswitch (one int8 dot, the accelerator u64 path) matches the
    plain integer-dot keyswitch bit for bit."""
    from concrete_tpu.core import lwe as lwe_ops

    rng = np.random.default_rng(0)
    n_in, l, n_out = 64, 5, 32
    for dt, hi in [(np.uint32, 1 << 32), (np.uint64, 1 << 63)]:
        ksk = rng.integers(0, hi, size=(n_in, l, n_out + 1), dtype=dt)
        ct = jnp.asarray(rng.integers(0, hi, size=(7, n_in + 1), dtype=dt))
        want = np.asarray(lwe_ops.keyswitch(
            jnp.asarray(ksk), ct, base_log=4, level_count=l))
        ksk8 = jnp.asarray(lwe_ops.ksk_to_limbs(ksk))
        got = np.asarray(lwe_ops.keyswitch_limbs(
            ksk8, ct, base_log=4, level_count=l))
        np.testing.assert_array_equal(got, want)


def test_trivial_encryption_decrypts_under_any_key():
    """Trivial ciphertexts (zero mask) decrypt exactly under any key
    (lwe/glwe_ciphertext_trivial_encryption engine analogs)."""
    lwe_sk, glwe_sk = _keys(TINY)
    pts = np.array([1 << 28, 3 << 29], dtype=np.uint32)
    ct = lwe_mod.trivial_encrypt(jnp.asarray(pts), TINY.lwe_dimension)
    np.testing.assert_array_equal(lwe_sk.decrypt(np.asarray(ct)), pts)
    np.testing.assert_array_equal(np.asarray(lwe_mod.trivial_decrypt(ct)), pts)
    poly = np.arange(TINY.polynomial_size, dtype=np.uint32) << 20
    gct = glwe_mod.trivial_encrypt(jnp.asarray(poly), TINY.glwe_dimension)
    np.testing.assert_array_equal(glwe_sk.decrypt(np.asarray(gct)[None])[0], poly)


def test_glwe_ntt_roundtrip():
    """glwe_to_ntt / glwe_from_ntt invert each other (FourierGlweCiphertext
    conversion analogs, glwe/fourier.rs)."""
    rng = np.random.default_rng(0)
    primes = (2013265921, 1811939329)
    ct = rng.integers(0, 1 << 32, size=(3, 2, 64), dtype=np.uint32)
    spec = glwe_mod.glwe_to_ntt(ct, primes, 32)
    back = np.asarray(glwe_mod.glwe_from_ntt(spec, primes, 32))
    np.testing.assert_array_equal(back, ct)


def test_glwe_uniform_key_multisum_exact():
    """Full-range (uniform) GLWE keys: sample extraction stays exact (the
    multisum CRT bound must scale with the key magnitude)."""
    sgen = SecretRandomGenerator(9)
    sk = glwe_mod.GlweSecretKey.generate_uniform(2, 64, sgen)
    gen = EncryptionRandomGenerator(10, 11)
    rng = np.random.default_rng(12)
    pt = rng.integers(0, 1 << 32, size=(1, 64), dtype=np.uint32)
    ct = sk.encrypt(pt, 0.0, gen)
    out = np.asarray(bs.sample_extract_nth(jnp.asarray(ct), 5))
    dec = sk.into_lwe_key().decrypt(out[None])[0]
    assert dec == pt[0, 5], (hex(dec), hex(pt[0, 5]))


def test_packing_rejects_too_many_lwes():
    from concrete_tpu.core import packing

    rng = np.random.default_rng(0)
    pksk = jnp.asarray(rng.integers(0, 1 << 32, size=(8, 3, 2, 16), dtype=np.uint32))
    lwes = jnp.asarray(rng.integers(0, 1 << 32, size=(17, 9), dtype=np.uint32))
    with pytest.raises(ValueError):
        packing.packing_keyswitch(pksk, lwes, base_log=4, level_count=3)
