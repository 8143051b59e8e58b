"""Engine-style generic checks: wrong shapes fail loudly at trace time with
typed errors (specification/engines/mod.rs engine_error! analog)."""

import numpy as np
import jax.numpy as jnp
import pytest

from concrete_tpu.core import bootstrap as bs
from concrete_tpu.core import bootstrap_mxu as bsx
from concrete_tpu.core import checks
from concrete_tpu.core import lwe as lwe_mod

from common import TINY


def _cfg():
    return bs.ServerConfig.from_boolean_parameters(TINY)


def test_keyswitch_key_shape_mismatch():
    rng = np.random.default_rng(0)
    ksk = jnp.asarray(rng.integers(0, 1 << 32, size=(8, 3, 5), dtype=np.uint32))
    ct = jnp.asarray(rng.integers(0, 1 << 32, size=(2, 9), dtype=np.uint32))
    with pytest.raises(checks.KeyParameterMismatch):
        lwe_mod.keyswitch(ksk, ct, base_log=4, level_count=4)  # level wrong


def test_blind_rotate_rejects_wrong_lwe_dimension():
    cfg = _cfg()
    rng = np.random.default_rng(0)
    bsk = jnp.asarray(rng.integers(
        0, 1 << 31, size=(cfg.lwe_dimension, len(cfg.primes), cfg.pbs_level,
                          cfg.glwe_size, cfg.glwe_size, cfg.polynomial_size),
        dtype=np.uint32))
    lut = bs.trivial_lut_constant(cfg, np.uint32(1 << 29))
    bad = jnp.asarray(rng.integers(
        0, 1 << 32, size=(2, cfg.lwe_dimension + 5), dtype=np.uint32))
    with pytest.raises(checks.LweDimensionMismatch):
        bs.blind_rotate(cfg, bsk, lut, bad)


def test_blind_rotate_mxu_rejects_wrong_rings():
    cfg = _cfg()
    rng = np.random.default_rng(0)
    rings = jnp.asarray(rng.integers(
        0, 1 << 32, size=(cfg.lwe_dimension, 3, cfg.glwe_size,
                          2 * cfg.polynomial_size), dtype=np.uint32))
    lut = bs.trivial_lut_constant(cfg, np.uint32(1 << 29))
    lwe = jnp.asarray(rng.integers(
        0, 1 << 32, size=(2, cfg.lwe_dimension + 1), dtype=np.uint32))
    with pytest.raises(checks.KeyParameterMismatch):
        bsx.blind_rotate_mxu(cfg, rings, lut, lwe)


def test_blind_rotate_rejects_wrong_accumulator():
    cfg = _cfg()
    rng = np.random.default_rng(0)
    bsk = jnp.asarray(rng.integers(
        0, 1 << 31, size=(cfg.lwe_dimension, len(cfg.primes), cfg.pbs_level,
                          cfg.glwe_size, cfg.glwe_size, cfg.polynomial_size),
        dtype=np.uint32))
    lut = jnp.zeros((cfg.glwe_size, cfg.polynomial_size // 2), dtype=jnp.uint32)
    lwe = jnp.asarray(rng.integers(
        0, 1 << 32, size=(2, cfg.lwe_dimension + 1), dtype=np.uint32))
    with pytest.raises(checks.PolynomialSizeMismatch):
        bs.blind_rotate(cfg, bsk, lut, lwe)
