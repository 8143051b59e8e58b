"""Tests for the parameter co-design module (design.py).

The error model is the load-bearing piece: TPU128_PARAMETERS' security
grade rests on it, so it is pinned here against the reference's published
numbers and against hand-computable anchors."""

import math

import pytest

from concrete_tpu import design
from concrete_tpu.dispersion import StandardDev
from concrete_tpu.params import (
    BooleanParameters,
    DEFAULT_PARAMETERS,
    TFHE_LIB_PARAMETERS,
    TPU128_PARAMETERS,
)


def test_security_curve_hits_published_points():
    # the interpolation must reproduce the reference's own calibration table
    # exactly at the published dimensions (lwe_params.rs:23-90)
    assert design.min_log2_std(630) == -14.0
    assert design.min_log2_std(1024) == -25.0
    assert design.min_log2_std(2048) == -52.0
    assert design.min_log2_std(630, security=80) == -24.0
    # interpolation is monotone decreasing in dimension
    assert design.min_log2_std(700) < design.min_log2_std(650)
    with pytest.raises(ValueError):
        design.min_log2_std(100)


def test_security_curve_saturates_above_table():
    assert design.min_log2_std(8192) == -105.0


def test_gate_error_tracks_published_grades():
    # Our exact-integer path has no f64-FFT rounding noise, so the model must
    # be at or below (better than) the reference's published grades
    # (error.md:22-23), but within a few bits of sigma: the predicted
    # pre-decision sigma for DEFAULT under fresh-input accounting is 2^-5.98
    # vs the 2^-5.55 the published 2^-25 corresponds to.
    assert design.gate_error_log2(DEFAULT_PARAMETERS, worst_chain=False) < -25
    assert design.gate_error_log2(TFHE_LIB_PARAMETERS, worst_chain=False) < -165
    # ... and not absurdly far off either (model sanity)
    assert design.gate_error_log2(DEFAULT_PARAMETERS, worst_chain=False) > -80
    # worst-chain accounting (MUX inputs) is strictly harder
    assert (design.gate_error_log2(DEFAULT_PARAMETERS)
            > design.gate_error_log2(DEFAULT_PARAMETERS, worst_chain=False))


def test_gate_error_far_tail_log_domain():
    # TFHE_LIB sits far past where erfc underflows f64; the asymptotic
    # branch must kick in and stay finite/continuous
    e = design.gate_error_log2(TFHE_LIB_PARAMETERS)
    assert -1000 < e < -150


def test_tpu128_meets_its_grade():
    # the shipped preset's documented guarantees, recomputed from scratch
    assert design.gate_error_log2(TPU128_PARAMETERS) <= -32
    assert design.gate_error_log2(TPU128_PARAMETERS, worst_chain=False) <= -43
    # security: both noise points at/above the curve for their dimensions
    p = TPU128_PARAMETERS
    assert math.log2(p.lwe_modular_std_dev.std_dev) >= design.min_log2_std(
        p.lwe_dimension)
    assert math.log2(p.glwe_modular_std_dev.std_dev) >= design.min_log2_std(
        p.glwe_dimension * p.polynomial_size)


def test_tpu128_is_mxu_clean():
    # base_log=7 digits fit a signed byte: no digit sub-split on the MXU path
    from concrete_tpu.core.bootstrap import ServerConfig
    from concrete_tpu.core.bootstrap_mxu import MxuPlan

    plan = MxuPlan.from_config(
        ServerConfig.from_boolean_parameters(TPU128_PARAMETERS))
    assert plan.n_sub == 1
    assert plan.row_blocks == 10  # l * (k+1)


def test_cost_model_anchor():
    # the model is the TFHE_LIB step's shapes at the H100 data-sheet peaks:
    # dot [2048, 6144] x [6144, 8192] at 1,979 int8 TOP/s, plus the table
    # (written + read), digits, accumulator and dot output at 3.35 TB/s
    b, k, cols, acc = 2048, 6144, 8192, 2048 * 2 * 1024 * 4
    dot_s = 2.0 * b * k * cols / 1.979e15
    mem_s = (2 * k * cols + acc + b * k + b * cols * 4 + 2 * acc) / 3.35e12
    want = b / (630 * (dot_s + mem_s))
    rate = design.CostModel().gates_per_s(TFHE_LIB_PARAMETERS, batch=2048)
    assert abs(rate - want) < 1e-6 * want
    with pytest.raises(ValueError):
        design.CostModel(device_kind="Unknown Accelerator").gate_us(
            TFHE_LIB_PARAMETERS)


def test_search_returns_shipped_point_class():
    cands = design.search(n_range=range(630, 651, 10),
                          shapes=((4, 256), (2, 512)),
                          levels=range(2, 4), base_logs=range(6, 8))
    assert cands, "sweep found no feasible points"
    top = cands[0].params
    # the co-designed operating point: (k=4, N=256, bl=7, l=2) dominates
    assert (top.glwe_dimension, top.polynomial_size) == (4, 256)
    assert (top.pbs_base_log, top.pbs_level) == (7, 2)
    assert all(c.err_log2 <= -25.0 for c in cands)
    # ranking is by modeled throughput, descending
    rates = [c.gates_per_s for c in cands]
    assert rates == sorted(rates, reverse=True)


def test_ks_search_minimizes_levels():
    got = design._ks_search(1024, 2.0 ** -14, 2.0 ** -14.5)
    assert got is not None
    bl, l = got
    # any feasible solution with fewer levels must not exist
    from concrete_tpu import npe
    from concrete_tpu.dispersion import Variance

    for fewer in range(1, l):
        for b in range(1, 9):
            v = npe.estimate_keyswitch_noise_with_constant_terms(
                1024, Variance(0.0), StandardDev(2.0 ** -14), b, fewer, 32
            ).get_variance()
            assert v > 2.0 ** -14.5


def test_infeasible_target_returns_empty():
    # an absurd error target at tiny dimensions has no feasible point
    cands = design.search(target_err_log2=-500.0,
                          n_range=range(560, 581, 10),
                          shapes=((1, 1024),), levels=range(1, 2),
                          base_logs=range(3, 4))
    assert cands == []


def test_max_bootstrap_precision_model():
    """LUT-resolution limit: modulus-switch noise is N-independent, so each
    doubling of N buys exactly one message bit; values pinned at n=630."""
    got = {N: design.max_bootstrap_precision(N, 630)
           for N in (256, 512, 1024, 2048, 4096)}
    assert got == {256: 2, 512: 3, 1024: 4, 2048: 5, 4096: 6}
    # smaller input LWE dimension shrinks the rounding noise -> more bits
    assert (design.max_bootstrap_precision(256, 256)
            > design.max_bootstrap_precision(256, 630))


def test_recommend_rlwe_prefers_small_n_when_feasible():
    assert design.recommend_rlwe(2).polynomial_size == 256
    assert design.recommend_rlwe(4).polynomial_size == 1024
    assert design.recommend_rlwe(6).polynomial_size == 4096
    with pytest.raises(ValueError):
        design.recommend_rlwe(12)


def test_slow_modswitch_precision_empirical():
    """The precision model is real: 4-bit messages through a genuine PBS at
    N=256/n=630 misdecode (predicted ~12%/slot), while the recommended
    shape for 3 bits (N=512) round-trips the full 3-bit range cleanly.
    Fixed seeds make the misdecode deterministic."""
    import warnings

    import numpy as np

    from concrete_tpu.highlevel import (Encoder, LWEBSK, LWESecretKey,
                                        RLWESecretKey)
    from concrete_tpu.highlevel import lwe as hlwe
    from concrete_tpu.highlevel.params_presets import (LWE128_630,
                                                       RLWE128_256_4,
                                                       RLWE128_512_2)

    sk = LWESecretKey.new(LWE128_630, secret_seed=1)

    # N=256: beyond its 2-bit limit -> wrong decode (warning-free at 4 bits,
    # which is exactly why the static model matters)
    rsk = RLWESecretKey.new(RLWE128_256_4, secret_seed=2)
    bsk = LWEBSK.new(sk, rsk, 7, 3, mask_seed=3, noise_seed=4)
    enc4 = Encoder.new(0.0, 15.0, 4, 1)
    vals4 = np.array([15.0, 1.0, 8.0])
    ct = hlwe.LWE.encode_encrypt(sk, vals4, enc4, mask_seed=5, noise_seed=6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dec = ct.bootstrap(bsk).decrypt_decode_round(
            rsk.to_lwe_secret_key())
    assert not np.array_equal(dec, vals4), dec

    # N=512 at its recommended 3-bit precision: clean round-trip
    assert design.recommend_rlwe(3) is RLWE128_512_2
    rsk2 = RLWESecretKey.new(RLWE128_512_2, secret_seed=7)
    bsk2 = LWEBSK.new(sk, rsk2, 7, 3, mask_seed=8, noise_seed=9)
    enc3 = Encoder.new(0.0, 7.0, 3, 1)
    vals3 = np.arange(8.0)
    ct3 = hlwe.LWE.encode_encrypt(sk, vals3, enc3, mask_seed=10,
                                  noise_seed=11)
    dec3 = ct3.bootstrap(bsk2).decrypt_decode_round(
        rsk2.to_lwe_secret_key())
    np.testing.assert_array_equal(dec3, vals3)
