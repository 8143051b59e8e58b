"""Parameter co-design: derive operating points from the hardware.

The reference ships parameter sets chosen for a CPU f64-FFT backend
(concrete-boolean/src/parameters/mod.rs:82-110): `TFHE_LIB_PARAMETERS`
spends a 2^-165 error budget (error.md:23) where the reference's own
shipped `DEFAULT_PARAMETERS` grade is 2^-25 (error.md:22), and
`DEFAULT_PARAMETERS` picks pbs_base_log=8, which on the int8 toeplitz
path forces a 2-way digit sub-split (bootstrap_mxu.MxuPlan: digits wider
than 7 bits don't fit a signed byte) — doubling the contraction depth for
no noise benefit over base_log=7 at equal l*base_log coverage.

This module re-derives the operating point for the int8 toeplitz backend:

- **security** is pinned to the reference's own 128-bit calibration curve
  (concrete/src/lwe_params.rs:23-90 dimension -> log2 sigma pairs,
  mirrored in highlevel/params_presets.py), log-linearly interpolated in
  the total key dimension;
- **noise** comes from the NPE (`npe.py`; measured against real
  decryptions, docs/performance.md) with a chained
  worst-case gate model strictly harder than the reference's: the
  decision input is an AND/OR of two MUX outputs (a MUX carries two PBS
  noises, server_key/mod.rs:197-279), evaluated at the tightest margin
  (1/8 to the sign boundary);
- **cost** comes from a stage model of one CMux step computed from shapes
  at a device's published peaks (`CostModel`; data sheet, not measured):
  the int8 dot at the int8 rate, the table build, rotation+digits and
  limb recombine at their memory floors.

The result of `search()` (run: `python benchmarks/param_design.py`) is the
`TPU128_PARAMETERS` preset in params.py.

Example:
    >>> from concrete_tpu.design import gate_error_log2, min_log2_std
    >>> from concrete_tpu.params import DEFAULT_PARAMETERS
    >>> min_log2_std(1024)
    -25.0
    >>> gate_error_log2(DEFAULT_PARAMETERS) < -25  # exact backend beats the
    ...     # reference grade (no f64-FFT rounding noise on this path)
    True
"""

from __future__ import annotations

import dataclasses
import math

from . import npe
from .dispersion import StandardDev, Variance
from .params import BooleanParameters

# ---------------------------------------------------------------------------
# security: the reference's 128-bit calibration curve
# ---------------------------------------------------------------------------

# (total key dimension, log2 sigma) — concrete/src/lwe_params.rs:23-90; the
# RLWE entries (rlwe_params.rs) coincide on total dimension k*N (e.g.
# RLWE128_512_2 == LWE128_1024 == RLWE128_256_4 at -25).
_CURVE_128 = (
    (256, -5.0), (512, -11.0), (630, -14.0), (650, -15.0), (688, -16.0),
    (710, -17.0), (750, -18.0), (800, -19.0), (830, -20.0), (1024, -25.0),
    (2048, -52.0), (4096, -105.0),
)
_CURVE_80 = (
    (256, -9.0), (512, -19.0), (630, -24.0), (650, -25.0), (688, -26.0),
    (1024, -40.0), (2048, -82.0),
)


def min_log2_std(dimension: int, security: int = 128) -> float:
    """Smallest (most negative is *least* secure the other way: largest noise
    is safest) admissible log2 noise std-dev for a binary secret of the given
    total dimension, linearly interpolated on the reference's calibration
    table. Interpolation between published points is conservative in the
    direction that matters: the true security curve is convex, so the chord
    lies above it (more noise than strictly required)."""
    curve = {128: _CURVE_128, 80: _CURVE_80}[security]
    if dimension < curve[0][0]:
        raise ValueError(f"dimension {dimension} below calibrated range")
    if dimension >= curve[-1][0]:
        return curve[-1][1]
    for (d0, s0), (d1, s1) in zip(curve, curve[1:]):
        if d0 <= dimension <= d1:
            t = (dimension - d0) / (d1 - d0)
            return s0 + t * (s1 - s0)
    raise AssertionError


# ---------------------------------------------------------------------------
# noise: chained worst-case gate error
# ---------------------------------------------------------------------------


def _fresh_gate_variance(p: BooleanParameters, *, pbs_count: int = 1,
                         level: int | None = None, bits: int = 32) -> Variance:
    """Noise of a gate output: `pbs_count` PBS outputs summed, keyswitched
    back to the small key (server_key/mod.rs:133-166; MUX sums two PBS,
    :197-279)."""
    lvl = p.pbs_level if level is None else level
    v_pbs = npe.estimate_pbs_noise(
        p.lwe_dimension, p.polynomial_size, p.glwe_dimension,
        p.pbs_base_log, lvl, p.glwe_modular_std_dev, bits)
    v_sum = Variance(pbs_count * v_pbs.get_variance())
    kn = p.glwe_dimension * p.polynomial_size
    return npe.estimate_keyswitch_noise_with_constant_terms(
        kn, v_sum, p.lwe_modular_std_dev, p.ks_base_log, p.ks_level, bits)


def gate_error_log2(p: BooleanParameters, *, level: int | None = None,
                    worst_chain: bool = True, bits: int = 32) -> float:
    """log2 of the per-gate error probability for chained boolean circuits.

    The error event is the modulus-switch phase leaving its 1/8-wide
    half-plateau inside the *next* gate's bootstrap. Worst case over the 8
    gates: the AND/OR family (margin 1/8, inputs summed once — XOR doubles
    the inputs but also doubles its margin to 1/4, so its margin/sigma ratio
    is never worse). With ``worst_chain`` the two inputs are MUX outputs
    (two PBS noises each) — strictly harder than the reference's
    fresh-gate accounting, so a grade under this model is a grade under
    theirs.
    """
    v_in = _fresh_gate_variance(
        p, pbs_count=2 if worst_chain else 1, level=level, bits=bits)
    v_lin = Variance(2.0 * v_in.get_variance())
    nb_msb = int(math.log2(2 * p.polynomial_size))
    v_ms = npe.estimate_modulus_switching_noise_with_binary_key(
        p.lwe_dimension, nb_msb, v_lin, bits)
    sigma = math.sqrt(v_ms.get_variance())
    margin = 1.0 / 8.0
    # two-sided tail; log-domain erfc for the far-tail (erfc underflows f64
    # below ~2^-3680, and TFHE_LIB-class points sit past 2^-150)
    x = margin / (sigma * math.sqrt(2.0))
    if x < 20.0:
        return math.log2(max(math.erfc(x), 1e-300))
    # asymptotic erfc(x) ~ exp(-x^2)/(x sqrt(pi))
    return (-x * x - math.log(x * math.sqrt(math.pi))) / math.log(2.0)


def _erfc_tail_x(target_log2: float) -> float:
    """x with erfc(x) = 2^target_log2 (upper-tail inverse, bisection).

    erfc is monotone decreasing and the Chernoff guess
    x0 = sqrt(-target*ln2) always satisfies erfc(x0) <= 2^target (the bound
    erfc(x) <= exp(-x^2)), so the root lies in [0, x0]; bisect to ~1e-12.
    Returns the hi end, i.e. erfc(result) <= 2^target (conservative).

    >>> import math
    >>> round(_erfc_tail_x(-13.0), 4)   # exact inverse, not the guess 3.0018
    2.7167
    >>> math.erfc(_erfc_tail_x(-25.0)) <= 2.0 ** -25.0
    True
    """
    target = 2.0 ** target_log2
    lo, hi = 0.0, math.sqrt(-target_log2 * math.log(2.0)) + 1e-9
    for _ in range(60):
        mid = (lo + hi) / 2.0
        if math.erfc(mid) > target:
            lo = mid
        else:
            hi = mid
    return hi


def max_bootstrap_precision(polynomial_size: int, lwe_dimension: int,
                            target_err_log2: float = -13.0,
                            nb_bit_padding: int = 1) -> int:
    """Largest encoder precision a PBS at this (N, n) can evaluate with
    per-slot decode error <= 2^target from modulus-switch rounding alone.

    Rounding the n mask elements + body to the 2N LUT grid adds noise of
    sigma = sqrt(n/24 + 1/12) grid steps (lwe.log2_rounding_noise,
    concrete/src/lwe/mod.rs:1855 analog) — independent of N, so the LUT
    interval half-width N/2^(p+pad) steps must cover it:
    p <= log2(N / m) - pad with m = x*sqrt(2)*sigma, erfc(x) = 2^target.

    This is the honest limit the runtime warnings enforce statistically;
    measured at n=630 (tests/test_design.py): N=256 misdecodes 4-bit
    messages (~12%/slot predicted), N=512 carries 4 bits cleanly.

    >>> max_bootstrap_precision(512, 630, target_err_log2=-13.0)
    3
    >>> max_bootstrap_precision(4096, 630, target_err_log2=-13.0)
    6
    """
    sigma = math.sqrt(lwe_dimension / 24.0 + 1.0 / 12.0)
    m = _erfc_tail_x(target_err_log2) * math.sqrt(2.0) * sigma
    return max(0, int(math.floor(math.log2(polynomial_size / m)))
               - nb_bit_padding)


def recommend_rlwe(nb_bit_precision: int, lwe_dimension: int = 630,
                   target_err_log2: float = -13.0,
                   nb_bit_padding: int = 1):
    """Fastest 128-bit RLWE preset whose PBS carries `nb_bit_precision`
    bits at the target per-slot error.

    At fixed total GLWE dimension k*N the external-product MACs scale as
    l*(k+1)^2*N^2, so the smallest feasible N with the largest k wins —
    (N=1024, k=1) -> (N=256, k=4) cuts them 2.5x, at lower output noise
    (docs/performance.md "u64 torus"). Feasibility is
    `max_bootstrap_precision`: LUT resolution, not output noise, is what
    small N trades away.

    >>> recommend_rlwe(2).polynomial_size   # low precision: fastest shape
    256
    >>> recommend_rlwe(4).polynomial_size   # mid: N=1024-class resolution
    1024
    >>> recommend_rlwe(6).polynomial_size   # high: resolution dominates
    4096
    """
    from .highlevel import params_presets as pp

    for preset in (pp.RLWE128_256_4, pp.RLWE128_512_2, pp.RLWE128_1024_1,
                   pp.RLWE128_2048_1, pp.RLWE128_4096_1):
        if max_bootstrap_precision(
                preset.polynomial_size, lwe_dimension, target_err_log2,
                nb_bit_padding) >= nb_bit_precision:
            return preset
    raise ValueError(
        f"no 128-bit RLWE preset carries {nb_bit_precision} bits at "
        f"2^{target_err_log2} for lwe_dimension={lwe_dimension}; reduce the "
        f"precision, the input LWE dimension (smaller n shrinks the "
        f"modulus-switch noise), or the target confidence")


# ---------------------------------------------------------------------------
# cost: stage model from shapes at published peaks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-iteration stage costs of the toeplitz CMux step, from shapes at
    the published peaks of `device_kind` (profiling.PEAKS — data sheet, not
    measured): the s8 x s8 dot at the int8 rate; the table build (written
    once, read once by the dot), rotation+digits (accumulator in, digit
    matrix out) and limb recombine (dot output in, accumulator in and out)
    at the memory rate. A lower bound that ranks shapes; measured times sit
    above it."""

    device_kind: str = "NVIDIA H100 80GB HBM3"

    def gate_us(self, p: BooleanParameters, batch: int = 2048) -> float:
        """Modeled microseconds per batched gate call (batch gates)."""
        from .profiling import peaks

        pk = peaks(self.device_kind)
        k1 = p.glwe_dimension + 1
        n_sub = 1 if p.pbs_base_log <= 7 else (p.pbs_base_log - 8) // 7 + 2
        big_k = p.pbs_level * k1 * n_sub * p.polynomial_size
        cols = k1 * 4 * p.polynomial_size
        acc_bytes = batch * k1 * p.polynomial_size * 4
        dot = 2.0 * batch * big_k * cols / pk["int8_ops_per_s"]
        moved = (2 * big_k * cols                      # table build
                 + acc_bytes + batch * big_k           # rotation + digits
                 + batch * cols * 4 + 2 * acc_bytes)   # recombine
        iter_s = dot + moved / pk["hbm_bytes_per_s"]
        return p.lwe_dimension * iter_s * 1e6

    def gates_per_s(self, p: BooleanParameters, batch: int = 2048) -> float:
        return batch / self.gate_us(p, batch) * 1e6


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Candidate:
    params: BooleanParameters
    gates_per_s: float
    err_log2: float
    err_log2_fresh: float


def _ks_search(kn: int, sig_lwe: float, var_budget: float,
               bits: int = 32):
    """Cheapest keyswitch decomposition whose added noise fits the budget:
    minimize l_ks (KSK size and keyswitch work), then the variance itself."""
    for ks_l in range(1, 21):
        best = None
        for ks_bl in range(1, 9):
            if ks_bl * ks_l > bits:
                continue
            v = npe.estimate_keyswitch_noise_with_constant_terms(
                kn, Variance(0.0), StandardDev(sig_lwe), ks_bl, ks_l, bits
            ).get_variance()
            if v <= var_budget and (best is None or v < best[1]):
                best = (ks_bl, v)
        if best is not None:
            return best[0], ks_l
    return None


def search(target_err_log2: float = -25.0, security: int = 128,
           batch: int = 2048, cost: CostModel | None = None,
           n_range=range(560, 721, 10),
           shapes=((1, 1024), (2, 512), (4, 256), (2, 1024), (1, 2048)),
           levels=range(1, 5), base_logs=range(3, 9)) -> list[Candidate]:
    """Sweep (n, k, N, bl, l, ks) and rank feasible points by modeled
    throughput. Feasible = chained worst-case gate error (AND of two MUX
    outputs) <= ``target_err_log2`` at the given security level."""
    cost = cost or CostModel()
    # the total pre-decision noise budget at the target error: sigma such
    # that erfc(margin/(sigma sqrt 2)) = 2^target; grant the keyswitch ~15%
    # of the variance (it enters doubled — two gate inputs)
    x = _erfc_tail_x(target_err_log2)
    sigma_total = (1.0 / 8.0) / (x * math.sqrt(2.0))
    ks_var_budget = sigma_total ** 2 * 0.15 / 2.0
    out = []
    for k, poly in shapes:
        kn = k * poly
        sig_glwe = 2.0 ** min_log2_std(kn, security)
        for n in n_range:
            sig_lwe = 2.0 ** min_log2_std(n, security)
            ks = _ks_search(kn, sig_lwe, ks_var_budget)
            if ks is None:
                continue
            for l in levels:
                for bl in base_logs:
                    if bl * l > 32:
                        continue
                    p = BooleanParameters(
                        lwe_dimension=n, glwe_dimension=k,
                        polynomial_size=poly,
                        lwe_modular_std_dev=StandardDev(sig_lwe),
                        glwe_modular_std_dev=StandardDev(sig_glwe),
                        pbs_base_log=bl, pbs_level=l,
                        ks_base_log=ks[0], ks_level=ks[1])
                    err = gate_error_log2(p)
                    if err > target_err_log2:
                        continue
                    out.append(Candidate(
                        p, cost.gates_per_s(p, batch), err,
                        gate_error_log2(p, worst_chain=False)))
    out.sort(key=lambda c: -c.gates_per_s)
    return out
