"""Cryptographic parameter types and presets.

Mirrors the reference's parameter newtypes (concrete-commons/src/parameters.rs)
and the boolean parameter presets (concrete-boolean/src/parameters/mod.rs:82-110).
Instead of ~25 usize newtypes we use validated frozen dataclasses; dimensions are
plain ints validated at construction.

Example:
    >>> from concrete_tpu.params import DEFAULT_PARAMETERS, TFHE_LIB_PARAMETERS, log2_exact
    >>> (DEFAULT_PARAMETERS.lwe_dimension, DEFAULT_PARAMETERS.polynomial_size)
    (586, 512)
    >>> TFHE_LIB_PARAMETERS.glwe_dimension
    1
    >>> log2_exact(1024)
    10
"""

from __future__ import annotations

import dataclasses
import math

from .dispersion import StandardDev


def _check_pos(name: str, value: int) -> None:
    if not isinstance(value, int) or value <= 0:
        raise ValueError(f"{name} must be a positive int, got {value!r}")


def _check_pow2(name: str, value: int) -> None:
    _check_pos(name, value)
    if value & (value - 1):
        raise ValueError(f"{name} must be a power of two, got {value}")


@dataclasses.dataclass(frozen=True)
class LweParams:
    """Parameters of an LWE ciphertext: dimension n and noise std-dev.

    Reference: concrete-commons/src/parameters.rs:76 (LweDimension).
    """

    dimension: int
    std_dev: float

    def __post_init__(self):
        _check_pos("dimension", self.dimension)

    @property
    def size(self) -> int:  # LweSize = n + 1 (parameters.rs:64)
        return self.dimension + 1


@dataclasses.dataclass(frozen=True)
class GlweParams:
    """Parameters of a GLWE ciphertext: dimension k, polynomial size N, noise.

    Reference: concrete-commons/src/parameters.rs:89-115.
    """

    dimension: int
    polynomial_size: int
    std_dev: float

    def __post_init__(self):
        _check_pos("dimension", self.dimension)
        _check_pow2("polynomial_size", self.polynomial_size)

    @property
    def size(self) -> int:  # GlweSize = k + 1
        return self.dimension + 1

    @property
    def log2_polynomial_size(self) -> int:
        return self.polynomial_size.bit_length() - 1

    @property
    def flat_lwe_dimension(self) -> int:
        """Dimension of the flattened ("big") LWE key, k*N.

        Reference: GlweSecretKey::into_lwe_secret_key (secret/glwe.rs:332).
        """
        return self.dimension * self.polynomial_size


@dataclasses.dataclass(frozen=True)
class DecompParams:
    """Gadget decomposition parameters (base B = 2^base_log, level count l).

    Reference: concrete-commons/src/parameters.rs:163-171.
    """

    base_log: int
    level_count: int

    def __post_init__(self):
        _check_pos("base_log", self.base_log)
        _check_pos("level_count", self.level_count)

    @property
    def base(self) -> int:
        return 1 << self.base_log


@dataclasses.dataclass(frozen=True)
class BooleanParameters:
    """Parameter set for homomorphic boolean circuit evaluation.

    Mirrors concrete-boolean/src/parameters/mod.rs:29-40 field for field.
    """

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_modular_std_dev: StandardDev
    glwe_modular_std_dev: StandardDev
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int

    @property
    def lwe(self) -> LweParams:
        return LweParams(self.lwe_dimension, self.lwe_modular_std_dev.std_dev)

    @property
    def glwe(self) -> GlweParams:
        return GlweParams(
            self.glwe_dimension, self.polynomial_size, self.glwe_modular_std_dev.std_dev
        )

    @property
    def pbs_decomp(self) -> DecompParams:
        return DecompParams(self.pbs_base_log, self.pbs_level)

    @property
    def ks_decomp(self) -> DecompParams:
        return DecompParams(self.ks_base_log, self.ks_level)


# Default parameter set: 128-bit security, error probability <= 2^-25.
# Reference: concrete-boolean/src/parameters/mod.rs:82-93.
DEFAULT_PARAMETERS = BooleanParameters(
    lwe_dimension=586,
    glwe_dimension=2,
    polynomial_size=512,
    lwe_modular_std_dev=StandardDev(0.00008976167396834998),  # 2^-13.44...
    glwe_modular_std_dev=StandardDev(0.00000002989040792967434),  # 2^-24.9...
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=2,
    ks_level=5,
)

# TFHE-lib parameter set: 128-bit security, error probability <= 2^-165.
# Reference: concrete-boolean/src/parameters/mod.rs:100-110.
TFHE_LIB_PARAMETERS = BooleanParameters(
    lwe_dimension=630,
    glwe_dimension=1,
    polynomial_size=1024,
    lwe_modular_std_dev=StandardDev(0.000030517578125),  # 2^-15
    glwe_modular_std_dev=StandardDev(0.000000029802322387695313),  # 2^-25
    pbs_base_log=7,
    pbs_level=3,
    ks_base_log=2,
    ks_level=8,
)


# Co-designed parameter set (the name is historical): 128-bit security,
# chained worst-case gate error probability <= 2^-32 (stricter accounting
# than the reference's 2^-25 DEFAULT grade — see design.gate_error_log2).
# Derived by the co-design sweep in `concrete_tpu.design` (run:
# python benchmarks/param_design.py) rather than inherited from the
# reference's CPU-FFT-era operating points:
#
# - (k=4, N=256) keeps the 128-bit total GLWE dimension k*N=1024 but
#   reshapes the int8 contraction: per blind-rotate step the dot is
#   [B, l*(k+1)*N] x [l*(k+1)*N, (k+1)*4*N] — MACs scale as l*(k+1)^2*N^2,
#   so at fixed k*N, larger k is strictly cheaper ((4+1)^2*256^2 = 0.41x of
#   TFHE_LIB's (1+1)^2*1024^2).
# - pbs_base_log=7 is the widest gadget digit that fits a signed byte
#   (bootstrap_mxu.MxuPlan): DEFAULT's base_log=8 forces a 2-way digit
#   sub-split that doubles contraction depth for no noise benefit at equal
#   l*base_log.
# - Both noise points are the reference's own published 128-bit calibration
#   entries, no interpolation: sigma_lwe = 2^-14 (LWE128_630,
#   lwe_params.rs:55) and sigma_glwe = 2^-25 (RLWE128_256_4,
#   rlwe_params.rs:70 — same total dimension 1024 as RLWE128_1024_1).
# - n=630 is the smallest LWE dimension whose calibrated sigma still admits
#   a keyswitch within ~15% of the gate noise budget (design._ks_search);
#   below it the security curve forces sigma_lwe too high.
#
# Throughput on the GPU: PERF.md. Noise model checked against real
# decryptions: docs/performance.md "TPU128".
TPU128_PARAMETERS = BooleanParameters(
    lwe_dimension=630,
    glwe_dimension=4,
    polynomial_size=256,
    lwe_modular_std_dev=StandardDev(0.00006103515625),  # 2^-14 (LWE128_630)
    glwe_modular_std_dev=StandardDev(0.000000029802322387695313),  # 2^-25
    pbs_base_log=7,
    pbs_level=2,
    ks_base_log=2,
    ks_level=6,
)


# Gaussian key std-dev presets used when generating gaussian-distributed secret
# keys (reference: torus/mod.rs:98-104 `GAUSSIAN_KEY_LOG_STD`).
GAUSSIAN_KEY_LOG_STD = {
    32: -30.32192809488736,
    64: -62.32192809488736,
}

# Polynomial sizes for which the reference ships FFT plans
# (concrete-core/src/backends/core/private/math/fft/mod.rs:28). Our NTT
# supports any power of two up to the prime's 2-adicity, but we keep the same
# validated set for API parity.
ALLOWED_POLY_SIZES = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def log2_exact(n: int) -> int:
    """Return log2(n) for a power of two, raising otherwise."""
    l = int(math.log2(n))
    if 1 << l != n:
        raise ValueError(f"{n} is not a power of two")
    return l
