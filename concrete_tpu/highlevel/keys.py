"""High-level key types: secret keys, bootstrapping and keyswitching keys.

Mirrors concrete/src/{lwe_secretkey,rlwe_secretkey,lwe_bsk,lwe_ksk}.rs, on
the u64 torus. LWEBSK carries both the coefficient-domain GGSW tensor (for
serialization parity) and the device-resident NTT spectra used by PBS.

Example:
    >>> from concrete_tpu.highlevel import LWESecretKey, LWEParams
    >>> sk = LWESecretKey.new(LWEParams(dimension=16, log2_std_dev=-30), secret_seed=1)
    >>> sk.dimension
    16
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import bootstrap as bs
from ..core.ggsw import StandardBootstrapKey, bsk_to_ntt
from ..core.glwe import GlweSecretKey
from ..core.lwe import LweKeyswitchKey, LweSecretKey
from ..csprng import EncryptionRandomGenerator, SecretRandomGenerator
from ..params import log2_exact
from .encoder import BITS
from .params_presets import LWEParams, RLWEParams


@dataclasses.dataclass
class LWESecretKey:
    """u64 binary LWE secret key + its noise parameter (lwe_secretkey.rs)."""

    inner: LweSecretKey
    std_dev: float

    @classmethod
    def new(cls, params: LWEParams, *, secret_seed: int | None = None):
        gen = SecretRandomGenerator(secret_seed)
        return cls(
            LweSecretKey.generate_binary(params.dimension, gen, bits=BITS),
            params.std_dev,
        )

    @property
    def dimension(self) -> int:
        return self.inner.dimension

    @property
    def variance(self) -> float:
        return self.std_dev ** 2

    def save(self, path: str):
        np.savez(path, key=self.inner.key, std_dev=self.std_dev, kind=self.inner.kind)

    @classmethod
    def load(cls, path: str) -> "LWESecretKey":
        d = np.load(path, allow_pickle=False)
        return cls(
            LweSecretKey(d["key"], str(d["kind"]), BITS), float(d["std_dev"])
        )


@dataclasses.dataclass
class RLWESecretKey:
    """u64 binary GLWE secret key (rlwe_secretkey.rs)."""

    inner: GlweSecretKey
    std_dev: float

    @classmethod
    def new(cls, params: RLWEParams, *, secret_seed: int | None = None):
        gen = SecretRandomGenerator(secret_seed)
        return cls(
            GlweSecretKey.generate_binary(
                params.dimension, params.polynomial_size, gen, bits=BITS
            ),
            params.std_dev,
        )

    @property
    def dimension(self) -> int:
        return self.inner.dimension

    @property
    def polynomial_size(self) -> int:
        return self.inner.polynomial_size

    @property
    def variance(self) -> float:
        return self.std_dev ** 2

    def to_lwe_secret_key(self) -> LWESecretKey:
        """Flatten to the big LWE key (lwe_secretkey from rlwe)."""
        return LWESecretKey(self.inner.into_lwe_key(), self.std_dev)

    def save(self, path: str):
        """Serialize (rlwe_secretkey.rs derives Serialize)."""
        np.savez(path, key=self.inner.key, std_dev=self.std_dev,
                 kind=self.inner.kind)

    @classmethod
    def load(cls, path: str) -> "RLWESecretKey":
        d = np.load(path, allow_pickle=False)
        key = d["key"]
        return cls(GlweSecretKey(key, str(d["kind"]), BITS),
                   float(d["std_dev"]))


@dataclasses.dataclass
class LWEBSK:
    """Bootstrapping key (lwe_bsk.rs:20): GGSW of the input key bits under
    the RLWE key. The coefficient-domain form is canonical; evaluation forms
    derive lazily per backend ("mxu" int8-toeplitz rings, "nuss"
    Nussbaumer-domain rings, "ntt" exact-NTT spectra — bit-identical;
    "auto" resolves through core.backend.resolve)."""

    cfg: bs.ServerConfig
    variance: float
    coefficient_bsk: np.ndarray
    backend: str = "auto"
    _bsk_ntt: object = dataclasses.field(default=None, repr=False)
    _bsk_mxu: object = dataclasses.field(default=None, repr=False)
    _bsk_nuss: object = dataclasses.field(default=None, repr=False)

    def resolved_backend(self) -> str:
        from ..core import backend

        if self.backend != "auto":
            return self.backend
        return backend.resolve(self.cfg)

    def with_fast_mode(self, *, limb_drop: int = 2,
                       levels: int | None = None) -> "LWEBSK":
        """Reduced-precision evaluation twin over the same key material.

        The u64 torus has deep limb-drop headroom: dropping d of the 8 GGSW
        byte limbs adds unbiased rounding noise whose phase-level relative
        std (incl. the (1 + kN*E[s^2]) mask amplification, hardware-
        validated) is ~2^-29 at d=2 and ~2^-21 at d=3 for N=1024 — tracked
        analytically by npe.estimate_mxu_truncation_noise and folded into
        every bootstrap's variance update. ``levels`` keeps only the
        most-significant PBS decomposition levels. Ciphertexts and client
        keys are unchanged."""
        cfg = self.cfg.with_fast_mode(limb_drop=limb_drop, levels=levels)
        return dataclasses.replace(
            self, cfg=cfg,
            coefficient_bsk=self.coefficient_bsk[:, : cfg.pbs_level],
            _bsk_ntt=None, _bsk_mxu=None, _bsk_nuss=None)

    def bootstrap_output_variance(self, lwe_dimension: int) -> float:
        """PBS output variance incl. the reduced-precision term when this
        key runs in fast mode on the MXU backend."""
        from .. import npe as _npe
        from ..dispersion import Variance as _V

        var = _npe.estimate_pbs_noise(
            lwe_dimension, self.polynomial_size, self.dimension,
            self.base_log, self.level, _V(self.variance), BITS,
        ).get_variance()
        drop = getattr(self.cfg, "mxu_limb_drop", 0)
        if drop and self.resolved_backend() == "mxu":
            var += _npe.estimate_mxu_truncation_noise(
                lwe_dimension, self.polynomial_size, self.dimension,
                self.base_log, self.level, drop, BITS,
            ).get_variance()
        return var

    @property
    def bsk_ntt(self):
        if self._bsk_ntt is None:
            self._bsk_ntt = bsk_to_ntt(self.coefficient_bsk, self.cfg.primes, BITS)
        return self._bsk_ntt

    @property
    def bsk_mxu(self):
        import jax.numpy as jnp

        from ..core import bootstrap_mxu as bsx

        if self._bsk_mxu is None:
            self._bsk_mxu = jnp.asarray(bsx.bsk_to_mxu(self.coefficient_bsk, self.cfg))
        return self._bsk_mxu

    @property
    def bsk_nuss(self):
        import jax.numpy as jnp

        from ..core import bootstrap_nuss as bsn

        if self._bsk_nuss is None:
            self._bsk_nuss = jnp.asarray(
                bsn.bsk_to_nuss(self.coefficient_bsk, self.cfg))
        return self._bsk_nuss

    def run_bootstrap(self, accumulator, cts):
        """PBS of `cts` against `accumulator` on the resolved backend."""
        from ..core import bootstrap_mxu as bsx
        from ..core import bootstrap_nuss as bsn

        backend = self.resolved_backend()
        if backend == "mxu":
            return bsx.bootstrap_mxu(self.cfg, self.bsk_mxu, accumulator, cts)
        if backend == "nuss":
            return bsn.bootstrap_nuss(self.cfg, self.bsk_nuss, accumulator, cts)
        return bs.bootstrap(self.cfg, self.bsk_ntt, accumulator, cts)

    def run_bootstrap_many(self, accumulator, cts, lut_count_log: int):
        """Multi-LUT PBS: one blind rotation, 2^lcl packed functions ->
        [2^lcl, ..., k*N+1] (see core bootstrap_many_lut)."""
        from ..core import bootstrap_mxu as bsx
        from ..core import bootstrap_nuss as bsn

        backend = self.resolved_backend()
        if backend == "mxu":
            return bsx.bootstrap_many_lut_mxu(
                self.cfg, self.bsk_mxu, accumulator, cts, lut_count_log)
        if backend == "nuss":
            return bsn.bootstrap_many_lut_nuss(
                self.cfg, self.bsk_nuss, accumulator, cts, lut_count_log)
        return bs.bootstrap_many_lut(
            self.cfg, self.bsk_ntt, accumulator, cts, lut_count_log)

    @classmethod
    def new(
        cls,
        sk_input: LWESecretKey,
        sk_output: RLWESecretKey,
        base_log: int,
        level: int,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
        keep_coefficient_bsk: bool | None = None,
    ) -> "LWEBSK":
        cfg = bs.ServerConfig(
            lwe_dimension=sk_input.dimension,
            glwe_dimension=sk_output.dimension,
            polynomial_size=sk_output.polynomial_size,
            pbs_base_log=base_log,
            pbs_level=level,
            ks_base_log=1,
            ks_level=1,
            bits=BITS,
        )
        gen = EncryptionRandomGenerator(mask_seed, noise_seed)
        std_bsk = StandardBootstrapKey.generate(
            sk_input.inner, sk_output.inner, base_log, level, sk_output.std_dev, gen
        )
        if keep_coefficient_bsk is not None:
            import warnings

            warnings.warn(
                "keep_coefficient_bsk is deprecated and ignored: the"
                " coefficient BSK is the canonical stored form now",
                DeprecationWarning,
                stacklevel=2,
            )
        return cls(
            cfg=cfg,
            variance=sk_output.variance,
            coefficient_bsk=std_bsk.data,
        )

    @property
    def dimension(self) -> int:  # RLWE dimension k
        return self.cfg.glwe_dimension

    @property
    def polynomial_size(self) -> int:
        return self.cfg.polynomial_size

    @property
    def base_log(self) -> int:
        return self.cfg.pbs_base_log

    @property
    def level(self) -> int:
        return self.cfg.pbs_level

    def get_lwe_dimension(self) -> int:
        return self.cfg.lwe_dimension

    def get_polynomial_size_log(self) -> int:
        return log2_exact(self.polynomial_size)

    def save(self, path: str):
        np.savez_compressed(
            path,
            bsk=self.coefficient_bsk,
            variance=self.variance,
            lwe_dimension=self.cfg.lwe_dimension,
            base_log=self.cfg.pbs_base_log,
            level=self.cfg.pbs_level,
        )

    @classmethod
    def load(cls, path: str) -> "LWEBSK":
        d = np.load(path, allow_pickle=False)
        data = d["bsk"]
        n, level, glwe_size, _, poly = data.shape
        cfg = bs.ServerConfig(
            lwe_dimension=int(d["lwe_dimension"]),
            glwe_dimension=glwe_size - 1,
            polynomial_size=poly,
            pbs_base_log=int(d["base_log"]),
            pbs_level=int(d["level"]),
            ks_base_log=1,
            ks_level=1,
            bits=BITS,
        )
        return cls(
            cfg=cfg,
            variance=float(d["variance"]),
            coefficient_bsk=data,
        )


@dataclasses.dataclass
class LWEKSK:
    """Keyswitching key (lwe_ksk.rs:14).

    Off the CPU the u64 contraction runs on prepared int8 limb planes;
    bit-identical to the plain path."""

    inner: LweKeyswitchKey
    variance: float
    _limbs: object = dataclasses.field(default=None, repr=False)

    def run_keyswitch(self, cts):
        """Keyswitch a [..., n_in+1] batch on the best available path."""
        import jax
        import jax.numpy as jnp

        from ..core import backend
        from ..core import lwe as lwe_ops

        if backend.int8_keyswitch(
                jax.default_backend() != "cpu", self.base_log,
                self.inner.data.shape[0] * self.level):
            if self._limbs is None:
                self._limbs = jnp.asarray(lwe_ops.ksk_to_limbs(self.inner.data))
            return lwe_ops.keyswitch_limbs(
                self._limbs, cts, base_log=self.base_log, level_count=self.level)
        return lwe_ops.keyswitch(
            jnp.asarray(self.inner.data), cts,
            base_log=self.base_log, level_count=self.level)

    @classmethod
    def new(
        cls,
        sk_before: LWESecretKey,
        sk_after: LWESecretKey,
        base_log: int,
        level: int,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
    ) -> "LWEKSK":
        gen = EncryptionRandomGenerator(mask_seed, noise_seed)
        ksk = LweKeyswitchKey.generate(
            sk_before.inner, sk_after.inner, base_log, level, sk_after.std_dev, gen
        )
        return cls(inner=ksk, variance=sk_after.variance)

    @property
    def base_log(self) -> int:
        return self.inner.base_log

    @property
    def level(self) -> int:
        return self.inner.level_count

    def save(self, path: str):
        np.savez_compressed(
            path, data=self.inner.data, base_log=self.inner.base_log,
            level=self.inner.level_count, variance=self.variance,
        )

    @classmethod
    def load(cls, path: str) -> "LWEKSK":
        d = np.load(path, allow_pickle=False)
        return cls(
            inner=LweKeyswitchKey(
                d["data"], int(d["base_log"]), int(d["level"]), BITS
            ),
            variance=float(d["variance"]),
        )
