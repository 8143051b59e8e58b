"""Programmable bootstrapping: external product, CMux, blind rotation,
sample extraction — the heart of the library, batch-first and jittable.

Reference algorithms (crypto/bootstrap/fourier/mod.rs):
- external_product (:463-645): decompose the GLWE, transform, MAC against the
  GGSW rows, inverse-transform, add into the output;
- cmux (:648-664): ct0 += extprod(ggsw, ct1 - ct0);
- blind_rotate (:666-726): modulus-switch the LWE to 2N, rotate the LUT by
  X^{-b}, then one CMux per mask element;
- pbs_modulus_switch (:728-748) with ModulusSwitchOffset / LutCountLog knobs;
- constant_sample_extract (:750-790); bootstrap (:878-911).

Redesign vs the reference:
- the f64 FFT becomes an exact prime-NTT (u32 Montgomery lanes) + CRT;
- the per-ciphertext "skip if mask == 0" branch (fourier/mod.rs:710) is
  dropped: a zero rotation makes ct1 == ct0, the decomposition of the zero
  difference is all-zero digits, and the external product contributes exactly
  0 — so the branchless chain is bit-identical and fully batched;
- the n-iteration CMux chain is a lax.scan carrying the accumulator,
  with the NTT-domain bootstrap key streamed from device memory.

Example (modulus switch to the 2N grid):
    >>> import numpy as np
    >>> from concrete_tpu.core.bootstrap import pbs_modulus_switch
    >>> int(pbs_modulus_switch(np.uint32(1 << 31), 8))   # 0.5 of the torus -> 8 of 16
    8

A complete tiny PBS on the exact-NTT backend (sign bootstrap to +-1/8):
    >>> import numpy as np
    >>> from concrete_tpu.core import bootstrap as bs, glwe, lwe
    >>> from concrete_tpu.core.ggsw import StandardBootstrapKey, bsk_to_ntt
    >>> from concrete_tpu.csprng import EncryptionRandomGenerator, SecretRandomGenerator
    >>> cfg = bs.ServerConfig(lwe_dimension=8, glwe_dimension=1,
    ...     polynomial_size=64, pbs_base_log=7, pbs_level=2,
    ...     ks_base_log=4, ks_level=3)
    >>> sgen = SecretRandomGenerator(1)
    >>> lsk = lwe.LweSecretKey.generate_binary(8, sgen)
    >>> gsk = glwe.GlweSecretKey.generate_binary(1, 64, sgen)
    >>> gen = EncryptionRandomGenerator(2, 3)
    >>> bsk = StandardBootstrapKey.generate(lsk, gsk, 7, 2, 0.0, gen)
    >>> eighth = np.uint32(1 << 29)
    >>> ct = lsk.encrypt(eighth, 0.0, gen)             # encrypt +1/8
    >>> lut = bs.trivial_lut_constant(cfg, eighth)
    >>> out = bs.bootstrap(cfg, bsk_to_ntt(bsk.data, cfg.primes, 32), lut,
    ...                    np.asarray(ct))
    >>> phase = int(gsk.into_lwe_key().decrypt(np.asarray(out)[None])[0])
    >>> abs(phase - (1 << 29)) < (1 << 20)             # lands on +1/8
    True
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..math import crt, decomposition, ntt, polynomial
from ..params import BooleanParameters
from . import lwe as lwe_ops

_JNP_SIGNED = {32: jnp.int32, 64: jnp.int64}


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Static (hashable) configuration closed over by the jitted server ops."""

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    bits: int = 32
    primes: tuple[int, ...] = ()
    # Reduced-precision MXU external product: drop this many *low* byte limbs
    # of the GGSW operand (the RHS of the toeplitz matmul). Dropping d limbs
    # rounds every key coefficient to a multiple of 2^{8d} (balanced limbs =>
    # round-to-nearest, unbiased), which enters the PBS noise exactly like
    # extra bootstrap-key noise of variance 2^{16d}/12 — the analog of the
    # reference's f64-FFT rounding noise (transform.rs "FFT noise" comments).
    # npe.estimate_mxu_truncation_noise quantifies it; 0 = exact (default).
    # Only the MXU backend honors this; the NTT backend is always exact.
    mxu_limb_drop: int = 0

    def __post_init__(self):
        if not (0 <= self.mxu_limb_drop <= self.bits // 8 - 2):
            raise ValueError(
                f"mxu_limb_drop={self.mxu_limb_drop}: must keep >= 2 of the "
                f"{self.bits // 8} GGSW byte limbs")
        if not self.primes:
            bound = crt.external_product_bound(
                self.polynomial_size,
                self.pbs_level * (self.glwe_dimension + 1),
                1 << self.pbs_base_log,
                self.bits,
            )
            object.__setattr__(self, "primes", crt.select_primes(bound))
        # the NTT path maps signed digits to residues with a single +p fixup,
        # which requires |digit| <= B/2 < min(prime)
        if (1 << (self.pbs_base_log - 1)) >= min(self.primes):
            raise NotImplementedError(
                f"pbs_base_log={self.pbs_base_log}: gadget digits exceed the "
                f"smallest CRT prime {min(self.primes)}")

    @classmethod
    def from_boolean_parameters(cls, p: BooleanParameters) -> "ServerConfig":
        return cls(
            lwe_dimension=p.lwe_dimension,
            glwe_dimension=p.glwe_dimension,
            polynomial_size=p.polynomial_size,
            pbs_base_log=p.pbs_base_log,
            pbs_level=p.pbs_level,
            ks_base_log=p.ks_base_log,
            ks_level=p.ks_level,
            bits=32,
        )

    def with_fast_mode(self, *, limb_drop: int = 1,
                       levels: int | None = None) -> "ServerConfig":
        """A reduced-precision evaluation view over the *same* key material.

        ``levels`` (< pbs_level) evaluates the PBS with only the most-
        significant decomposition levels (the BSK is sliced accordingly);
        the decomposition rounding then absorbs the dropped levels, and the
        standard NPE formulas at the reduced level count model it exactly.
        ``limb_drop`` additionally rounds the GGSW operand to 8*(n_limbs-d)
        bits on the MXU path (see mxu_limb_drop). Ciphertexts and client
        keys are unchanged — this only alters server-side evaluation.
        """
        lv = self.pbs_level if levels is None else levels
        if not (1 <= lv <= self.pbs_level):
            raise ValueError(f"levels={lv}: need 1 <= levels <= pbs_level")
        return dataclasses.replace(
            self, pbs_level=lv, mxu_limb_drop=limb_drop, primes=())

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def crt_context(self) -> crt.CrtContext:
        return crt.CrtContext.new(self.primes, self.bits)

    def plan(self, p: int) -> ntt.NttPlan:
        return ntt.make_plan(self.polynomial_size, p)


# ---------------------------------------------------------------------------
# external product / cmux
# ---------------------------------------------------------------------------


def _external_product_stacked(cfg: ServerConfig, sp, ggsw_ntt, glwe_pbn):
    """Stacked-prime external product in poly-major layout.

    ggsw_ntt: [P, l, k+1, k+1, N] Montgomery spectra; glwe_pbn: [k+1, B, N]
    torus (batch in the LANE-friendly middle axis). Returns [k+1, B, N].
    All P primes ride one tensor (ntt.StackedNttPlans); exact — no FFT
    rounding term (fourier/mod.rs:463-645 analog).
    """
    rounded = decomposition.closest_representable(
        glwe_pbn, cfg.pbs_base_log, cfg.pbs_level
    )
    digits = decomposition.decompose_levels(rounded, cfg.pbs_base_log, cfg.pbs_level)
    digits = jnp.moveaxis(digits, -1, 0)  # [l, k+1, B, N] signed
    # residues for all primes at once: |digit| <= B/2 << p
    p_bc = jnp.asarray(sp.p.astype(np.int32)).reshape((-1,) + (1,) * digits.ndim)
    dres = jnp.where(digits[None] < 0, digits[None] + p_bc, digits[None]).astype(
        jnp.uint32
    )  # [P, l, k+1, B, N]
    dspec = ntt.forward_stacked(sp, dres)
    acc = None
    for lev in range(cfg.pbs_level):
        for i in range(cfg.glwe_size):
            d = dspec[:, lev, i]                 # [P, B, N]
            g = ggsw_ntt[:, lev, i]              # [P, k+1, N]
            prod = sp.mont_mul(d[:, None], g[:, :, None, :])  # [P, k+1, B, N]
            acc = prod if acc is None else sp.add(acc, prod)
    residues = ntt.inverse_stacked(sp, acc)      # [P, k+1, B, N]
    return cfg.crt_context.combine_to_torus(
        [residues[pi] for pi in range(len(cfg.primes))]
    )


def external_product(cfg: ServerConfig, ggsw_ntt, glwe):
    """<decomp(glwe), GGSW> — public [..., k+1, N] layout wrapper."""
    sp = ntt.make_stacked_plans(cfg.polynomial_size, cfg.primes)
    lead = glwe.shape[:-2]
    ks1, n = glwe.shape[-2:]
    flat = glwe.reshape((-1, ks1, n))
    pbn = jnp.moveaxis(flat, 1, 0)  # [k+1, B, N]
    out = _external_product_stacked(cfg, sp, ggsw_ntt, pbn)
    return jnp.moveaxis(out, 0, 1).reshape(lead + (ks1, n))


def cmux(cfg: ServerConfig, ggsw_ntt, ct0, ct1):
    """ct0 + extprod(ggsw, ct1 - ct0): selects ct0 (bit=0) or ct1 (bit=1).

    Reference fourier/mod.rs:648-664 (result in ct0)."""
    return ct0 + external_product(cfg, ggsw_ntt, ct1 - ct0)


# ---------------------------------------------------------------------------
# modulus switch / blind rotate / sample extract
# ---------------------------------------------------------------------------


def pbs_modulus_switch(x, poly_size: int, offset: int = 0, lut_count_log: int = 0):
    """Round a torus value to Z_{2N} (fourier/mod.rs:728-748).

    offset = number of MSBs discarded; lut_count_log = LSB padding for
    multi-LUT packing. Returns int32 monomial degrees.
    """
    bits = jnp.dtype(x.dtype).itemsize * 8
    log2n = poly_size.bit_length() - 1
    out = x << offset
    out = out >> (bits - log2n - 2 + lut_count_log)
    out = out + (out & np.array(1, x.dtype))
    out = out >> 1
    out = out << lut_count_log
    return out.astype(jnp.int32)


def blind_rotate(cfg: ServerConfig, bsk_ntt, lut, lwe, *, ms_offset: int = 0,
                 lut_count_log: int = 0):
    """Rotate `lut` by X^{-b} then CMux-chain over the mask elements.

    bsk_ntt: [n, P, l, k+1, k+1, N] — the CMux-chain axis is LEADING so the
    per-iteration dynamic slice is a contiguous HBM read (a minor-axis slice
    would make XLA re-materialize the multi-MB key every iteration);
    lut: [..., k+1, N]; lwe: [..., n+1]. Returns the rotated accumulator GLWE
    [..., k+1, N]. The chain is sequential in the LWE dimension (inherent
    data dependency); all batch lanes advance together
    (fourier/mod.rs:666-726).
    """
    from . import checks

    checks.check_bsk_ntt(bsk_ntt, cfg)
    checks.check_lwe(lwe, cfg.lwe_dimension)
    checks.check_glwe(lut, cfg.glwe_size, cfg.polynomial_size, "accumulator")
    n_poly = cfg.polynomial_size
    sp = ntt.make_stacked_plans(cfg.polynomial_size, cfg.primes)
    lead = lwe.shape[:-1]
    lwe_flat = lwe.reshape((-1, lwe.shape[-1]))  # [B, n+1]
    body = lwe_flat[..., -1]
    b_hat = pbs_modulus_switch(body, n_poly, ms_offset, lut_count_log)  # [B]
    # accumulator in poly-major layout [k+1, B, N]: lanes stay the wide N
    # axis, sublanes the batch — no tiny-dimension tile padding in the loop
    lut_b = jnp.broadcast_to(
        lut.reshape((-1,) + lut.shape[-2:]) if lut.ndim > 2 else lut[None],
        (lwe_flat.shape[0],) + lut.shape[-2:],
    )
    acc = jnp.moveaxis(lut_b, 1, 0)  # [k+1, B, N]
    acc = polynomial.negacyclic_monomial_div(acc, b_hat[None, :])
    # modulus-switch every mask element up front (one vectorized op)
    a_hats = jnp.moveaxis(
        pbs_modulus_switch(lwe_flat[..., :-1], n_poly, ms_offset, lut_count_log),
        -1, 0)  # [n, B]

    def step(acc, xs):
        ggsw_i, a_hat = xs  # [P, l, k+1, k+1, N], [B]
        rotated = polynomial.negacyclic_monomial_mul(acc, a_hat[None, :])
        diff = rotated - acc
        return acc + _external_product_stacked(cfg, sp, ggsw_i, diff), None

    # lax.scan (not fori_loop): the bootstrap key streams through the loop as
    # a scanned input, one contiguous per-iteration slice
    acc, _ = jax.lax.scan(step, acc, (bsk_ntt, a_hats))
    return jnp.moveaxis(acc, 0, 1).reshape(lead + acc.shape[:1] + acc.shape[2:])


def sample_extract_nth(glwe, n_th: int):
    """LWE(dim k*N) of coefficient `n_th` of the GLWE — the
    lwe_ciphertext_discarding_extraction engine with a MonomialDegree
    (specification/engines/lwe_ciphertext_discarding_extraction.rs).

    Implemented as X^{-n_th} rotation (a GLWE homomorphism permuting the
    plaintext coefficients) followed by constant extraction."""
    from ..math import polynomial as poly_mod

    return sample_extract(poly_mod.negacyclic_monomial_div(glwe, n_th))


def sample_extract(glwe):
    """LWE(dim k*N) of coefficient 0 of the GLWE (fourier/mod.rs:750-790).

    Mask polys are reversed+negated then multiplied by X (wrapping the last
    coefficient around with a sign flip); body = body poly coefficient 0.
    """
    mask = glwe[..., :-1, :]
    zero = np.array(0, glwe.dtype)
    tmp = zero - mask[..., ::-1]
    rolled = jnp.roll(tmp, 1, axis=-1)
    first = zero - rolled[..., 0:1]
    out_mask = jnp.concatenate([first, rolled[..., 1:]], axis=-1)
    lead = glwe.shape[:-2]
    k, n = mask.shape[-2], mask.shape[-1]
    out_mask = out_mask.reshape(lead + (k * n,))
    body = glwe[..., -1, 0:1]
    return jnp.concatenate([out_mask, body], axis=-1)


def bootstrap(cfg: ServerConfig, bsk_ntt, lut, lwe):
    """Full PBS: blind rotate the accumulator, then sample-extract
    (fourier/mod.rs:878-911). lwe: [..., n+1] -> [..., k*N+1]."""
    return sample_extract(blind_rotate(cfg, bsk_ntt, lut, lwe))


def bootstrap_many_lut(cfg: ServerConfig, bsk_ntt, lut, lwe,
                       lut_count_log: int, *, ms_offset: int = 0):
    """Multi-LUT PBS: one blind rotation evaluates 2^lut_count_log functions.

    Rotation amounts are rounded to multiples of 2^lcl (the LutCountLog /
    ModulusSwitchOffset knobs of pbs_modulus_switch, fourier/mod.rs:728-748),
    so the accumulator's coefficient tracks c = t (mod 2^lcl) each carry one
    packed LUT; track t is extracted at coefficient t. `lut` must interleave
    the functions: lut[..., c] = f_{c mod 2^lcl}(floor(c / 2^lcl)-th entry).
    Returns [2^lcl, ..., k*N+1] — one LWE per function.
    """
    acc = blind_rotate(cfg, bsk_ntt, lut, lwe, ms_offset=ms_offset,
                       lut_count_log=lut_count_log)
    return jnp.stack(
        [sample_extract_nth(acc, t) for t in range(1 << lut_count_log)], axis=0
    )


def bootstrap_keyswitch(cfg: ServerConfig, bsk_ntt, ksk, lut, lwe):
    """PBS followed by keyswitch back to the small key — the per-gate
    pipeline of concrete-boolean (server_key/mod.rs:133-166)."""
    big = bootstrap(cfg, bsk_ntt, lut, lwe)
    return lwe_ops.keyswitch(
        ksk, big, base_log=cfg.ks_base_log, level_count=cfg.ks_level
    )


def trivial_lut_constant(cfg: ServerConfig, value, batch_shape=()):
    """Accumulator GLWE with zero mask and constant body polynomial — the
    boolean gates' test polynomial (server_key/mod.rs:145-156)."""
    dt = jnp.uint32 if cfg.bits == 32 else jnp.uint64
    lut = jnp.zeros(batch_shape + (cfg.glwe_size, cfg.polynomial_size), dtype=dt)
    return lut.at[..., -1, :].set(jnp.asarray(value, dtype=dt))


@functools.lru_cache(maxsize=None)
def jit_bootstrap_keyswitch(cfg: ServerConfig):
    """Cached jitted gate pipeline for a configuration."""
    return jax.jit(functools.partial(bootstrap_keyswitch, cfg))
