"""GGSW layer: constant encryption (key material) and NTT-domain conversion.

A GGSW ciphertext is [l, k+1, k+1, N]: `level` matrices of (k+1) GLWE rows
(reference: crypto/ggsw/standard.rs:25). A bootstrap key is one GGSW per LWE
key bit, [n, l, k+1, k+1, N] (crypto/bootstrap/standard/mod.rs:57).

Randomness is drawn per forked child generator in reference order
(bit-exactness), but ciphertext assembly — every mask*key polynomial product —
runs as ONE batched NTT over all n*l*(k+1) rows, replacing the reference's
rayon fan-out (standard/mod.rs:254) with data parallelism.

The reference converts the BSK to the complex Fourier domain
(bootstrap/fourier/mod.rs:33,186); we convert to the exact NTT domain instead:
per CRT prime, Montgomery-form spectra [P, n, l, k+1, k+1, N] uint32 —
resident in device memory, one slice per step of the blind rotation.

Example:
    >>> from concrete_tpu.core.ggsw import encrypt_constant_ggsw
    >>> from concrete_tpu.core.glwe import GlweSecretKey
    >>> from concrete_tpu.csprng import EncryptionRandomGenerator, SecretRandomGenerator
    >>> sk = GlweSecretKey.generate_binary(1, 16, SecretRandomGenerator(1))
    >>> g = encrypt_constant_ggsw(sk, 1, 4, 2, 0.0, EncryptionRandomGenerator(1, 2))
    >>> g.shape            # [levels, k+1, k+1, N]
    (2, 2, 2, 16)
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..csprng import EncryptionRandomGenerator
from ..math import crt, ntt
from ..torus import UNSIGNED
from .glwe import GlweSecretKey


def _draw_ggsw_randomness(
    glwe_key: GlweSecretKey, level_count: int, std: float, gen: EncryptionRandomGenerator
):
    """Draw mask/noise for one GGSW in reference fork order
    (secret/glwe.rs:775-820): fork per level, then per row; each row draws
    noise[N] then mask[k,N] from its own child generator."""
    bits = glwe_key.bits
    k, n = glwe_key.dimension, glwe_key.polynomial_size
    masks = np.zeros((level_count, k + 1, k, n), dtype=UNSIGNED[bits])
    noises = np.zeros((level_count, k + 1, n), dtype=UNSIGNED[bits])
    for lev_idx, lev_gen in enumerate(
        gen.fork_ggsw_to_ggsw_levels(bits, level_count, k + 1, n)
    ):
        for row_idx, row_gen in enumerate(
            lev_gen.fork_ggsw_level_to_glwe(bits, k + 1, n)
        ):
            m, nz = glwe_key.draw_randomness(1, std, row_gen)
            masks[lev_idx, row_idx] = m[0]
            noises[lev_idx, row_idx] = nz[0]
    return masks, noises


def encrypt_constant_ggsw(
    glwe_key: GlweSecretKey,
    value: int,
    base_log: int,
    level_count: int,
    std: float,
    gen: EncryptionRandomGenerator,
) -> np.ndarray:
    """Encrypt a constant (key bit) as a GGSW -> [l, k+1, k+1, N].

    Mirrors encrypt_constant_ggsw (secret/glwe.rs:775-860): each row is a
    fresh zero GLWE from its forked generator; the gadget summand
    m * q/B^level is added to the first coefficient of the row's diagonal
    polynomial (column == row index).
    """
    masks, noises = _draw_ggsw_randomness(glwe_key, level_count, std, gen)
    return assemble_ggsw(glwe_key, int(value), base_log, level_count, masks, noises)[0]


def assemble_ggsw(
    glwe_key: GlweSecretKey,
    value: int,
    base_log: int,
    level_count: int,
    masks: np.ndarray,   # [l, k+1, k, N] or [n, l, k+1, k, N]
    noises: np.ndarray,  # [l, k+1, N]  or [n, l, k+1, N]
    values: np.ndarray | None = None,  # [n] when batched over key bits
) -> np.ndarray:
    """Assemble GGSW rows from randomness: one batched multisum, then add the
    gadget constants on the diagonals."""
    bits = glwe_key.bits
    dt = UNSIGNED[bits]
    k, n = glwe_key.dimension, glwe_key.polynomial_size
    rows = glwe_key.encrypt_from_randomness(
        masks, noises, np.zeros(noises.shape, dtype=dt)
    )  # [..., l, k+1, k+1, N]
    if values is None:
        values = np.array([value], dtype=np.int64)
        rows = rows[None]
    _add_gadget_diagonals(rows, values, base_log, level_count, bits)
    return rows


def _add_gadget_diagonals(rows, values, base_log, level_count, bits):
    """Add the gadget summands m*q/B^level to the first coefficient of each
    level matrix's diagonal polynomials, in place. rows: [n, l, k+1, k+1, N];
    values: [n] ints (secret/glwe.rs:831-856)."""
    dt = UNSIGNED[bits]
    ks1 = rows.shape[2]
    shifts = np.array(
        [bits - base_log * (lev + 1) for lev in range(level_count)], dtype=np.uint64
    )
    # summand[b, lev] = value_b << shift_lev  (wrapping)
    summands = (
        values.astype(np.uint64)[:, None] << shifts[None, :]
    ).astype(dt)  # [n_bits, l]
    for row_idx in range(ks1):
        rows[:, :, row_idx, row_idx, 0:1] += summands[:, :, None]


@dataclasses.dataclass
class StandardBootstrapKey:
    """Coefficient-domain bootstrap key: one GGSW per input key bit.

    data: [n, l, k+1, k+1, N]. Reference: bootstrap/standard/mod.rs:57-210.
    """

    data: np.ndarray
    base_log: int
    level_count: int
    bits: int

    @classmethod
    def generate(
        cls,
        lwe_key,
        glwe_key: GlweSecretKey,
        base_log: int,
        level_count: int,
        std: float,
        gen: EncryptionRandomGenerator,
        *,
        batched: bool = True,
    ) -> "StandardBootstrapKey":
        """fill_with_new_key (standard/mod.rs:172-209): fork the generator per
        key bit (identical bits to the reference's rayon par_fill), draw all
        randomness host-side, then assemble every row in one batched NTT.

        The default path batches the randomness draws across ALL forked
        children (one contiguous mask read + one AES sweep over every noise
        child, csprng.random.batch_fill_gaussian_torus) and overlaps the
        device-side mask*key multisum with the host-side noise draw — the
        batched answer to the reference's rayon par_fill_with_new_key
        (standard/mod.rs:254). ``batched=False`` keeps the per-bit
        sequential draw; both produce identical bits (tests/test_csprng.py,
        golden digests in tests/test_golden.py).
        """
        bits = glwe_key.bits
        k = glwe_key.dimension
        n = glwe_key.polynomial_size
        n_lwe = lwe_key.dimension
        if not batched:
            bit_gens = gen.fork_bsk_to_ggsw(bits, n_lwe, level_count, k + 1, n)
            masks = np.zeros((n_lwe, level_count, k + 1, k, n), dtype=UNSIGNED[bits])
            noises = np.zeros((n_lwe, level_count, k + 1, n), dtype=UNSIGNED[bits])
            for i, g in enumerate(bit_gens):
                masks[i], noises[i] = _draw_ggsw_randomness(
                    glwe_key, level_count, std, g)
            data = assemble_ggsw(
                glwe_key,
                0,
                base_log,
                level_count,
                masks,
                noises,
                values=lwe_key.key.astype(np.int64),
            )
            return cls(data=data, base_log=base_log, level_count=level_count,
                       bits=bits)

        import jax.numpy as jnp

        from ..csprng.random import RandomGenerator, batch_fill_gaussian_torus
        from .glwe import _jit_multisum

        # The nested fork budgets (bsk -> ggsw -> levels -> rows) are
        # consumed EXACTLY by the mask draws, so the whole BSK mask tensor
        # is one contiguous range of the parent mask stream starting at the
        # pre-fork state — read it in one sweep.
        from ..csprng.generator import AesCtrGenerator, State

        mask_start = gen.mask.inner.state.gpos
        bit_gens = gen.fork_bsk_to_ggsw(bits, n_lwe, level_count, k + 1, n)
        noise_gens = []
        for g in bit_gens:
            for lev_gen in g.fork_ggsw_to_ggsw_levels(bits, level_count, k + 1, n):
                noise_gens.extend(
                    rg.noise for rg in lev_gen.fork_ggsw_level_to_glwe(bits, k + 1, n))
        reader = RandomGenerator(_inner=AesCtrGenerator(
            state=State(gpos=mask_start),
            _round_keys=gen.mask.inner.round_keys))
        rows = n_lwe * level_count * (k + 1)
        masks = reader.random_uniform_array(rows * k * n, bits).reshape(
            n_lwe, level_count, k + 1, k, n)
        # dispatch the mask*key multisum on device NOW (async), draw the
        # gaussian noise on the host underneath it
        ms_dev = _jit_multisum(
            jnp.asarray(masks), jnp.asarray(glwe_key.key), bits,
            small_max=glwe_key._key_magnitude())
        try:
            ms_dev.copy_to_host_async()  # D2H rides under the noise draw too
        except Exception:  # pragma: no cover - backend without async copy
            pass
        noises = batch_fill_gaussian_torus(noise_gens, n, std, bits).reshape(
            n_lwe, level_count, k + 1, n)
        bodies = noises + np.array(ms_dev)
        data = np.concatenate([masks, bodies[..., None, :]], axis=-2)
        _add_gadget_diagonals(
            data, lwe_key.key.astype(np.int64), base_log, level_count, bits)
        return cls(data=data, base_log=base_log, level_count=level_count, bits=bits)


def ggsw_to_ntt(ggsw: np.ndarray, primes: tuple[int, ...], bits: int):
    """Forward-NTT every polynomial of a GGSW tensor -> [P, ..., N] uint32.

    Torus coefficients are centered (signed) before residue reduction, which
    halves the CRT bound. Output spectra are in Montgomery form, bit-reversed
    order — ready for pointwise MACs. Analog of the reference's
    fill_with_forward_fourier (bootstrap/fourier/mod.rs:186), done as one
    batched transform over all n*l*(k+1)^2 polynomials.
    """
    import jax

    n = ggsw.shape[-1]
    cc = crt.CrtContext.new(tuple(primes), bits)

    rp = ntt.make_stacked_plans(n, tuple(primes))

    @jax.jit
    def _convert(g):
        residues = cc.residues_from_torus(g)
        return ntt.forward_stacked(rp, jnp.stack(residues, axis=0))

    return _convert(jnp.asarray(ggsw))


def bsk_to_ntt(bsk_data: np.ndarray, primes: tuple[int, ...], bits: int):
    """NTT-transform a full bootstrap key -> [n, P, l, k+1, k+1, N].

    The CMux-chain axis n is LEADING so the blind rotation's per-iteration
    dynamic slice is a contiguous HBM read (see core/bootstrap.py).
    """
    spectra = ggsw_to_ntt(bsk_data, primes, bits)  # [P, n, l, k+1, k+1, N]
    return jnp.moveaxis(spectra, 1, 0)
