"""Scalar GSW over LWE: encryption, external product, CMux.

Reference: crypto/gsw/ciphertext.rs (+ secret/lwe.rs:494 encrypt_constant_gsw).
A GSW ciphertext is [l, n+1, n+1]: `level` matrices of n+1 LWE rows; the
gadget summand m * q/B^level sits on the diagonal. The external product
contracts the decomposed input LWE against the rows — a single integer
matmul per batch. Research/private component in the reference (no engine
exposes it, specification/entities/mod.rs:46-47); exposed here for parity.

Example (external product with GSW(0) yields an encryption of 0):
    >>> import numpy as np
    >>> from concrete_tpu.core import gsw, lwe
    >>> from concrete_tpu.csprng import EncryptionRandomGenerator, SecretRandomGenerator
    >>> sk = lwe.LweSecretKey.generate_binary(8, SecretRandomGenerator(3))
    >>> g = gsw.encrypt_constant_gsw(sk, 0, 8, 2, 0.0, EncryptionRandomGenerator(4, 5))
    >>> ct = lwe.trivial_encrypt(np.uint32(1 << 31), 8)
    >>> out = gsw.external_product(np.asarray(g), np.asarray(ct), base_log=8, level_count=2)
    >>> int(sk.decrypt(np.asarray(out)[None])[0])
    0
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..csprng import EncryptionRandomGenerator
from ..math import decomposition
from ..torus import UNSIGNED
from .lwe import LweSecretKey

_JNP_SIGNED = {32: jnp.int32, 64: jnp.int64}


def encrypt_constant_gsw(
    lwe_key: LweSecretKey,
    value: int,
    base_log: int,
    level_count: int,
    std: float,
    gen: EncryptionRandomGenerator,
) -> np.ndarray:
    """GSW(value) -> [l, n+1, n+1] (secret/lwe.rs:494): fork per level, then
    per row; each row is a fresh zero LWE; diagonal gets m * q/B^level."""
    bits = lwe_key.bits
    dt = UNSIGNED[bits]
    n = lwe_key.dimension
    out = np.zeros((level_count, n + 1, n + 1), dtype=dt)
    for lev_idx, lev_gen in enumerate(
        gen.fork_gsw_to_gsw_levels(bits, level_count, n + 1)
    ):
        summand = dt((int(value) << (bits - base_log * (lev_idx + 1))) % (1 << bits))
        for row_idx, row_gen in enumerate(lev_gen.fork_gsw_level_to_lwe(bits, n + 1)):
            row = lwe_key.encrypt(np.zeros((), dtype=dt), std, row_gen)
            row[row_idx : row_idx + 1] += summand
            out[lev_idx, row_idx] = row
    return out


def external_product(gsw, lwe, *, base_log: int, level_count: int):
    """<decomp(lwe), GSW> (gsw/ciphertext.rs:416): round the whole input
    ciphertext, decompose, contract digits against the GSW rows.

    gsw: [l, n+1, n+1]; lwe: [..., n+1] -> [..., n+1].
    """
    bits = jnp.dtype(lwe.dtype).itemsize * 8
    sdt = _JNP_SIGNED[bits]
    rounded = decomposition.closest_representable(lwe, base_log, level_count)
    digits = decomposition.decompose_levels(rounded, base_log, level_count)
    # [..., n+1, l] -> contract over both: flat [.., (n+1)*l] x [(n+1)*l, n+1]
    lead = digits.shape[:-2]
    size = digits.shape[-2]
    flat = jnp.moveaxis(digits, -1, -2).reshape(lead + (level_count * size,))
    g = jax.lax.bitcast_convert_type(gsw, sdt).reshape(level_count * size, size)
    acc = jax.lax.dot_general(
        flat, g, (((flat.ndim - 1,), (0,)), ((), ())), preferred_element_type=sdt
    )
    return jax.lax.bitcast_convert_type(acc, lwe.dtype)


def cmux(gsw, ct0, ct1, *, base_log: int, level_count: int):
    """ct0 + extprod(gsw, ct1 - ct0) (gsw/ciphertext.rs:534-559)."""
    return ct0 + external_product(
        gsw, ct1 - ct0, base_log=base_log, level_count=level_count
    )
