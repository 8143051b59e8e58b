"""LWE layer: secret keys, encryption, arithmetic, keyswitching.

Ciphertext layout matches the reference (crypto/lwe/ciphertext.rs:20): a
ciphertext is a row [a_0..a_{n-1}, b] with the body LAST; batches stack rows
on leading axes. Client-side ops are numpy (bit-exact under fixed seeds,
reference: crypto/secret/lwe.rs); server-side ops are jittable jnp functions.

Example (trivial encryption is exact):
    >>> import numpy as np
    >>> from concrete_tpu.core import lwe
    >>> ct = lwe.trivial_encrypt(np.uint32(12345), 8)
    >>> int(lwe.trivial_decrypt(np.asarray(ct)))
    12345

Arithmetic engine analogs (wrapping mod 2^32):
    >>> c2 = lwe.trivial_encrypt(np.uint32(1000), 8)
    >>> int(lwe.trivial_decrypt(np.asarray(lwe.add(ct, c2))))
    13345
    >>> int(lwe.trivial_decrypt(np.asarray(lwe.sub(ct, c2))))
    11345
    >>> int(lwe.trivial_decrypt(np.asarray(lwe.neg(c2))))
    4294966296
    >>> int(lwe.trivial_decrypt(np.asarray(lwe.scalar_mul(c2, np.uint32(3)))))
    3000
    >>> int(lwe.trivial_decrypt(np.asarray(lwe.add_plaintext(c2, np.uint32(5)))))
    1005

Real encryption round trip with keyswitching:
    >>> from concrete_tpu.csprng import EncryptionRandomGenerator, SecretRandomGenerator
    >>> sgen = SecretRandomGenerator(1)
    >>> k_in = lwe.LweSecretKey.generate_binary(16, sgen)
    >>> k_out = lwe.LweSecretKey.generate_binary(12, sgen)
    >>> gen = EncryptionRandomGenerator(2, 3)
    >>> ksk = lwe.LweKeyswitchKey.generate(k_in, k_out, 8, 3, 0.0, gen)
    >>> c = k_in.encrypt(np.uint32(1 << 28), 0.0, gen)
    >>> out = lwe.keyswitch(np.asarray(ksk.data), np.asarray(c), base_log=8, level_count=3)
    >>> abs(int(k_out.decrypt(np.asarray(out)[None])[0]) - (1 << 28)) < (1 << 10)
    True
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..csprng import EncryptionRandomGenerator, SecretRandomGenerator
from ..math import decomposition
from ..torus import UNSIGNED, SIGNED

_JNP_SIGNED = {32: jnp.int32, 64: jnp.int64}
_NP_SIGNED = {32: np.int64, 64: np.int64}  # wide enough for any Python int input
_JNP_UNSIGNED = {32: jnp.uint32, 64: jnp.uint64}


# ---------------------------------------------------------------------------
# client side (numpy, bit-exact)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LweSecretKey:
    """An LWE secret key: [n] unsigned array of key coefficients.

    Reference: crypto/secret/lwe.rs:30 (LweSecretKey<Kind, Cont>).
    """

    key: np.ndarray  # [n], dtype uint32/uint64
    kind: str  # binary | ternary | gaussian | uniform
    bits: int

    @property
    def dimension(self) -> int:
        return self.key.shape[0]

    @classmethod
    def generate_binary(cls, dim: int, gen: SecretRandomGenerator, bits: int = 32):
        return cls(gen.generate_binary_array(dim, bits), "binary", bits)

    @classmethod
    def generate_ternary(cls, dim: int, gen: SecretRandomGenerator, bits: int = 32):
        return cls(gen.generate_ternary_array(dim, bits), "ternary", bits)

    @classmethod
    def generate_gaussian(cls, dim: int, gen: SecretRandomGenerator, bits: int = 32):
        return cls(gen.generate_gaussian_array(dim, bits), "gaussian", bits)

    @classmethod
    def generate_uniform(cls, dim: int, gen: SecretRandomGenerator, bits: int = 32):
        return cls(gen.generate_uniform_array(dim, bits), "uniform", bits)

    def encrypt(
        self,
        plaintexts: np.ndarray,
        std: float,
        gen: EncryptionRandomGenerator,
    ) -> np.ndarray:
        """Encrypt a batch of plaintexts -> [..., n+1].

        b = sum a_i s_i + e + m with uniform mask a and gaussian e
        (secret/lwe.rs:320-346). Stream consumption per ciphertext: n mask
        values then one noise draw, identical to encrypt_lwe_list looping.
        """
        dt = UNSIGNED[self.bits]
        pts = np.asarray(plaintexts, dtype=dt)
        shape = pts.shape
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        masks = gen.fill_mask(count * self.dimension, self.bits).reshape(
            count, self.dimension
        )
        # one gaussian pair per ciphertext, first element kept (gaussian.rs:71-79);
        # batching the draws consumes the identical attempt stream.
        from ..torus import from_torus_f64

        g1, _ = gen.noise.random_gaussian_pairs(count, 0.0, std)
        noises = from_torus_f64(g1, self.bits)
        bodies = (
            (masks * self.key[None, :]).sum(axis=1, dtype=dt)
            + noises
            + pts.reshape(count)
        )
        out = np.concatenate([masks, bodies[:, None]], axis=1)
        return out.reshape(shape + (self.dimension + 1,))

    def decrypt(self, ct: np.ndarray) -> np.ndarray:
        """b - sum a_i s_i (secret/lwe.rs:420)."""
        dt = UNSIGNED[self.bits]
        ct = np.asarray(ct, dtype=dt)
        return ct[..., -1] - (ct[..., :-1] * self.key).sum(axis=-1, dtype=dt)


# ---------------------------------------------------------------------------
# server side (jnp, jittable, batch-first)
# ---------------------------------------------------------------------------


def trivial_encrypt(pt, dimension: int, bits: int = 32):
    """Trivial LWE: zero mask, body = plaintext — decryptable under ANY key
    (lwe_ciphertext_trivial_encryption engine). pt: [...] -> [..., n+1].

    `bits` fixes the torus width (downstream ops derive it from the dtype,
    so Python-int plaintexts must not leak int64 in)."""
    dt = jnp.uint32 if bits == 32 else jnp.uint64
    pt = jnp.asarray(pt, dtype=dt)
    out = jnp.zeros(pt.shape + (dimension + 1,), dtype=dt)
    return out.at[..., -1].set(pt)


def trivial_decrypt(ct):
    """Body of a trivial LWE (lwe_ciphertext_trivial_decryption engine)."""
    return ct[..., -1]


def add(ct_a, ct_b):
    """Homomorphic addition (wrapping)."""
    return ct_a + ct_b


def sub(ct_a, ct_b):
    return ct_a - ct_b


def neg(ct):
    """Opposite: every coefficient negated (lwe/ciphertext.rs ops)."""
    return jnp.zeros_like(ct) - ct


def _as_torus(value, dtype):
    """Convert (possibly negative) Python/array integers to the unsigned
    torus dtype with two's-complement wrapping (NumPy 2 rejects negative
    Python ints for unsigned dtypes)."""
    signed = _NP_SIGNED[jnp.dtype(dtype).itemsize * 8]
    return jnp.asarray(np.asarray(value).astype(signed)).astype(dtype)


def add_plaintext(ct, pt):
    """Add a plaintext to the body only."""
    return ct.at[..., -1].add(jnp.asarray(pt, dtype=ct.dtype))


def sub_plaintext(ct, pt):
    return ct.at[..., -1].add(jnp.zeros_like(ct[..., -1]) - jnp.asarray(pt, dtype=ct.dtype))


def scalar_mul(ct, cleartext):
    """Multiply every coefficient by a small (possibly negative) integer
    cleartext."""
    return ct * _as_torus(cleartext, ct.dtype)


def affine_transform(cts, weights, bias):
    """Weighted sum of a ciphertext vector + plaintext bias.

    cts: [..., m, n+1]; weights: [m] signed ints; bias: plaintext scalar.
    Mirrors lwe_ciphertext_vector_discarding_affine_transformation.
    """
    w = _as_torus(weights, cts.dtype)
    out = (cts * w[..., :, None]).sum(axis=-2, dtype=cts.dtype)
    return add_plaintext(out, bias)


# ---------------------------------------------------------------------------
# keyswitching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LweKeyswitchKey:
    """Keyswitch key: [n_in, l, n_out+1] LWE rows encrypting s_i * q/B^j.

    Reference: crypto/lwe/keyswitch.rs:36 (layout: per input key bit, `level`
    ciphertexts of the decomposition ladder, level 1 first).
    """

    data: np.ndarray  # [n_in, l, n_out + 1]
    base_log: int
    level_count: int
    bits: int

    @classmethod
    def generate(
        cls,
        in_key: LweSecretKey,
        out_key: LweSecretKey,
        base_log: int,
        level_count: int,
        std: float,
        gen: EncryptionRandomGenerator,
    ) -> "LweKeyswitchKey":
        """fill_with_keyswitch_key (keyswitch.rs:331-385): for each input key
        coefficient, encrypt the plaintext ladder bit * q/B^level, level=1..l,
        sequentially with the shared generator (no forking)."""
        bits = in_key.bits
        dt = UNSIGNED[bits]
        n_in, l = in_key.dimension, level_count
        ladder_shifts = np.array(
            [bits - base_log * (lev + 1) for lev in range(l)], dtype=np.uint64
        )
        messages = (
            in_key.key.astype(dt)[:, None] << ladder_shifts[None, :].astype(dt)
        )  # [n_in, l]
        data = out_key.encrypt(messages, std, gen)
        return cls(data=data, base_log=base_log, level_count=l, bits=bits)


def _ks_digits(ct, base_log: int, level_count: int):
    """Rounded small-sign decomposition of the mask, flattened to
    [..., n_in*l] signed digits, plus the body."""
    mask = ct[..., :-1]
    body = ct[..., -1]
    rounded = decomposition.closest_representable(mask, base_log, level_count)
    digits = decomposition.small_sign_decompose(rounded, base_log, level_count)
    lead = digits.shape[:-2]
    return digits.reshape(lead + (-1,)), body


def keyswitch(ksk_data, ct, *, base_log: int, level_count: int):
    """Switch a batch of ciphertexts to the output key — jittable.

    ct: [..., n_in+1] -> [..., n_out+1]. Algorithm (keyswitch.rs:514-560):
    output body = input body; for each input mask element, round to the
    decomposition lattice, small-sign-decompose, and subtract digit *
    ksk[i, level] rows. The contraction over (n_in, l) runs as a single
    integer matmul (wrapping two's-complement accumulation == mod q).

    The same contraction also runs on int8 byte limb planes: see
    ksk_to_limbs / keyswitch_limbs — bit-identical.
    """
    from . import checks

    checks.check_keyswitch_key(
        ksk_data, ct.shape[-1] - 1, level_count, ksk_data.shape[-1] - 1)
    bits = jnp.dtype(ct.dtype).itemsize * 8
    sdt = _JNP_SIGNED[bits]
    flat, body = _ks_digits(ct, base_log, level_count)
    n_rows = flat.shape[-1]
    kflat = jax.lax.bitcast_convert_type(ksk_data, sdt).reshape(n_rows, -1)
    acc = jax.lax.dot_general(
        flat,
        kflat,
        (((flat.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=sdt,
    )
    out = jax.lax.bitcast_convert_type(jnp.zeros_like(acc) - acc, ct.dtype)
    return out.at[..., -1].add(body)


def ksk_to_limbs(ksk_data) -> np.ndarray:
    """Prepare a keyswitch key for the limb-plane contraction:
    [n_in, l, n_out+1] u32/u64 -> int8 [n_in*l, n_limbs*(n_out+1)],
    columns m-major (limb plane m contiguous).

    Entries are *balanced* signed-byte limbs (sum_m c_m 2^{8m} == v mod 2^q),
    computed once per key on the host — the same decomposition the MXU
    bootstrap uses (core/bootstrap_mxu._limb_pack)."""
    from .bootstrap_mxu import _limb_pack

    k = np.asarray(ksk_data)
    bits = k.dtype.itemsize * 8
    n_limbs = bits // 8
    packed = _limb_pack(k.reshape(-1))                   # carries applied
    limbs = np.stack(
        [((packed >> k.dtype.type(8 * m)) & k.dtype.type(0xFF)).astype(np.int8)
         for m in range(n_limbs)],
        axis=0,
    )  # [n_limbs, n_in*l*(n_out+1)]
    n_in, l, out_sz = k.shape
    limbs = limbs.reshape(n_limbs, n_in * l, out_sz)
    return np.moveaxis(limbs, 0, 1).reshape(n_in * l, n_limbs * out_sz)


def keyswitch_limbs(ksk8, ct, *, base_log: int, level_count: int):
    """Keyswitch against a limb-prepared key (ksk_to_limbs): one int8 dot
    + wrapping recombination, exact mod 2^q and bit-identical to
    `keyswitch`. Digits must fit int8 (base_log <= 7)."""
    assert base_log <= 7, "limb keyswitch needs int8 digits (base_log <= 7)"
    # int8 x int8 -> int32 dot: worst-case |sum| = K * 64 * 128 must stay exact
    assert ksk8.shape[0] * 8192 < 2 ** 31, (
        "int32 accumulation bound exceeded; use the plain keyswitch")
    bits = jnp.dtype(ct.dtype).itemsize * 8
    n_limbs = bits // 8
    out_sz = ksk8.shape[-1] // n_limbs
    flat, body = _ks_digits(ct, base_log, level_count)
    neg = (-flat).astype(jnp.int8)                       # fold the subtraction in
    s = jax.lax.dot_general(
        neg,
        ksk8,
        (((neg.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )                                                    # [..., n_limbs*out_sz]
    acc_t = _JNP_SIGNED[bits]
    out = s[..., :out_sz].astype(acc_t)
    for m in range(1, n_limbs):
        out = out + (s[..., m * out_sz:(m + 1) * out_sz].astype(acc_t)
                     << acc_t(8 * m))                    # wrapping mod 2^q
    out = jax.lax.bitcast_convert_type(out, ct.dtype)
    return out.at[..., -1].add(body)


def keyswitch_any(ksk, ct, *, base_log: int, level_count: int):
    """`keyswitch_limbs` for an int8 limb-prepared key (ksk_to_limbs),
    `keyswitch` for the plain u32/u64 key tensor."""
    if ksk.dtype == jnp.int8:
        return keyswitch_limbs(ksk, ct, base_log=base_log,
                               level_count=level_count)
    return keyswitch(ksk, ct, base_log=base_log, level_count=level_count)
