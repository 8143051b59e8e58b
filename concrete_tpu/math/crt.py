"""CRT residue decomposition / reconstruction for exact torus convolutions.

The negacyclic product of a signed-digit polynomial (|digit| <= B/2) with a
torus polynomial (coefficients centered in [-q/2, q/2)) has integer
coefficients bounded by V = N * n_polys * (B/2) * q/2. We compute it modulo a
set of NTT primes whose product M > 2V, reconstruct the signed integer by
Garner's algorithm in mixed radix, and reduce mod q = 2^bits. This replaces
the reference's f64 FFT rounding (fft/transform.rs) with exact arithmetic.

Example:
    >>> import numpy as np
    >>> from concrete_tpu.math.crt import CrtContext, select_primes
    >>> primes = select_primes(2 ** 40)
    >>> ctx = CrtContext.new(primes, 32)
    >>> res = ctx.residues_from_torus(np.uint32(123456789))
    >>> int(np.asarray(ctx.combine_to_torus(res)))
    123456789
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .ntt import DEFAULT_PRIMES

U64 = jnp.uint64
I64 = jnp.int64


def select_primes(bound: int, candidates=DEFAULT_PRIMES) -> tuple[int, ...]:
    """Smallest prefix of `candidates` with product > 2 * bound (with margin)."""
    prod = 1
    out = []
    for p in candidates:
        out.append(p)
        prod *= p
        if prod > 4 * bound:  # x2 for sign, x2 safety margin
            return tuple(out)
    raise ValueError(f"prime pool too small for bound {bound}")


def external_product_bound(n: int, n_polys: int, base: int, bits: int) -> int:
    """Max |coefficient| of the accumulated decomposed-GLWE x GGSW convolution.

    n_polys = level_count * glwe_size polynomial products are accumulated;
    digits are in [-B/2, B/2], torus values centered in [-q/2, q/2).
    """
    return n * n_polys * (base // 2) * (1 << (bits - 1))


@dataclasses.dataclass(frozen=True)
class CrtContext:
    """Garner reconstruction constants for a prime set and torus width."""

    primes: tuple[int, ...]
    bits: int
    garner_inv: tuple[tuple[int, ...], ...]  # inv(P_{i-1} mod p_i) etc, see below
    prefix_mod_pi: tuple[tuple[int, ...], ...]  # (p_1..p_{j-1}) mod p_i for j<=i
    prefix_mod_q: tuple[int, ...]  # (p_1..p_{i-1}) mod 2^bits
    half_digits: tuple[int, ...]  # mixed-radix digits of ceil(M/2)
    m_mod_q: int  # M mod 2^bits

    @classmethod
    @functools.lru_cache(maxsize=None)
    def new(cls, primes: tuple[int, ...], bits: int) -> "CrtContext":
        k = len(primes)
        M = 1
        for p in primes:
            M *= p
        q = 1 << bits
        # Garner: x_i = (r_i - (x_1 + p_1 x_2 + ... )) * inv(p_1..p_{i-1}) mod p_i
        garner_inv = []
        prefix_mod_pi = []
        for i in range(k):
            pref = 1
            mods = []
            for j in range(i):
                mods.append(pref % primes[i])
                pref *= primes[j]
            prefix_mod_pi.append(tuple(mods))
            garner_inv.append(pow(pref % primes[i], -1, primes[i]) if i else 1)
        prefix_mod_q = []
        pref = 1
        for i in range(k):
            prefix_mod_q.append(pref % q)
            pref *= primes[i]
        # mixed-radix digits of T = ceil(M/2): v >= T  <=>  v - M/2 >= 0
        T = (M + 1) // 2
        half_digits = []
        t = T
        for p in primes:
            half_digits.append(t % p)
            t //= p
        return cls(
            primes=primes,
            bits=bits,
            garner_inv=tuple(garner_inv),
            prefix_mod_pi=tuple(prefix_mod_pi),
            prefix_mod_q=tuple(prefix_mod_q),
            half_digits=tuple(half_digits),
            m_mod_q=M % q,
        )

    # -- residue generation -------------------------------------------------

    def residues_from_torus(self, x) -> list:
        """Residues of torus values interpreted as centered signed ints.

        x: uint32/uint64 [...] -> list of P uint32 arrays in [0, p_i).
        Centering halves the convolution bound vs an unsigned interpretation.
        """
        signed_dtype = jnp.int32 if self.bits == 32 else jnp.int64
        s = jax.lax.bitcast_convert_type(x, signed_dtype).astype(I64)
        return [(s % np.int64(p)).astype(jnp.uint32) for p in self.primes]

    def residues_from_signed(self, d) -> list:
        """Residues of small signed integers (decomposition digits)."""
        s = d.astype(I64)
        return [(s % np.int64(p)).astype(jnp.uint32) for p in self.primes]

    # -- reconstruction -------------------------------------------------------

    def combine_to_torus(self, residues: list):
        """Garner-reconstruct the signed value mod 2^bits — u32-first.

        residues: list of P uint32 arrays (plain, NOT Montgomery) -> torus
        uint32/uint64 array. The Garner digit recurrences run entirely in
        u32 Montgomery lanes; only the final digit-weighted sum widens
        to u64 when bits == 64.
        """
        from .mod_arith import MontgomeryContext

        k = len(self.primes)
        xs = [residues[0]]  # mixed-radix digits, u32, x_i < p_i
        for i in range(1, k):
            ctx = MontgomeryContext.new(self.primes[i])
            r = (1 << 32) % self.primes[i]
            # t = sum_j prefix_j * x_j mod p_i (Montgomery constants fold R)
            t = None
            for j in range(i):
                cj = np.uint32(self.prefix_mod_pi[i][j] * r % self.primes[i])
                term = ctx.mont_mul(xs[j], jnp.full((), cj, jnp.uint32))
                t = term if t is None else ctx.add(t, term)
            diff = ctx.sub(residues[i], t)
            ci = np.uint32(self.garner_inv[i] * r % self.primes[i])
            xs.append(ctx.mont_mul(diff, jnp.full((), ci, jnp.uint32)))
        # v >= ceil(M/2)? lexicographic compare of mixed-radix digits,
        # folded from the least significant digit up (pure u32 compares).
        ge = xs[0] >= np.uint32(self.half_digits[0])
        for i in range(1, k):
            ti = np.uint32(self.half_digits[i])
            ge = (xs[i] > ti) | ((xs[i] == ti) & ge)
        if self.bits == 32:
            v = jnp.zeros_like(xs[0])
            for i in range(k):
                v = v + np.uint32(self.prefix_mod_q[i] & 0xFFFFFFFF) * xs[i]
            return v - jnp.where(ge, np.uint32(self.m_mod_q & 0xFFFFFFFF), np.uint32(0))
        v = jnp.zeros(xs[0].shape, dtype=U64)
        for i in range(k):
            v = v + np.uint64(self.prefix_mod_q[i]) * xs[i].astype(U64)
        return v - jnp.where(ge, np.uint64(self.m_mod_q), np.uint64(0))
