"""u32 modular arithmetic for NTT-friendly primes.

A 32x32->64 multiply is built from 16-bit halves (`mul32_hilo`) and
Montgomery reduction sits on top of it, so the entire NTT runs in uint32
lanes.
This replaces the reference's FFTW f64 path (concrete-core .../math/fft/) with
*exact* arithmetic.

All functions are jittable and work on arrays of any shape.

Example:
    >>> import numpy as np
    >>> from concrete_tpu.math.mod_arith import MontgomeryContext
    >>> ctx = MontgomeryContext.new(12289)
    >>> int(ctx.from_mont(ctx.mont_mul(ctx.to_mont(np.uint32(5)), ctx.to_mont(np.uint32(7)))))
    35
    >>> ctx.pow_mod_host(ctx.root_of_unity(16), 16)
    1
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
_MASK16 = np.uint32(0xFFFF)


def mul32_hilo(a, b):
    """Full 32x32 -> (hi, lo) uint32 product via 16-bit limbs."""
    a = a.astype(U32)
    b = b.astype(U32)
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    ll = a0 * b0
    t1 = a1 * b0 + (ll >> 16)          # <= (2^16-1)^2 + 2^16 - 1 < 2^32
    t2 = a0 * b1 + (t1 & _MASK16)      # same bound
    hi = a1 * b1 + (t1 >> 16) + (t2 >> 16)
    lo = (ll & _MASK16) | (t2 << 16)
    return hi, lo


def _pow_mod(base: int, exp: int, p: int) -> int:
    return pow(base, exp, p)


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e14."""
    if n < 2:
        return False
    for sp in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % sp == 0:
            return n == sp
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _find_generator(p: int) -> int:
    """Smallest generator of Z_p^* (p prime)."""
    factors = []
    m = p - 1
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise RuntimeError("no generator found")


@dataclasses.dataclass(frozen=True)
class MontgomeryContext:
    """Montgomery arithmetic mod a prime p < 2^31 with R = 2^32."""

    p: int
    n_prime: int  # -p^{-1} mod 2^32
    r1: int       # R mod p   (Montgomery form of 1)
    r2: int       # R^2 mod p (to_mont multiplier)

    @classmethod
    def new(cls, p: int) -> "MontgomeryContext":
        assert p < (1 << 31) and p % 2 == 1 and _is_prime(p), p
        p_inv = pow(p, -1, 1 << 32)
        return cls(
            p=p,
            n_prime=(-p_inv) % (1 << 32),
            r1=(1 << 32) % p,
            r2=(1 << 64) % p,
        )

    # -- jittable ops -----------------------------------------------------

    def mont_mul(self, a, b):
        """REDC(a*b): returns a*b*R^{-1} mod p, inputs/outputs in [0, p)."""
        hi, lo = mul32_hilo(a, b)
        m = lo * np.uint32(self.n_prime)
        mhi, _ = mul32_hilo(m, np.uint32(self.p))
        carry = (lo != 0).astype(U32)
        t = hi + mhi + carry  # < 2p < 2^32
        return jnp.where(t >= np.uint32(self.p), t - np.uint32(self.p), t)

    def to_mont(self, a):
        return self.mont_mul(a, jnp.full((), self.r2, U32))

    def from_mont(self, a):
        return self.mont_mul(a, jnp.full((), 1, U32))

    def add(self, a, b):
        s = a + b  # < 2p < 2^32
        return jnp.where(s >= np.uint32(self.p), s - np.uint32(self.p), s)

    def sub(self, a, b):
        return jnp.where(a >= b, a - b, a + (np.uint32(self.p) - b))

    def neg(self, a):
        return jnp.where(a == 0, a, np.uint32(self.p) - a)

    # -- host-side helpers --------------------------------------------------

    def pow_mod_host(self, base: int, exp: int) -> int:
        return _pow_mod(base % self.p, exp, self.p)

    def root_of_unity(self, order: int) -> int:
        """A primitive order-th root of unity mod p (order | p-1)."""
        assert (self.p - 1) % order == 0, (self.p, order)
        g = _find_generator(self.p)
        psi = pow(g, (self.p - 1) // order, self.p)
        assert pow(psi, order // 2, self.p) == self.p - 1
        return psi
