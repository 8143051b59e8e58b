"""Negacyclic polynomial operations on the torus (mod X^N + 1, mod 2^bits).

Monomial rotations mirror the reference's
update_with_wrapping_monic_monomial_mul / _unit_monomial_div
(math/polynomial/polynomial.rs:685-744): rotating wraps coefficients around
with a sign flip. Degrees may be traced per-batch values (each lane of a
batched blind rotation rotates by its own amount), implemented as a branchless
gather over the 2N-periodic index space.

Exact wrapping products against small (binary/ternary) polynomials go through
the prime NTT + CRT (used by host-side GLWE encryption).

Example (multiply by X: negacyclic wrap negates):
    >>> import numpy as np
    >>> from concrete_tpu.math.polynomial import negacyclic_monomial_mul
    >>> poly = np.arange(4, dtype=np.uint32)
    >>> np.asarray(negacyclic_monomial_mul(poly, np.uint32(1))).tolist()
    [4294967293, 0, 1, 2]

Division is the inverse rotation, and degree N negates (X^N == -1):
    >>> from concrete_tpu.math.polynomial import negacyclic_monomial_div
    >>> rot = negacyclic_monomial_mul(poly, np.uint32(1))
    >>> np.asarray(negacyclic_monomial_div(rot, np.uint32(1))).tolist()
    [0, 1, 2, 3]
    >>> np.asarray(negacyclic_monomial_mul(poly, np.uint32(4))).tolist()
    [0, 4294967295, 4294967294, 4294967293]
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import crt, ntt


def _negacyclic_static_roll(poly, shift: int):
    """poly * X^shift for a STATIC shift in [0, N): rotate right, wrapped
    coefficients negated. Compiles to slices+concat."""
    n = poly.shape[-1]
    shift = shift % (2 * n)
    neg = shift >= n
    shift = shift % n
    zero = np.array(0, dtype=poly.dtype)
    if shift:
        top = poly[..., n - shift :]
        rest = poly[..., : n - shift]
        out = jnp.concatenate([zero - top, rest], axis=-1)
    else:
        out = poly
    return (zero - out) if neg else out


def negacyclic_monomial_mul(poly, degree):
    """poly * X^degree mod (X^N+1), wrapping coefficients with sign flip.

    poly: [..., N] unsigned torus; degree: int or [...] integer array
    (interpreted mod 2N). Matches polynomial.rs:685-707.

    Implemented as a branchless barrel rotation — log2(2N) static rolls
    gated by the degree bits: pure shifts/selects, no gather.
    """
    n = poly.shape[-1]
    degree = jnp.asarray(degree, dtype=jnp.int32) % (2 * n)
    lead = jnp.broadcast_shapes(poly.shape[:-1], degree.shape)
    x = jnp.broadcast_to(poly, lead + (n,))
    degree = jnp.broadcast_to(degree, lead)[..., None]
    nbits = (2 * n - 1).bit_length()
    for j in range(nbits):
        bit = (degree >> j) & 1
        rolled = _negacyclic_static_roll(x, 1 << j)
        x = jnp.where(bit == 1, rolled, x)
    return x


def negacyclic_monomial_div(poly, degree):
    """poly * X^{-degree} mod (X^N+1) (polynomial.rs:709-744)."""
    n = poly.shape[-1]
    degree = jnp.asarray(degree, dtype=jnp.int32) % (2 * n)
    return negacyclic_monomial_mul(poly, 2 * n - degree)


def polymul_wrapping_naive(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Schoolbook negacyclic product mod 2^bits — numpy test oracle
    (polynomial.rs:271 fill_with_wrapping_mul)."""
    n = a.shape[-1]
    out = np.zeros_like(a)
    for i in range(n):
        for j in range(n):
            d = i + j
            if d < n:
                out[..., d] += a[..., i] * b[..., j]
            else:
                out[..., d - n] -= a[..., i] * b[..., j]
    return out


def multisum_negacyclic(torus_polys, small_polys, bits: int, small_max: int = 1):
    """sum_j torus_polys[..., j, :] * small_polys[j, :] mod (X^N+1, 2^bits).

    torus_polys: [..., k, N] unsigned torus; small_polys: [k, N] values of
    centered magnitude <= small_max (1 for binary/ternary keys; 2^(bits-1)
    for gaussian/uniform keys). Exact wrapping result via prime NTT + CRT —
    the CRT bound scales with small_max, so full-range keys stay exact
    (update_with_wrapping_add_multisum, secret/glwe.rs:488-545).
    """
    k, n = small_polys.shape[-2], small_polys.shape[-1]
    bound = k * n * int(small_max) * (1 << (bits - 1))
    primes = crt.select_primes(bound)
    cc = crt.CrtContext.new(primes, bits)
    t_res = cc.residues_from_torus(torus_polys)   # list of [..., k, N] u32
    sp = jnp.asarray(small_polys)
    if sp.dtype in (jnp.dtype(jnp.uint32), jnp.dtype(jnp.uint64)):
        # wrapped-unsigned small values (e.g. ternary -1 stored as q-1)
        import jax

        sp = jax.lax.bitcast_convert_type(
            sp, jnp.int32 if sp.dtype == jnp.dtype(jnp.uint32) else jnp.int64
        )
    s_res = cc.residues_from_signed(sp)
    out_res = []
    for pi, p in enumerate(primes):
        plan = ntt.make_plan(n, p)
        ts = ntt.forward(plan, t_res[pi])
        ss = ntt.forward(plan, s_res[pi])
        prod = plan.ctx.mont_mul(ts, ss)  # [..., k, N]
        acc = prod[..., 0, :]
        for j in range(1, k):
            acc = plan.ctx.add(acc, prod[..., j, :])
        out_res.append(ntt.inverse(plan, acc))
    return cc.combine_to_torus(out_res)


def _negacyclic_static_roll_bl(poly, shift: int):
    """Batch-last variant: poly [..., N, B], rotate the N (sublane) axis."""
    n = poly.shape[-2]
    shift = shift % (2 * n)
    neg = shift >= n
    shift = shift % n
    zero = np.array(0, dtype=poly.dtype)
    if shift:
        top = poly[..., n - shift :, :]
        rest = poly[..., : n - shift, :]
        out = jnp.concatenate([zero - top, rest], axis=-2)
    else:
        out = poly
    return (zero - out) if neg else out


def negacyclic_monomial_mul_bl(poly, degree):
    """Batch-last barrel rotation: poly [..., N, B] * X^degree with degree
    broadcastable against poly.shape[:-2] + (B,). Static sublane slices keep
    the wide batch axis in lanes throughout."""
    n = poly.shape[-2]
    degree = jnp.asarray(degree, dtype=jnp.int32) % (2 * n)
    x = poly
    nbits = (2 * n - 1).bit_length()
    for j in range(nbits):
        bit = (degree >> j) & 1
        rolled = _negacyclic_static_roll_bl(x, 1 << j)
        x = jnp.where(bit[..., None, :] == 1, rolled, x)
    return x


def negacyclic_monomial_div_bl(poly, degree):
    n = poly.shape[-2]
    degree = jnp.asarray(degree, dtype=jnp.int32) % (2 * n)
    return negacyclic_monomial_mul_bl(poly, 2 * n - degree)
