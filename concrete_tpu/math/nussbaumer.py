"""Nussbaumer polynomial transform: negacyclic convolution of size N = L*M
as 2L exact M-point negacyclic products, with rotation-only transforms.

The ring isomorphism (strided chunking, Y = X, Z = X^L):

    Z[X]/(X^N + 1)  ~=  R_M[Y] / (Y^L - Z),   R_M = Z[Z]/(Z^M + 1)

where chunk i of a polynomial a is a_i(Z) = sum_j a[jL + i] Z^j. Chunk
products reduce mod Z^M + 1 — the TRUE relation (Z^M = X^N = -1) — so no
degree-overflow bookkeeping exists. Y^L - Z has no roots expressible as
powers of Z (L, 2M share the factor 2), so the product mod (Y^L - Z) is
computed EXACTLY as the linear convolution of the zero-padded chunk
sequences via a CYCLIC 2L-point polynomial transform with root

    omega = Z^(M/L)        (a primitive 2L-th root of unity in R_M),

then folded: c_t <- c_t + Z * c_{t+L}. Every multiplication by a power of
omega is a negacyclic monomial rotation — selects and rolls, ZERO modular
multiplies. The inverse transform divides by 2L; over Z_{2^w} (w even) that
division does not exist, so all arithmetic is carried mod 2^{w + log2(2L)}
and the final result (known to be 2L * true) is right-shifted.

Why this exists (no reference analog): the int8 toeplitz external
product (core/bootstrap_mxu.py) is an O(N^2) toeplitz matmul whose RHS
grows to gigabytes past N=4096. In the Nussbaumer domain the same product
is 2L INDEPENDENT M-point toeplitz matmuls — O(N^2 / L) MACs and O(N^2/L)
table bytes — putting N = 8192 and 16384 on the int8 matmul path (the
reference supports N <= 16384, concrete-core fft/mod.rs:28). Exactness is
preserved end to end: the composition is bit-identical to the direct
toeplitz path (tests/test_nussbaumer.py).

Reference for the algorithm family: H. Nussbaumer, "Fast polynomial
transform algorithms for digital convolution" (1980) — public literature,
reimplemented from the ring identity above.

Example (transform round-trip is the identity):
    >>> import numpy as np
    >>> from concrete_tpu.math import nussbaumer as nb
    >>> x = np.arange(16, dtype=np.uint32)
    >>> chunks = nb.chunk(x, 4)                    # [2L=8, M=4], zero-padded
    >>> fwd = nb.forward(chunks, 4)
    >>> back = nb.inverse_raw(fwd, 4)              # 2L * chunks, pre-fold
    >>> bool((back[:4] == chunks[:4] * 8).all())
    True
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _xp(x):
    """numpy for host arrays (key prep), jnp for traced/device ones."""
    return np if isinstance(x, np.ndarray) else jnp


def pick_l(n: int, max_m: int = 1024, min_m: int = 128) -> int:
    """Largest power-of-two L with M = N/L in [min_m, max_m] and L <= M
    (the 2L-th root Z^(M/L) needs L | M). Returns 1 when N <= min_m."""
    l = 1
    while n // (2 * l) >= min_m and 2 * l <= n // (2 * l):
        l *= 2
    while n // l > max_m and l < n // l:
        l *= 2
    return l


def chunk(x, l: int):
    """[..., N] -> [..., 2L, M] strided chunks, zero-padded to 2L:
    out[..., i, j] = x[..., j*L + i] for i < L, 0 for i >= L."""
    xp = _xp(x)
    n = x.shape[-1]
    m = n // l
    xr = x.reshape(x.shape[:-1] + (m, l))               # [.., j, i]
    xr = xp.swapaxes(xr, -1, -2)                        # [.., i, j]
    pad = xp.zeros_like(xr)
    return xp.concatenate([xr, pad], axis=-2)           # [.., 2L, M]


def unchunk(c, l: int):
    """Inverse of chunk on the first L chunks: [..., L, M] -> [..., N]."""
    xp = _xp(c)
    xr = xp.swapaxes(c, -1, -2)                         # [.., j, i]
    return xr.reshape(c.shape[:-2] + (c.shape[-1] * l,))


def _neg_roll_static(x, shift: int):
    """x * Z^shift in R_M = Z[Z]/(Z^M+1), static shift (any sign), on the
    last axis. Pure slice+concat."""
    xp = _xp(x)
    m = x.shape[-1]
    shift = shift % (2 * m)
    neg = shift >= m
    shift = shift % m
    if shift:
        lo = x[..., m - shift:]
        hi = x[..., : m - shift]
        x = xp.concatenate([xp.zeros_like(lo) - lo, hi], axis=-1)
    return (xp.zeros_like(x) - x) if neg else x


def forward(c, l: int):
    """Cyclic 2L-point polynomial transform (decimation-in-frequency,
    bit-reversed output) of chunk sequences c [..., 2L, M]: every twiddle
    is omega^j = Z^(j*M/L) — a negacyclic rotation, no multiplies.

    Works on any integer dtype: wrapping adds == arithmetic mod 2^w.
    """
    two_l = c.shape[-2]
    assert two_l == 2 * l
    m = c.shape[-1]
    root = m // l                  # omega = Z^root, omega^(2L) = Z^(2M) = 1
    stages = two_l.bit_length() - 1
    xp = _xp(c)
    x = c
    for s in range(stages):
        half = two_l >> (s + 1)
        xr = x.reshape(x.shape[:-2] + (1 << s, 2 * half, m))
        a = xr[..., :half, :]
        b = xr[..., half:, :]
        lo = a + b
        diff = a - b
        # twiddle omega^(j * 2^s) on element j of the high half
        hi = xp.stack(
            [_neg_roll_static(diff[..., j, :], root * j * (1 << s))
             for j in range(half)],
            axis=-2)
        x = xp.stack([lo, hi], axis=-3).reshape(
            x.shape[:-2] + (two_l, m))
    return x  # bit-reversed frequency order


def inverse_raw(f, l: int):
    """Inverse transform WITHOUT the 1/(2L) scaling: consumes bit-reversed
    spectra [..., 2L, M], returns 2L * chunks in natural order."""
    two_l = f.shape[-2]
    assert two_l == 2 * l
    m = f.shape[-1]
    root = m // l
    stages = two_l.bit_length() - 1
    xp = _xp(f)
    x = f
    for s in reversed(range(stages)):
        half = two_l >> (s + 1)
        xr = x.reshape(x.shape[:-2] + (1 << s, 2, half, m))
        u = xr[..., 0, :, :]
        v_in = xr[..., 1, :, :]
        v = xp.stack(
            [_neg_roll_static(v_in[..., j, :], -root * j * (1 << s))
             for j in range(half)],
            axis=-2)
        x = xp.concatenate([u + v, u - v], axis=-2).reshape(
            x.shape[:-2] + (two_l, m))
    return x


def fold(c2l, l: int):
    """Reduce the exact 2L-term chunk convolution mod (Y^L - Z):
    out_t = c_t + Z * c_{t+L}, t in [0, L). [..., 2L, M] -> [..., L, M]."""
    low = c2l[..., :l, :]
    high = _neg_roll_static(c2l[..., l:, :], 1)
    return low + high


def monomial_mul_chunked(c, degree, l: int):
    """c * X^degree on CHUNK-MAJOR data c [..., L, M] (the chunk(x, l)
    layout without the zero padding), degree an int32 array broadcastable
    against the leading axes. Standard coefficient n = j*L + i lives at
    chunk i position j; X^(2^b) maps (i, j) -> (i + r mod L, j + q + carry)
    with 2^b = q*L + r and the Z^M = -1 wrap negating — i.e. a chunk-axis
    roll whose wrapped chunks get one extra negacyclic Z-roll. Barrel form:
    log2(2N) static stages gated by the degree bits, exactly like
    polynomial.negacyclic_monomial_mul but never leaving the chunk layout.
    """
    xp = _xp(c)
    m = c.shape[-1]
    n = l * m
    deg = degree % (2 * n)
    if xp is jnp:
        deg = jnp.asarray(deg, dtype=jnp.int32)
    lead_shape = xp.broadcast_shapes(c.shape[:-2], deg.shape)
    x = xp.broadcast_to(c, lead_shape + (l, m))
    deg = xp.broadcast_to(deg, lead_shape)[..., None, None]
    nbits = (2 * n - 1).bit_length()
    for bit in range(nbits):
        s = (1 << bit) % (2 * n)
        q, r = divmod(s, l)
        if r == 0:
            rolled = _neg_roll_static(x, q)
        else:
            # chunks L-r..L-1 wrap to the front with an extra Z step
            hi = _neg_roll_static(x[..., l - r:, :], q + 1)
            lo = _neg_roll_static(x[..., : l - r, :], q)
            rolled = xp.concatenate([hi, lo], axis=-2)
        take = (deg >> bit) & 1
        x = xp.where(take == 1, rolled, x)
    return x


def negacyclic_polymul_nuss(a, b, l: int, mulm):
    """Exact a*b mod (X^N+1, 2^w) through the Nussbaumer domain — the
    reference composition used by the tests. `mulm(x, y)` must compute the
    exact negacyclic M-point product of the trailing axes (broadcasting on
    the leading chunk axis). Inputs u32/u64; all arithmetic runs in the
    SAME dtype, exact because w + log2(2L) <= dtype bits is NOT required —
    the 2L scale is removed by the shift only on the low w bits, so the
    caller must pass values pre-reduced mod 2^(w - log2(2L)) OR accept the
    result mod 2^(bits - log2(2L)). See tests for the exact contract."""
    fa = forward(chunk(a, l), l)
    fb = forward(chunk(b, l), l)
    prod = mulm(fa, fb)
    c = fold(inverse_raw(prod, l), l)
    shift = (2 * l).bit_length() - 1
    return unchunk(c >> np.uint32(shift) if c.dtype == jnp.uint32
                   else c >> np.uint64(shift), l)
