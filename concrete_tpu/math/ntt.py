"""Exact negacyclic NTT over Z_q[X]/(X^N+1) — THE kernel of the framework.

Replaces the reference's FFTW f64 complex FFT (concrete-core .../math/fft/,
plan.rs, transform.rs) with an exact number-theoretic transform over one or
more NTT-friendly primes p < 2^31 (u32 Montgomery lanes), combined by CRT
(`concrete_tpu.math.crt`). Exactness means external products carry *no* FFT
rounding noise — cleaner than the reference's f64 path and strictly within the
NPE noise envelopes used as the conformance oracle.

Layout: a polynomial is the trailing [N] axis; transforms vectorize over any
leading batch axes. The negacyclic twist (psi^i pre-scale / psi^-i post-scale,
psi a primitive 2N-th root) is folded into the Montgomery conversions, so
forward = 1 multiply + log2(N) butterfly stages, inverse likewise with N^{-1}
folded into the untwist.

The transform is a Stockham-style decimation-in-frequency: natural order in,
bit-reversed order out; the inverse consumes bit-reversed input, so pointwise
products never need an explicit bit-reversal pass.

Example (X * X^7 == -1 mod X^8 + 1):
    >>> import numpy as np
    >>> from concrete_tpu.math.ntt import make_plan, negacyclic_polymul_mod_p
    >>> plan = make_plan(8, 97)
    >>> a = np.zeros(8, np.uint32); a[1] = 1
    >>> b = np.zeros(8, np.uint32); b[7] = 1
    >>> np.asarray(negacyclic_polymul_mod_p(plan, a, b)).tolist()
    [96, 0, 0, 0, 0, 0, 0, 0]
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from .mod_arith import MontgomeryContext, U32

# NTT-friendly primes < 2^31 with high 2-adicity, largest first.
# (p - 1) factorizations: 2013265921 = 15*2^27+1, 1811939329 = 27*2^26+1,
# 2113929217 = 63*2^25+1, 469762049 = 7*2^26+1.
DEFAULT_PRIMES = (2013265921, 1811939329, 2113929217, 469762049)


@dataclasses.dataclass(frozen=True)
class NttPlan:
    """Per-(N, p) transform plan: Montgomery context + twiddle tables."""

    n: int
    ctx: MontgomeryContext
    twist_fwd: np.ndarray     # [N]  psi^i * R^2 mod p  (to_mont + twist fused)
    untwist_inv: np.ndarray   # [N]  psi^-i * N^-1 mod p (from_mont + untwist + 1/N fused)
    w_fwd: tuple              # per stage s: [N >> (s+1)] omega^(j*N/L) * R mod p
    w_inv: tuple              # per stage s: inverse twiddles, Montgomery form


@functools.lru_cache(maxsize=None)
def make_plan(n: int, p: int) -> NttPlan:
    ctx = MontgomeryContext.new(p)
    psi = ctx.root_of_unity(2 * n)
    psi_inv = pow(psi, -1, p)
    omega = psi * psi % p
    omega_inv = pow(omega, -1, p)
    n_inv = pow(n, -1, p)
    r = (1 << 32) % p
    r2 = (1 << 64) % p

    twist_fwd = np.array(
        [pow(psi, int(i), p) * r2 % p for i in range(n)], dtype=np.uint32
    )
    untwist_inv = np.array(
        [pow(psi_inv, int(i), p) * n_inv % p for i in range(n)], dtype=np.uint32
    )
    log2n = n.bit_length() - 1
    w_fwd, w_inv = [], []
    for s in range(log2n):
        L = n >> s
        m = L // 2
        wf = pow(omega, n // L, p)
        wi = pow(omega_inv, n // L, p)
        w_fwd.append(
            np.array([pow(wf, j, p) * r % p for j in range(m)], dtype=np.uint32)
        )
        w_inv.append(
            np.array([pow(wi, j, p) * r % p for j in range(m)], dtype=np.uint32)
        )
    return NttPlan(
        n=n,
        ctx=ctx,
        twist_fwd=twist_fwd,
        untwist_inv=untwist_inv,
        w_fwd=tuple(w_fwd),
        w_inv=tuple(w_inv),
    )


class _StackedMontOps:
    """Broadcast Montgomery arithmetic shared by every stacked-plan flavour —
    one definition so the roll and reshape paths cannot diverge (they are
    required to be bit-identical)."""

    def _bc(self, arr, x):
        """Reshape a [P, ...] constant to broadcast against x = [P, ..., N]."""
        a = jnp.asarray(arr)
        return a.reshape(a.shape[:1] + (1,) * (x.ndim - a.ndim) + a.shape[1:])

    def mont_mul(self, x, y):
        from .mod_arith import mul32_hilo

        p = self._bc(self.p, x)
        npr = self._bc(self.n_prime, x)
        hi, lo = mul32_hilo(x, y)
        m = lo * npr
        mhi, _ = mul32_hilo(m, p)
        t = hi + mhi + (lo != 0).astype(U32)
        return jnp.where(t >= p, t - p, t)

    def add(self, x, y):
        p = self._bc(self.p, x)
        s = x + y
        return jnp.where(s >= p, s - p, s)

    def sub(self, x, y):
        p = self._bc(self.p, x)
        return jnp.where(x >= y, x - y, x + (p - y))


@dataclasses.dataclass(frozen=True)
class StackedNttPlans(_StackedMontOps):
    """All CRT primes processed in ONE tensor: every per-prime constant is a
    [P]-leading array broadcast against [P, ..., N] data. Halves (or better)
    the kernel count vs looping primes in python."""

    n: int
    primes: tuple
    p: np.ndarray            # [P] uint32
    n_prime: np.ndarray      # [P] uint32  (-p^-1 mod 2^32)
    twist_fwd: np.ndarray    # [P, N]
    untwist_inv: np.ndarray  # [P, N]
    w_fwd: tuple             # per stage: [P, m]
    w_inv: tuple


@dataclasses.dataclass(frozen=True)
class RollNttPlans(_StackedMontOps):
    """Roll-based stacked plans: butterflies via circular shifts + selects on
    a FIXED [..., N] geometry (no reshapes). Per stage: full-length twiddle vectors with
    entries at the second-half positions of each block, and a first-half mask.
    """

    n: int
    primes: tuple
    p: np.ndarray
    n_prime: np.ndarray
    twist_fwd: np.ndarray     # [P, N]
    untwist_inv: np.ndarray   # [P, N]
    w_fwd_full: tuple         # per stage: [P, N] twiddles at 2nd-half slots
    w_inv_full: tuple
    masks: tuple              # per stage: [N] bool, True on first half of block


@functools.lru_cache(maxsize=None)
def make_roll_plans(n: int, primes: tuple) -> RollNttPlans:
    plans = [make_plan(n, p) for p in primes]
    log2n = n.bit_length() - 1
    w_fwd_full, w_inv_full, masks = [], [], []
    j = np.arange(n)
    for s in range(log2n):
        L = n >> s
        m = L // 2
        pos = j % L
        mask = pos < m
        wf = np.zeros((len(primes), n), dtype=np.uint32)
        wi = np.zeros((len(primes), n), dtype=np.uint32)
        for pi, pl in enumerate(plans):
            idx = np.where(mask, 0, pos - m)
            wf[pi] = pl.w_fwd[s][idx]
            wi[pi] = pl.w_inv[s][idx]
        w_fwd_full.append(wf)
        w_inv_full.append(wi)
        masks.append(mask)
    return RollNttPlans(
        n=n,
        primes=primes,
        p=np.array(primes, dtype=np.uint32),
        n_prime=np.array([pl.ctx.n_prime for pl in plans], dtype=np.uint32),
        twist_fwd=np.stack([pl.twist_fwd for pl in plans]),
        untwist_inv=np.stack([pl.untwist_inv for pl in plans]),
        w_fwd_full=tuple(w_fwd_full),
        w_inv_full=tuple(w_inv_full),
        masks=tuple(masks),
    )


def forward_roll(rp: RollNttPlans, x):
    """Roll-based stacked forward negacyclic NTT on [P, ..., N].

    DIF butterfly via two rolls + selects: first-half slots get a+b, second
    half (a-b)*w, with the sequential permutation identical to
    forward_stacked (bit-reversed output order).
    """
    n = rp.n
    x = rp.mont_mul(x.astype(U32), rp._bc(rp.twist_fwd, x))
    log2n = n.bit_length() - 1
    for s in range(log2n):
        m = n >> (s + 1)
        mask = jnp.asarray(rp.masks[s])
        w = rp._bc(rp.w_fwd_full[s], x)
        xp = jnp.roll(x, -m, axis=-1)   # x[j+m] at slot j
        xm = jnp.roll(x, m, axis=-1)    # x[j-m] at slot j
        lo = rp.add(x, xp)
        hi = rp.mont_mul(rp.sub(xm, x), w)
        x = jnp.where(mask, lo, hi)
    return x  # bit-reversed order; inverse_roll consumes it directly


def inverse_roll(rp: RollNttPlans, x):
    """Inverse of forward_roll: [P, ..., N] spectra -> plain residues."""
    n = rp.n
    log2n = n.bit_length() - 1
    for s in reversed(range(log2n)):
        m = n >> (s + 1)
        mask = jnp.asarray(rp.masks[s])
        w = rp._bc(rp.w_inv_full[s], x)
        v = rp.mont_mul(x, w)           # valid at second-half slots
        vp = jnp.roll(v, -m, axis=-1)   # v[j+m] at slot j
        um = jnp.roll(x, m, axis=-1)    # u[j-m] at slot j
        x = jnp.where(mask, rp.add(x, vp), rp.sub(um, v))
    return rp.mont_mul(x, rp._bc(rp.untwist_inv, x))


@functools.lru_cache(maxsize=None)
def _bitrev_indices(n: int):
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _bitrev_permute(x, n: int):
    """Static bit-reversal permutation of the last axis (constant gather)."""
    return x[..., jnp.asarray(_bitrev_indices(n))]


@functools.lru_cache(maxsize=None)
def make_stacked_plans(n: int, primes: tuple) -> StackedNttPlans:
    plans = [make_plan(n, p) for p in primes]
    return StackedNttPlans(
        n=n,
        primes=primes,
        p=np.array(primes, dtype=np.uint32),
        n_prime=np.array([pl.ctx.n_prime for pl in plans], dtype=np.uint32),
        twist_fwd=np.stack([pl.twist_fwd for pl in plans]),
        untwist_inv=np.stack([pl.untwist_inv for pl in plans]),
        w_fwd=tuple(
            np.stack([pl.w_fwd[s] for pl in plans]) for s in range(len(plans[0].w_fwd))
        ),
        w_inv=tuple(
            np.stack([pl.w_inv[s] for pl in plans]) for s in range(len(plans[0].w_inv))
        ),
    )


def forward_stacked_bl(sp: StackedNttPlans, x):
    """Batch-LAST stacked forward NTT: x [P, lead..., N, B] -> spectra.

    The butterfly reshapes split the N axis, which sits in the SUBLANE
    position, while the minor axis stays the wide batch B throughout.
    """
    n = x.shape[-2]
    b = x.shape[-1]
    lead = x.shape[:-2]
    tw = sp._bc(sp.twist_fwd, x[..., 0])[..., None]  # [P,1..,N,1]
    x = sp.mont_mul(x.astype(U32), tw)
    log2n = n.bit_length() - 1
    for s in range(log2n):
        m = n >> (s + 1)
        xr = x.reshape(lead + (1 << s, 2 * m, b))
        a = xr[..., :m, :]
        bb = xr[..., m:, :]
        lo = sp.add(a, bb)
        w = sp._bc(sp.w_fwd[s], a[..., 0])[..., None]
        hi = sp.mont_mul(sp.sub(a, bb), w)
        x = jnp.stack([lo, hi], axis=-3).reshape(lead + (n, b))
    return x


def inverse_stacked_bl(sp: StackedNttPlans, x):
    """Inverse of forward_stacked_bl: [P, lead..., N, B] spectra -> residues."""
    n = x.shape[-2]
    b = x.shape[-1]
    lead = x.shape[:-2]
    log2n = n.bit_length() - 1
    for s in reversed(range(log2n)):
        m = n >> (s + 1)
        xr = x.reshape(lead + (1 << s, 2, m, b))
        u = xr[..., 0, :, :]
        w = sp._bc(sp.w_inv[s], u[..., 0])[..., None]
        v = sp.mont_mul(xr[..., 1, :, :], w)
        a = sp.add(u, v)
        bb = sp.sub(u, v)
        x = jnp.concatenate([a, bb], axis=-2).reshape(lead + (n, b))
    tw = sp._bc(sp.untwist_inv, x[..., 0])[..., None]
    return sp.mont_mul(x, tw)


def forward_stacked(sp: StackedNttPlans, x):
    """Stacked negacyclic forward NTT: x [P, ..., N] plain residues ->
    Montgomery spectra, bit-reversed, all primes in one pass."""
    n = sp.n
    lead = x.shape[:-1]
    x = sp.mont_mul(x.astype(U32), sp._bc(sp.twist_fwd, x))
    log2n = n.bit_length() - 1
    for s in range(log2n):
        m = n >> (s + 1)
        xr = x.reshape(lead + (1 << s, 2 * m))
        a = xr[..., :m]
        b = xr[..., m:]
        lo = sp.add(a, b)
        w = sp._bc(sp.w_fwd[s], xr)
        hi = sp.mont_mul(sp.sub(a, b), w)
        x = jnp.stack([lo, hi], axis=-2).reshape(lead + (n,))
    return x


def inverse_stacked(sp: StackedNttPlans, x):
    """Stacked inverse: [P, ..., N] Montgomery spectra -> plain residues."""
    n = sp.n
    lead = x.shape[:-1]
    log2n = n.bit_length() - 1
    for s in reversed(range(log2n)):
        m = n >> (s + 1)
        xr = x.reshape(lead + (1 << s, 2, m))
        u = xr[..., 0, :]
        w = sp._bc(sp.w_inv[s], u)
        v = sp.mont_mul(xr[..., 1, :], w)
        a = sp.add(u, v)
        b = sp.sub(u, v)
        x = jnp.concatenate([a, b], axis=-1).reshape(lead + (n,))
    return sp.mont_mul(x, sp._bc(sp.untwist_inv, x))


def forward(plan: NttPlan, x):
    """Negacyclic forward NTT.

    x: [..., N] uint32 plain residues in [0, p) -> [..., N] Montgomery-form
    spectrum in bit-reversed order.
    """
    n = plan.n
    ctx = plan.ctx
    lead = x.shape[:-1]
    x = ctx.mont_mul(x.astype(U32), jnp.asarray(plan.twist_fwd))
    log2n = n.bit_length() - 1
    for s in range(log2n):
        m = n >> (s + 1)
        xr = x.reshape(lead + (1 << s, 2 * m))
        a = xr[..., :m]
        b = xr[..., m:]
        lo = ctx.add(a, b)
        hi = ctx.mont_mul(ctx.sub(a, b), jnp.asarray(plan.w_fwd[s]))
        x = jnp.stack([lo, hi], axis=-2).reshape(lead + (n,))
    return x


def inverse(plan: NttPlan, x):
    """Negacyclic inverse NTT.

    x: [..., N] Montgomery spectrum (bit-reversed) -> [..., N] plain residues.
    """
    n = plan.n
    ctx = plan.ctx
    lead = x.shape[:-1]
    log2n = n.bit_length() - 1
    for s in reversed(range(log2n)):
        m = n >> (s + 1)
        xr = x.reshape(lead + (1 << s, 2, m))
        u = xr[..., 0, :]
        v = ctx.mont_mul(xr[..., 1, :], jnp.asarray(plan.w_inv[s]))
        a = ctx.add(u, v)
        b = ctx.sub(u, v)
        x = jnp.concatenate([a, b], axis=-1).reshape(lead + (n,))
    return ctx.mont_mul(x, jnp.asarray(plan.untwist_inv))


def pointwise_mul(plan: NttPlan, a, b):
    """Pointwise Montgomery product of two spectra."""
    return plan.ctx.mont_mul(a, b)


def negacyclic_polymul_mod_p(plan: NttPlan, a, b):
    """Exact a*b mod (X^N+1, p) for residue inputs — reference/test helper."""
    return inverse(plan, pointwise_mul(plan, forward(plan, a), forward(plan, b)))
