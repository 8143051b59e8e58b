"""Server key and homomorphic gates, batched and jitted.

Reference: concrete-boolean/src/server_key/mod.rs. ServerKey::new (:55-111):
generate the standard-domain BSK under the GLWE key, transform it (here: to
the exact NTT domain), flatten the GLWE key to the "big" LWE key, and build
the keyswitch key back to the small LWE key.

Gate linear combinations (:133-614):
  AND:  l + r - 1/8        NAND: -l - r + 1/8
  OR:   l + r + 1/8        NOR:  -l - r - 1/8
  XOR:  2(l + r) + 1/4     XNOR: 2(-l - r) - 1/4
  NOT:  -l (no bootstrap)  MUX:  pbs(c+t-1/8) + pbs(-c+e-1/8) + 1/8, keyswitch
Each bootstrapped gate = linear combination -> PBS with constant +1/8 test
polynomial -> keyswitch. All gates broadcast over leading batch axes.

Example (AND gate on tiny insecure parameters):
    >>> import numpy as np
    >>> from concrete_tpu import boolean
    >>> from concrete_tpu.params import BooleanParameters
    >>> from concrete_tpu.dispersion import StandardDev
    >>> tiny = BooleanParameters(4, 1, 64, StandardDev(2.0 ** -20),
    ...     StandardDev(2.0 ** -25), 7, 3, 2, 5)
    >>> cks, sks = boolean.gen_keys(tiny, secret_seed=1, mask_seed=2, noise_seed=3)
    >>> ct = sks.and_(cks.encrypt([True, True], mask_seed=4, noise_seed=5),
    ...               cks.encrypt([True, False], mask_seed=6, noise_seed=7))
    >>> [bool(x) for x in cks.decrypt(np.asarray(ct))]
    [True, False]

Every gate of the reference API (server_key/mod.rs:133-646):
    >>> a = cks.encrypt([True, True, False, False], mask_seed=8, noise_seed=9)
    >>> b = cks.encrypt([True, False, True, False], mask_seed=10, noise_seed=11)
    >>> dec = lambda c: [bool(x) for x in cks.decrypt(np.asarray(c))]
    >>> dec(sks.or_(a, b))
    [True, True, True, False]
    >>> dec(sks.xor(a, b))
    [False, True, True, False]
    >>> dec(sks.nand(a, b))
    [False, True, True, True]
    >>> dec(sks.nor(a, b))
    [False, False, False, True]
    >>> dec(sks.xnor(a, b))
    [True, False, False, True]
    >>> dec(sks.not_(a))                    # negation only — no bootstrap
    [False, False, True, True]
    >>> dec(sks.mux(a, b, cks.encrypt([False] * 4, mask_seed=12, noise_seed=13)))
    [True, False, False, False]
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import backend as backend_mod
from ..core import bootstrap as bs
from ..core import bootstrap_mxu as bsx
from ..core import bootstrap_nuss as bsn
from ..core.ggsw import StandardBootstrapKey, bsk_to_ntt
from ..core.lwe import LweKeyswitchKey
from ..csprng import EncryptionRandomGenerator
from .client_key import ClientKey, PLAINTEXT_LOG_SCALING_FACTOR, PLAINTEXT_TRUE

_EIGHTH = np.uint32(1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR))
_QUARTER = np.uint32(1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR + 1))
_NEG_EIGHTH = np.uint32((-(1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR))) % (1 << 32))
_NEG_QUARTER = np.uint32((-(1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR + 1))) % (1 << 32))


@dataclasses.dataclass
class ServerKey:
    """Bootstrap key + keyswitch key + static config.

    The coefficient-domain BSK is the canonical stored form; the evaluation
    form is derived lazily per backend:
    - "mxu": limb-packed toeplitz rotation rings driving the int8 matmul
      path (core/bootstrap_mxu.py);
    - "nuss": Nussbaumer-domain toeplitz rings (core/bootstrap_nuss.py) —
      the int8 path for N > 4096, where the direct toeplitz RHS is too
      large (2L M-point matmuls, O(N^2/L) MACs);
    - "ntt": exact prime-NTT spectra (core/bootstrap.py) — any config.
    "auto" resolves through core.backend.resolve. All backends are exact
    mod 2^32 and bit-identical.
    """

    ksk: jax.Array      # [kN, l_ks, n+1] uint32
    cfg: bs.ServerConfig
    bsk_standard: np.ndarray
    backend: str = "auto"
    _bsk_ntt: jax.Array | None = dataclasses.field(default=None, repr=False)
    _bsk_mxu: jax.Array | None = dataclasses.field(default=None, repr=False)
    _bsk_nuss: jax.Array | None = dataclasses.field(default=None, repr=False)
    _ksk8: jax.Array | None = dataclasses.field(default=None, repr=False)
    # batch tiers precompiled by warmup(); _pad_size pads sub-tier requests
    # up to the smallest warmed tier so a warmed server never compiles a
    # new shape mid-serving
    _warmed_tiers: set = dataclasses.field(
        default_factory=set, repr=False, compare=False)

    def resolved_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        return backend_mod.resolve(self.cfg)

    @property
    def bsk_ntt(self) -> jax.Array:
        if self._bsk_ntt is None:
            self._bsk_ntt = bsk_to_ntt(
                self.bsk_standard, self.cfg.primes, self.cfg.bits)
        return self._bsk_ntt

    @property
    def bsk_mxu(self) -> jax.Array:
        if self._bsk_mxu is None:
            self._bsk_mxu = jnp.asarray(
                bsx.bsk_to_mxu(self.bsk_standard, self.cfg))
        return self._bsk_mxu

    @property
    def bsk_nuss(self) -> jax.Array:
        if self._bsk_nuss is None:
            self._bsk_nuss = jnp.asarray(
                bsn.bsk_to_nuss(self.bsk_standard, self.cfg))
        return self._bsk_nuss

    def _bootstrap_keys(self):
        backend = self.resolved_backend()
        if backend == "mxu":
            return self.bsk_mxu
        if backend == "nuss":
            return self.bsk_nuss
        return self.bsk_ntt

    def _keyswitch_key(self):
        """int8 limb-prepared KSK beside the int8 product backends
        (bit-identical contraction); the u32 tensor elsewhere."""
        from ..core import lwe as lwe_ops

        if backend_mod.int8_keyswitch(
                self.resolved_backend() != "ntt", self.cfg.ks_base_log,
                self.ksk.shape[0] * self.ksk.shape[1]):
            if self._ksk8 is None:
                self._ksk8 = jnp.asarray(
                    lwe_ops.ksk_to_limbs(np.asarray(self.ksk)))
            return self._ksk8
        return self.ksk

    def with_fast_mode(self, *, limb_drop: int = 0,
                       levels: int | None = 2) -> "ServerKey":
        """Reduced-precision evaluation twin over the same key material.

        ``levels`` keeps only the most-significant PBS decomposition levels
        (both backends, still bit-identical to each other); ``limb_drop``
        rounds the GGSW operand on the MXU path (NTT path ignores it). Client
        keys and ciphertexts are unchanged. The extra noise is analytic:
        npe.estimate_pbs_noise at the reduced level count plus
        npe.estimate_mxu_truncation_noise — see docs/performance.md for the
        measured-vs-predicted validation and gate-error budget.

        The default (levels=2, limb_drop=0) keeps TFHE_LIB gates at a
        chained-gate error probability of ~2^-24 — the grade of the
        reference's own DEFAULT_PARAMETERS design point (2^-25). limb_drop
        is NOT recommended for the u32 boolean torus: the dropped-limb
        rounding corrupts GGSW mask components and is key-amplified by
        ~(1 + N/2) at decryption (hardware-validated; docs/performance.md),
        pushing N=1024 gates to ~2^-4 error. The u64 torus has the headroom
        for it (LWEBSK.with_fast_mode).
        """
        cfg = self.cfg.with_fast_mode(limb_drop=limb_drop, levels=levels)
        return dataclasses.replace(
            self, cfg=cfg,
            bsk_standard=self.bsk_standard[:, :cfg.pbs_level],
            _bsk_ntt=None, _bsk_mxu=None, _bsk_nuss=None)

    @classmethod
    def new(
        cls,
        cks: ClientKey,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
        keep_standard_bsk: bool | None = None,
    ) -> "ServerKey":
        p = cks.parameters
        cfg = bs.ServerConfig.from_boolean_parameters(p)
        gen = EncryptionRandomGenerator(mask_seed, noise_seed)
        std_bsk = StandardBootstrapKey.generate(
            cks.lwe_secret_key,
            cks.glwe_secret_key,
            p.pbs_base_log,
            p.pbs_level,
            p.glwe_modular_std_dev.std_dev,
            gen,
        )
        big_key = cks.glwe_secret_key.into_lwe_key()
        ksk = LweKeyswitchKey.generate(
            big_key,
            cks.lwe_secret_key,
            p.ks_base_log,
            p.ks_level,
            p.lwe_modular_std_dev.std_dev,
            gen,
        )
        if keep_standard_bsk is not None:
            import warnings

            warnings.warn(
                "keep_standard_bsk is deprecated and ignored: the coefficient"
                " BSK is the canonical stored form now",
                DeprecationWarning,
                stacklevel=2,
            )
        return cls(
            ksk=jnp.asarray(ksk.data),
            cfg=cfg,
            bsk_standard=std_bsk.data,
        )

    def save(self, path: str):
        """Serialize the coefficient-domain BSK + KSK + parameters."""
        np.savez_compressed(
            path,
            bsk=self.bsk_standard,
            ksk=np.asarray(self.ksk),
            lwe_dimension=self.cfg.lwe_dimension,
            glwe_dimension=self.cfg.glwe_dimension,
            polynomial_size=self.cfg.polynomial_size,
            pbs_base_log=self.cfg.pbs_base_log,
            pbs_level=self.cfg.pbs_level,
            ks_base_log=self.cfg.ks_base_log,
            ks_level=self.cfg.ks_level,
        )

    @classmethod
    def load(cls, path: str) -> "ServerKey":
        from ..core.ggsw import bsk_to_ntt

        d = np.load(path, allow_pickle=False)
        cfg = bs.ServerConfig(
            lwe_dimension=int(d["lwe_dimension"]),
            glwe_dimension=int(d["glwe_dimension"]),
            polynomial_size=int(d["polynomial_size"]),
            pbs_base_log=int(d["pbs_base_log"]),
            pbs_level=int(d["pbs_level"]),
            ks_base_log=int(d["ks_base_log"]),
            ks_level=int(d["ks_level"]),
        )
        return cls(
            ksk=jnp.asarray(d["ksk"]),
            cfg=cfg,
            bsk_standard=d["bsk"],
        )

    # -- gates -------------------------------------------------------------
    #
    # The whole gate — linear combination, PBS, keyswitch — runs inside ONE
    # jitted pipeline per (config, backend): one host dispatch per call. The
    # six two-input gates differ only in the linear combination's scale and
    # offset, which the pipeline takes as runtime scalars, so they share a
    # single compiled executable per batch shape.

    def _pad_size(self, b: int) -> int:
        """Padded batch for a `b`-row gate call: the smallest warmed tier
        that fits (a warmed server never compiles a fresh shape for
        sub-tier requests), else the next power of two."""
        fitting = [t for t in self._warmed_tiers if t >= b]
        if fitting:
            return min(fitting)
        return 1 << (b - 1).bit_length() if b > 1 else 1

    def _padded_call(self, fn, *cts):
        """Call `fn` with the batches flattened and padded to `_pad_size`:
        without warmup, gate calls hit at most log2(B) distinct compiled
        shapes (powers of two) instead of one per batch size; after warmup
        every request <= the largest warmed tier
        reuses a warmed executable. Zero rows bootstrap harmlessly and are
        sliced off."""
        cts = jnp.broadcast_arrays(*[jnp.asarray(c) for c in cts])
        lead = cts[0].shape[:-1]
        flats = [c.reshape((-1, c.shape[-1])) for c in cts]
        b = flats[0].shape[0]
        if b == 0:
            return jnp.zeros(lead + cts[0].shape[-1:], cts[0].dtype)
        padded = self._pad_size(b)
        if padded != b:
            flats = [
                jnp.concatenate(
                    [f, jnp.zeros((padded - b,) + f.shape[1:], f.dtype)], axis=0)
                for f in flats
            ]
        out = fn(*flats)
        return out[:b].reshape(lead + out.shape[-1:])

    def warmup(self, batch_sizes=(2048,), gates=("and",), mux=False):
        """Precompile the gate pipelines for the given batch sizes.

        The first call at a new padded-batch shape pays the full XLA
        compile (the two-input gates share one executable, MUX has its
        own), so a serving process should warm the shapes it will serve
        before taking traffic. Each warmed size is
        rounded up to a power-of-two tier, and subsequent gate calls pad
        every request up to the smallest warmed tier that fits
        (`_pad_size`): warming one tier covers ALL request sizes <= it with
        zero fresh compiles. Zero-row ciphertexts bootstrap harmlessly.
        Returns {(gate, padded_batch): seconds}.

        Reference analog: none — the reference's CPU backend has no
        compile step; this is the accelerator deployment counterpart of its
        keygen cost being paid once up front (concrete-boolean/src/lib.rs:96).
        """
        import time as _time

        assert self.cfg.bits == 32, "boolean gates are a 32-bit-torus layer"
        timings = {}
        n1 = self.cfg.lwe_dimension + 1
        for bsz in batch_sizes:
            padded = 1 << (int(bsz) - 1).bit_length() if bsz > 1 else 1
            self._warmed_tiers.add(padded)
            z = jnp.zeros((padded, n1), jnp.uint32)
            for gate in gates:
                t0 = _time.perf_counter()
                jax.block_until_ready(self._run_gate(gate, z, z))
                timings[(gate, padded)] = _time.perf_counter() - t0
            if mux:
                t0 = _time.perf_counter()
                jax.block_until_ready(self.mux(z, z, z))
                timings[("mux", padded)] = _time.perf_counter() - t0
        return timings

    def _run_gate(self, gate: str, ct_left, ct_right):
        pipe = _gate_pipeline(self.cfg, self.resolved_backend())
        scale, offset = _GATE_LIN[gate]
        return self._padded_call(
            lambda a, b: pipe(self._bootstrap_keys(), self._keyswitch_key(),
                              scale, offset, a, b),
            ct_left, ct_right)

    def and_(self, ct_left, ct_right):
        return self._run_gate("and", ct_left, ct_right)

    def nand(self, ct_left, ct_right):
        return self._run_gate("nand", ct_left, ct_right)

    def or_(self, ct_left, ct_right):
        return self._run_gate("or", ct_left, ct_right)

    def nor(self, ct_left, ct_right):
        return self._run_gate("nor", ct_left, ct_right)

    def xor(self, ct_left, ct_right):
        return self._run_gate("xor", ct_left, ct_right)

    def xnor(self, ct_left, ct_right):
        return self._run_gate("xnor", ct_left, ct_right)

    def not_(self, ct):
        """Free negation, no bootstrap (server_key/mod.rs:422-429)."""
        return jnp.zeros_like(jnp.asarray(ct)) - ct

    def mux(self, ct_condition, ct_then, ct_else):
        """(c ? t : e) via two PBS + one keyswitch (server_key/mod.rs:197-279)."""
        c = jnp.asarray(ct_condition)
        t = jnp.broadcast_to(jnp.asarray(ct_then), c.shape)
        e = jnp.broadcast_to(jnp.asarray(ct_else), c.shape)
        pipe = _mux_pipeline(self.cfg, self.resolved_backend())
        stacked = jnp.stack(
            [c.reshape(-1, c.shape[-1]), t.reshape(-1, c.shape[-1]),
             e.reshape(-1, c.shape[-1])], axis=0)

        def run(flat3):  # [3*B, n+1] after padding -> un-stack inside
            third = flat3.shape[0] // 3
            return pipe(self._bootstrap_keys(), self._keyswitch_key(),
                        flat3[:third], flat3[third:2 * third], flat3[2 * third:])

        # pad the three operands jointly so their rows stay aligned
        lead = c.shape[:-1]
        b = stacked.shape[1]
        if b == 0:
            return jnp.zeros(lead + c.shape[-1:], c.dtype)
        padded = self._pad_size(b)
        if padded != b:
            pad = jnp.zeros((3, padded - b, stacked.shape[-1]), stacked.dtype)
            stacked = jnp.concatenate([stacked, pad], axis=1)
        out = run(stacked.reshape(-1, stacked.shape[-1]))
        return out[:b].reshape(lead + out.shape[-1:])


# linear combination per gate (server_key/mod.rs:133-614): the gate input is
# scale * (a + b) with `offset` added to the body, all mod 2^32 — e.g. NAND's
# -l - r + 1/8 is scale 2^32 - 1, offset 1/8
_GATE_LIN = {
    "and": (np.uint32(1), _NEG_EIGHTH),
    "nand": (np.uint32(0xFFFFFFFF), _EIGHTH),
    "or": (np.uint32(1), _EIGHTH),
    "nor": (np.uint32(0xFFFFFFFF), _NEG_EIGHTH),
    "xor": (np.uint32(2), _QUARTER),
    "xnor": (np.uint32(0xFFFFFFFE), _NEG_QUARTER),
}


@functools.lru_cache(maxsize=None)
def _gate_pipeline(cfg: bs.ServerConfig, backend: str):
    """jit(linear combination + PBS with constant 1/8 accumulator +
    keyswitch) — any two-input gate in one dispatch; the gate is chosen by
    the runtime (scale, offset) pair of _GATE_LIN."""
    bks = {"mxu": bsx.bootstrap_keyswitch_mxu,
           "nuss": bsn.bootstrap_keyswitch_nuss}.get(
        backend, bs.bootstrap_keyswitch)

    def run(bsk, ksk, scale, offset, a, b):
        lut = bs.trivial_lut_constant(cfg, PLAINTEXT_TRUE)
        lin = ((a + b) * scale).at[..., -1].add(offset)
        return bks(cfg, bsk, ksk, lut, lin)

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _mux_pipeline(cfg: bs.ServerConfig, backend: str):
    pbs_fn = {"mxu": bsx.bootstrap_mxu,
              "nuss": bsn.bootstrap_nuss}.get(backend, bs.bootstrap)

    def run(bsk, ksk, c, t, e):
        lut = bs.trivial_lut_constant(cfg, PLAINTEXT_TRUE)
        lin1 = (c + t).at[..., -1].add(_NEG_EIGHTH)
        lin2 = (jnp.zeros_like(c) - c + e).at[..., -1].add(_NEG_EIGHTH)
        # both bootstraps share the CMux chain by stacking on a batch axis
        both = jnp.stack([lin1, lin2], axis=0)
        pbs = pbs_fn(cfg, bsk, lut, both)
        summed = (pbs[0] + pbs[1]).at[..., -1].add(_EIGHTH)
        from ..core import lwe as lwe_ops

        return lwe_ops.keyswitch_any(
            ksk, summed, base_log=cfg.ks_base_log, level_count=cfg.ks_level)

    return jax.jit(run)
