"""concrete-tpu: a TFHE (fully homomorphic encryption over the torus) framework
in JAX, whose server side runs on an accelerator (an NVIDIA GPU; the CPU for
tests).

Built from scratch in JAX/XLA with the capabilities of the Zama `concrete`
ecosystem (reference: kc1212/concrete):

- LWE / GLWE / GGSW encryption over the discretized torus (u32 / u64)
- forkable AES-128-CTR CSPRNG with deterministic fork-tree semantics
- signed gadget decomposition, keyswitching, modulus switching, sample extraction
- programmable bootstrapping (blind rotation as a CMux chain of external products)
- an analytic noise-propagation estimator (`concrete_tpu.npe`)
- boolean-gate and encoder-based user APIs
- batch-first design: every server-side op is a jitted pure function over
  ciphertext batches, sharded across a device mesh with `shard_map`.

Design stance (vs the reference's Rust/FFTW):
- client-side ops (keygen / encrypt / decrypt) run host-side in numpy and are
  bit-reproducible under fixed seeds, mirroring the reference's CSPRNG fork
  discipline byte for byte;
- server-side ops (PBS, keyswitch, gate evaluation) run on the device, with
  the negacyclic polynomial product computed exactly — as an int8 toeplitz
  matmul or a prime-modulus NTT + CRT — where the reference's f64 FFT is
  approximate.
"""

import os as _os

import jax as _jax

# u64 torus support (the reference's `concrete` crate fixes Torus = u64,
# concrete/src/lib.rs:22). Enable 64-bit types before any array is created.
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: JAX reads JAX_COMPILATION_CACHE_DIR itself;
# without it the cache sits at a fixed path in the checkout (the path is part
# of the cache key, so it must not move between runs).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", ".jax_cache")))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

from . import dispersion, params  # noqa: E402,F401

__version__ = "0.1.0"
