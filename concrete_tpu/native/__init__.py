"""Native (C++) host-side components.

The reference keeps its performance-critical host code native (FFTW C
bindings, AES-NI intrinsics in concrete-csprng/src/aesni.rs). Device
compute here is XLA; the host-side analog is a small C++
library for bulk AES-128-CTR generation (key/mask/noise material), built on
demand with the system toolchain and loaded through ctypes. Everything it
does is bit-identical to the pure-numpy fallback (csprng/aes.py), so the
native layer is a transparent accelerator, never a semantic dependency.

Example:
    >>> from concrete_tpu import native
    >>> lib = native.load_aes()
    >>> lib is None or hasattr(lib, "ctpu_aes128_ctr_fill")
    True
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys

_SRC = os.path.join(os.path.dirname(__file__), "aes_ctr.cpp")


def _lib_path() -> str:
    tag = f"cpython{sys.version_info.major}{sys.version_info.minor}"
    cache = os.environ.get(
        "CONCRETE_TPU_NATIVE_DIR",
        os.path.join(os.path.dirname(__file__), "..", "..", ".native_build"),
    )
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, f"ctpu_aes_{tag}.so")


def _build(lib: str) -> bool:
    """Compile to a temp path and rename into place (atomic on POSIX), so
    concurrent processes never load a half-written library."""
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-shared",
        "-fPIC",
        "-std=c++17",
        _SRC,
        "-o",
        tmp,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            return False
        os.replace(tmp, lib)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


@functools.lru_cache(maxsize=1)
def load_aes():
    """Load (building if needed) the native AES library, or None.

    Disable with CONCRETE_TPU_NO_NATIVE=1.
    """
    if os.environ.get("CONCRETE_TPU_NO_NATIVE"):
        return None
    lib_path = _lib_path()
    if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(_SRC):
        if not _build(lib_path):
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ctpu_aes128_key_schedule.argtypes = [u8p, u8p]
    lib.ctpu_aes128_key_schedule.restype = None
    lib.ctpu_aes128_encrypt_blocks.argtypes = [u8p, u8p, u8p, ctypes.c_size_t]
    lib.ctpu_aes128_encrypt_blocks.restype = None
    lib.ctpu_aes128_ctr_fill.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_uint64, u8p, ctypes.c_size_t]
    lib.ctpu_aes128_ctr_fill.restype = None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ctpu_aes128_ctr_fill_batch.argtypes = [
        u8p, u64p, u64p, u8p, ctypes.c_size_t, ctypes.c_size_t]
    lib.ctpu_aes128_ctr_fill_batch.restype = None
    lib.ctpu_aes128_has_hw.argtypes = []
    lib.ctpu_aes128_has_hw.restype = ctypes.c_int
    return lib
