"""Backend resolution, compile-cache placement, and the chip smoke script's
refusal to run without a GPU."""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

from concrete_tpu.core import backend
from concrete_tpu.core.bootstrap import ServerConfig
from concrete_tpu.params import (DEFAULT_PARAMETERS, TFHE_LIB_PARAMETERS,
                                 TPU128_PARAMETERS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(params, bits=32, n=None):
    cfg = ServerConfig.from_boolean_parameters(params)
    return dataclasses.replace(
        cfg, bits=bits, polynomial_size=n or cfg.polynomial_size, primes=())


@pytest.mark.parametrize("params,bits,n,on_gpu", [
    (TFHE_LIB_PARAMETERS, 32, None, "mxu"),
    (DEFAULT_PARAMETERS, 32, None, "mxu"),      # n_sub = 2 digit split
    (TPU128_PARAMETERS, 32, None, "mxu"),
    (TFHE_LIB_PARAMETERS, 64, None, "mxu"),     # u64 torus
    (TPU128_PARAMETERS, 64, None, "mxu"),
    (TFHE_LIB_PARAMETERS, 32, 4096, "mxu"),     # the direct table's limit
    (TFHE_LIB_PARAMETERS, 32, 8192, "ntt"),
    (TFHE_LIB_PARAMETERS, 64, 8192, "ntt"),
    (TFHE_LIB_PARAMETERS, 32, 16384, "ntt"),
], ids=["tfhe_lib", "default", "tpu128", "tfhe_lib_u64", "tpu128_u64",
        "n4096", "n8192", "n8192_u64", "n16384"])
def test_resolve(params, bits, n, on_gpu):
    """The CPU keeps the NTT; an accelerator takes the direct int8 toeplitz
    path where its plan admits the config (N <= 4096), the NTT beyond."""
    cfg = _cfg(params, bits, n)
    assert backend.resolve(cfg, platform="cpu") == "ntt"
    assert backend.resolve(cfg, platform="gpu") == on_gpu
    assert backend.resolve(cfg) == "ntt"          # the test host is a CPU


def test_keys_resolve_through_the_resolver():
    from concrete_tpu import boolean
    from concrete_tpu.highlevel import LWEBSK

    from common import TINY

    _, sks = boolean.gen_keys(TINY, secret_seed=1, mask_seed=2, noise_seed=3)
    assert sks.resolved_backend() == "ntt"
    assert dataclasses.replace(sks, backend="mxu").resolved_backend() == "mxu"
    bsk = LWEBSK(cfg=_cfg(TFHE_LIB_PARAMETERS, 64), variance=0.0,
                 coefficient_bsk=None)
    assert bsk.resolved_backend() == "ntt"


@pytest.mark.parametrize("int8_product,base_log,rows,want", [
    (True, 2, 1024 * 8, True),
    (False, 2, 1024 * 8, False),
    (True, 8, 1024 * 8, False),         # digits wider than int8
    (True, 2, 1 << 18, False),          # int32 accumulation bound
])
def test_int8_keyswitch(int8_product, base_log, rows, want):
    assert backend.int8_keyswitch(int8_product, base_log, rows) is want


def _run_python(code, env_extra, cwd=REPO):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


_PRINT_CACHE = ("import jax, concrete_tpu; "
                "print(jax.config.jax_compilation_cache_dir)")


def test_cache_dir_follows_environment(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the package sets no directory."""
    r = _run_python(_PRINT_CACHE,
                    {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path / "cc")


def test_cache_dir_defaults_to_checkout(tmp_path):
    """Unset: a fixed directory in the checkout, wherever the process
    starts."""
    r = _run_python(_PRINT_CACHE, {}, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, alone):
    """Without a GPU the smoke script exits non-zero and prints no result,
    in the repository and copied alone into an empty directory."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, script], env=env, cwd=cwd,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
