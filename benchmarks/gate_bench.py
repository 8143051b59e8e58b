"""Gate-bootstrap throughput: NTT path vs int8 toeplitz (mxu) path on the
device, with synthetic keys; every timing ends in jax.block_until_ready.

Usage: python benchmarks/gate_bench.py [ntt|mxu|both] [param] [batches]
  param: tfhe_lib (default) | default | tpu128
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    pname = sys.argv[2] if len(sys.argv) > 2 else "tfhe_lib"
    batches = [int(x) for x in (sys.argv[3].split(",") if len(sys.argv) > 3
                                else [256, 1024, 2048, 4096])]

    import jax
    import jax.numpy as jnp

    from concrete_tpu.core import bootstrap as bs
    from concrete_tpu.core import bootstrap_mxu as bsx
    from concrete_tpu.params import (
        DEFAULT_PARAMETERS,
        TFHE_LIB_PARAMETERS,
        TPU128_PARAMETERS,
    )

    params = {"tfhe_lib": TFHE_LIB_PARAMETERS, "default": DEFAULT_PARAMETERS,
              "tpu128": TPU128_PARAMETERS}[pname]
    cfg = bs.ServerConfig.from_boolean_parameters(params)
    rng = np.random.default_rng(0)
    n, l, ks1, N = cfg.lwe_dimension, cfg.pbs_level, cfg.glwe_size, cfg.polynomial_size

    bsk_raw = rng.integers(0, 1 << 32, size=(n, l, ks1, ks1, N), dtype=np.uint32)
    ksk = jnp.asarray(rng.integers(
        0, 1 << 32, size=(cfg.big_lwe_dimension, cfg.ks_level, n + 1), dtype=np.uint32))
    lut = bs.trivial_lut_constant(cfg, np.uint32(1 << 29))
    # reference CPU ms/gate: 11.3 at DEFAULT, 18.0 at TFHE_LIB (error.md:22-23);
    # tpu128 compares against the TFHE_LIB number (same kN=1024 security class)
    baseline = 1000.0 / (11.3 if pname == "default" else 18.0)

    def run(name, fn, keys):
        for batch in batches:
            lin = jnp.asarray(rng.integers(0, 1 << 32, size=(batch, n + 1), dtype=np.uint32))
            f = jax.jit(lambda c: fn(keys, c))
            try:
                jax.block_until_ready(f(lin))  # warmup + compile
                t0 = time.perf_counter()
                reps = 3
                for _ in range(reps):
                    out = f(lin)
                jax.block_until_ready(out)
                dt = (time.perf_counter() - t0) / reps
            except Exception as e:  # noqa: BLE001
                print(f"{name} batch {batch}: FAIL {str(e)[:120]}", file=sys.stderr)
                continue
            rate = batch / dt
            print(f"{name} batch {batch}: {dt*1e3:.1f} ms -> {rate:.1f} gates/s "
                  f"({rate/baseline:.1f}x ref CPU)")

    if which in ("ntt", "both"):
        bsk_ntt = jnp.asarray(np.stack(
            [rng.integers(0, p, size=(n, l, ks1, ks1, N), dtype=np.uint32)
             for p in cfg.primes], axis=1))
        run("ntt", lambda k, c: bs.bootstrap_keyswitch(cfg, k, ksk, lut, c), bsk_ntt)
    if which in ("mxu", "both"):
        rings = jnp.asarray(bsx.bsk_to_mxu(bsk_raw, cfg))
        run("mxu", lambda k, c: bsx.bootstrap_keyswitch_mxu(cfg, k, ksk, lut, c), rings)


if __name__ == "__main__":
    main()
