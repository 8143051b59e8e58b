"""Batched-PBS scaling across a device mesh (BASELINE configs 4-5 harness).

Shards a gate-bootstrap batch over all visible devices (dp), keys
replicated, and reports per-chip throughput + scaling efficiency vs the
single-device rate. On a 1-card host this degenerates to the headline
bench; on a 4-card host it measures NVLink scaling.

Usage: python benchmarks/scaling.py [per_chip_batch] [tfhe_lib|default]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    per_chip = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    pname = sys.argv[2] if len(sys.argv) > 2 else "tfhe_lib"

    import jax
    import jax.numpy as jnp

    from concrete_tpu.core import bootstrap as bs
    from concrete_tpu.core import bootstrap_mxu as bsx
    from concrete_tpu.parallel import make_mesh, gate_pipeline_dp
    from concrete_tpu.params import DEFAULT_PARAMETERS, TFHE_LIB_PARAMETERS

    params = {"tfhe_lib": TFHE_LIB_PARAMETERS, "default": DEFAULT_PARAMETERS}[pname]
    cfg = bs.ServerConfig.from_boolean_parameters(params)
    n_dev = len(jax.devices())
    rng = np.random.default_rng(0)
    n, l, ks1, N = cfg.lwe_dimension, cfg.pbs_level, cfg.glwe_size, cfg.polynomial_size
    bsk_raw = rng.integers(0, 1 << 32, size=(n, l, ks1, ks1, N), dtype=np.uint32)
    rings = jnp.asarray(bsx.bsk_to_mxu(bsk_raw, cfg))
    ksk = jnp.asarray(rng.integers(
        0, 1 << 32, size=(cfg.big_lwe_dimension, cfg.ks_level, n + 1), dtype=np.uint32))
    lut = bs.trivial_lut_constant(cfg, np.uint32(1 << 29))

    def measure(n_devices):
        mesh = make_mesh(dp=n_devices, tp=1, devices=jax.devices()[:n_devices])
        fn = gate_pipeline_dp(cfg, mesh, backend="mxu")
        batch = per_chip * n_devices
        lin = jnp.asarray(rng.integers(0, 1 << 32, size=(batch, n + 1), dtype=np.uint32))
        out = fn(rings, ksk, lut, lin)
        np.asarray(out[0, :8])  # compile + completion
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = fn(rings, ksk, lut, lin)
            np.asarray(out[0, :8])
        dt = (time.perf_counter() - t0) / reps
        return batch / dt

    base = measure(1)
    print(f"1 device : {base:9.1f} gates/s ({base:8.1f}/chip)")
    if n_dev > 1:
        full = measure(n_dev)
        eff = full / (base * n_dev)
        print(f"{n_dev} devices: {full:9.1f} gates/s ({full / n_dev:8.1f}/chip, "
              f"{eff * 100:.1f}% scaling efficiency)")
    else:
        print("(single-device host: run on a pod slice for scaling numbers)")


if __name__ == "__main__":
    main()
