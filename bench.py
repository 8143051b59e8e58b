"""Gate-throughput benchmark on one NVIDIA GPU: boolean gate bootstraps
(PBS + keyswitch) per second.

Runs the full batched boolean-gate pipeline (linear combination + PBS +
keyswitch in one jit — the reference gate workload,
concrete-boolean/src/server_key/mod.rs:133-166) on the toeplitz (mxu)
backend and prints ONE JSON line. Without a GPU it exits non-zero and
prints no result.

Headline parameter set: TPU128_PARAMETERS — the co-designed 128-bit point
at total GLWE dimension k*N=1024 (the same security dimension class as the
reference's N=1024 TFHE_LIB point), chained worst-case gate error
<= 2^-32, i.e. strictly better than the reference's shipped DEFAULT grade
(2^-25, error.md:22). Derivation: concrete_tpu/design.py. The reference's
own TFHE_LIB_PARAMETERS (error 2^-165) and DEFAULT_PARAMETERS are also
measured and reported.

vs_baseline compares against the reference's published CPU number: 18.0 ms
per gate at TFHE_LIB_PARAMETERS (concrete-boolean/docs/user/error.md:23)
= 55.56 gates/s on a 2.6 GHz i7 core.

Key material is synthetic (key-shaped tensors) — throughput is identical to
real keys; correctness is covered by tests/ and `python chip_smoke.py`,
which runs real keys with decryption checks.
"""

import json
import os
import sys
import time

import numpy as np


def measure_gates(params, batches, rng, levels=None):
    """Best (rate, batch) for the full AND-gate pipeline at `params`.
    Also records every batch's rate in measure_gates.rates[batch]."""
    import jax
    import jax.numpy as jnp

    from concrete_tpu.core import bootstrap as bs
    from concrete_tpu.core import bootstrap_mxu as bsx

    cfg = bs.ServerConfig.from_boolean_parameters(params)
    if levels is not None:
        cfg = cfg.with_fast_mode(limb_drop=0, levels=levels)
    n, l, ks1, N = cfg.lwe_dimension, cfg.pbs_level, cfg.glwe_size, cfg.polynomial_size
    bsk_raw = rng.integers(0, 1 << 32, size=(n, l, ks1, ks1, N), dtype=np.uint32)
    from concrete_tpu.core import lwe as lwe_ops

    bsk = jnp.asarray(bsx.bsk_to_mxu(bsk_raw, cfg))
    ksk_raw = rng.integers(
        0, 1 << 32, size=(cfg.big_lwe_dimension, cfg.ks_level, n + 1),
        dtype=np.uint32)
    # int8 limb-prepared KSK: the ServerKey path beside the int8 backends
    # (bit-identical to the u32 form)
    ksk = jnp.asarray(lwe_ops.ksk_to_limbs(ksk_raw))
    lut = bs.trivial_lut_constant(cfg, np.uint32(1 << 29))
    neg_eighth = np.uint32((-(1 << 29)) % (1 << 32))

    @jax.jit
    def gate(b, k, ca, cb):  # AND: lin combo + PBS + keyswitch
        lin = (ca + cb).at[..., -1].add(neg_eighth)
        return bsx.bootstrap_keyswitch_mxu(cfg, b, k, lut, lin)

    best, best_batch = 0.0, 0
    measure_gates.rates = {}
    for batch in batches:
        ca = jnp.asarray(rng.integers(0, 1 << 32, size=(batch, n + 1), dtype=np.uint32))
        cb = jnp.asarray(rng.integers(0, 1 << 32, size=(batch, n + 1), dtype=np.uint32))
        try:
            jax.block_until_ready(gate(bsk, ksk, ca, cb))  # compile + warm
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                out = gate(bsk, ksk, ca, cb)
            jax.block_until_ready(out)
            dt = (time.perf_counter() - t0) / reps
        except Exception as e:  # noqa: BLE001 — skip OOM batch points
            print(f"batch {batch} failed: {e}", file=sys.stderr)
            continue
        rate = batch / dt
        measure_gates.rates[batch] = round(rate, 2)
        print(f"  batch {batch}: {dt*1e3:.1f} ms -> {rate:.1f} gates/s",
              file=sys.stderr)
        if rate > best:
            best, best_batch = rate, batch
    return best, best_batch


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (default device is {dev.platform}); refusing "
              "to run", file=sys.stderr)
        sys.exit(2)
    from concrete_tpu.profiling import card_description

    card = card_description()
    print(f"card: {card}", file=sys.stderr)
    batches = [int(x) for x in
               os.environ.get("BENCH_BATCHES", "2048,4096,8192").split(",")]
    from concrete_tpu.params import TFHE_LIB_PARAMETERS, TPU128_PARAMETERS

    rng = np.random.default_rng(0)
    print("TPU128_PARAMETERS (co-designed; worst-chain error 2^-32):",
          file=sys.stderr)
    tpu128, _ = measure_gates(TPU128_PARAMETERS, batches, rng)
    # secondary rows at B=2048 (the full sweep lives in benchmarks/suite.py)
    sec = [2048]
    print("TFHE_LIB_PARAMETERS exact (reference point, error 2^-165):",
          file=sys.stderr)
    tfhe_exact, _ = measure_gates(TFHE_LIB_PARAMETERS, sec, rng)
    print("TFHE_LIB_PARAMETERS fast (levels=2, error ~2^-24):", file=sys.stderr)
    tfhe_fast, _ = measure_gates(TFHE_LIB_PARAMETERS, sec, rng, levels=2)
    # apples-to-apples: the reference's own shipped DEFAULT_PARAMETERS
    # (n=586, k=2, N=512, error 2^-25) vs its published 11.3 ms/gate CPU
    # number (error.md:22) = 88.5 gates/s
    from concrete_tpu.params import DEFAULT_PARAMETERS

    print("DEFAULT_PARAMETERS exact (reference point, error 2^-25):",
          file=sys.stderr)
    default_exact, _ = measure_gates(DEFAULT_PARAMETERS, [2048, 4096], rng)
    default_b4096 = measure_gates.rates.get(4096, 0.0)

    baseline = 1000.0 / 18.0  # reference: 18.0 ms/gate single CPU core
    default_baseline = 1000.0 / 11.3  # reference DEFAULT: 11.3 ms/gate
    print(json.dumps({
        "metric": "gate_bootstraps_per_s_per_chip_n1024",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "value": round(tpu128, 2),
        "unit": "gates/s",
        "vs_baseline": round(tpu128 / baseline, 2),
        "headline_params": "TPU128 (n=630, k=4, N=256, kN=1024, 128-bit,"
        " chained worst-case gate error 2^-32 <= reference DEFAULT grade"
        " 2^-25; exact integer arithmetic)",
        "tfhe_lib_exact_gates_per_s": round(tfhe_exact, 2),
        "tfhe_lib_fast_l2_gates_per_s": round(tfhe_fast, 2),
        "default_exact_gates_per_s": round(default_exact, 2),
        "default_exact_b4096_gates_per_s": round(default_b4096, 2),
        "default_vs_baseline": round(default_exact / default_baseline, 2),
    }))


if __name__ == "__main__":
    main()
