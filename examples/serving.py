"""A minimal gate-serving loop: warmup, padded batching, throughput accounting.

Serving pattern on an accelerator (see docs/user_guide.md "Warming up a
serving process"): after warmup, every request is padded up to the smallest
warmed batch tier that fits (ServerKey._pad_size), so a server that warms
its top tier once serves any request size <= that tier without paying a
fresh XLA compile. Reference workload analog:
the per-gate loop in concrete-boolean/src/server_key/mod.rs:133-166 — here a
whole batch of independent gates is one device dispatch.

Run on anything (CPU falls back to the exact NTT backend); pass a parameter
preset name to switch, e.g. `python examples/serving.py TPU128`.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from concrete_tpu import boolean, params


def main():
    preset = sys.argv[1] if len(sys.argv) > 1 else "TINY"
    if preset == "TINY":  # CPU-friendly demo shape (not a security point)
        from concrete_tpu.dispersion import StandardDev

        p = params.BooleanParameters(
            lwe_dimension=16, glwe_dimension=1, polynomial_size=128,
            lwe_modular_std_dev=StandardDev(2.0 ** -20),
            glwe_modular_std_dev=StandardDev(2.0 ** -25),
            pbs_base_log=8, pbs_level=2, ks_base_log=4, ks_level=3)
    else:
        p = getattr(params, f"{preset}_PARAMETERS")
    cks, sks = boolean.gen_keys(p, secret_seed=1, mask_seed=2, noise_seed=3)

    # 1) Warm the tiers this server will accept (here: up to 64 lanes).
    t = sks.warmup(batch_sizes=(64,), gates=("and", "xor"))
    for (gate, padded), secs in t.items():
        print(f"warmup {gate:>4} @ batch {padded}: {secs:.2f}s")

    # 2) Serve a stream of mixed-size requests; every size <= 64 reuses the
    #    warmed executables (padding happens inside the gate call).
    rng = np.random.default_rng(0)
    served = 0
    t0 = time.perf_counter()
    for size in (3, 17, 64, 40, 5):
        a = rng.integers(0, 2, size).astype(bool)
        b = rng.integers(0, 2, size).astype(bool)
        ct_a, ct_b = cks.encrypt(a), cks.encrypt(b)
        out = np.asarray(sks.and_(ct_a, ct_b))  # forced host pull
        assert np.array_equal(cks.decrypt(out), a & b)
        served += size
    dt = time.perf_counter() - t0
    print(f"served {served} gates in {dt:.2f}s "
          f"({served / dt:.0f} gates/s incl. encrypt/decrypt round trips)")


if __name__ == "__main__":
    main()
