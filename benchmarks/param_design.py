"""Parameter co-design sweep: runs concrete_tpu/design.py's search.

Ranks 128-bit-secure boolean parameter points by modeled gate throughput
(design.CostModel: shapes at the H100's data-sheet peaks) under the
chained worst-case error constraint. The top point is shipped as
params.TPU128_PARAMETERS; its measured throughput is in PERF.md.

Usage: python benchmarks/param_design.py [target_err_log2] [batch]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    # pure analytics — run on host CPU regardless of the ambient platform
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

    from concrete_tpu.design import search

    target = float(sys.argv[1]) if len(sys.argv) > 1 else -25.0
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    cands = search(target_err_log2=target, batch=batch)
    print(f"{len(cands)} feasible points (err <= 2^{target:.0f}, "
          f"batch {batch}); top 20 by modeled gates/s:")
    print(f"{'n':>4} {'k':>2} {'N':>5} {'bl':>3} {'l':>2} {'ks':>7} "
          f"{'model/s':>8} {'err(worst)':>10} {'err(fresh)':>10}")
    for c in cands[:20]:
        p = c.params
        print(f"{p.lwe_dimension:>4} {p.glwe_dimension:>2} "
              f"{p.polynomial_size:>5} {p.pbs_base_log:>3} {p.pbs_level:>2} "
              f"({p.ks_base_log},{p.ks_level:>2}) {c.gates_per_s:>8.0f} "
              f"2^{c.err_log2:>7.1f} 2^{c.err_log2_fresh:>7.1f}")


if __name__ == "__main__":
    main()
