"""TPU128: the co-designed boolean parameter set, end to end.

Shows the round-trip from hardware model to running gates:
1. re-derive the operating point with the co-design sweep (design.py);
2. check its security pins and chained worst-case gate error;
3. generate keys and run encrypted gates at the headline batch;
4. compare the measured output noise against the NPE prediction.

Run on the GPU host: python examples/tpu128_codesign.py
(the first call compiles the gate pipeline; later calls hit the cache).
"""

import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from concrete_tpu import boolean, design
from concrete_tpu.params import TPU128_PARAMETERS


def main():
    p = TPU128_PARAMETERS
    print("== 1. the operating point the sweep selects ==")
    cands = design.search(n_range=range(630, 651, 10),
                          shapes=((4, 256), (2, 512), (1, 1024)))
    top = cands[0].params
    print(f"   top candidate: n={top.lwe_dimension} k={top.glwe_dimension} "
          f"N={top.polynomial_size} bl={top.pbs_base_log} l={top.pbs_level} "
          f"(modeled {cands[0].gates_per_s:.0f} gates/s)")
    assert (top.glwe_dimension, top.polynomial_size,
            top.pbs_base_log, top.pbs_level) == (4, 256, 7, 2)

    print("== 2. security + error grade ==")
    print(f"   sigma_lwe  = 2^{math.log2(p.lwe_modular_std_dev.std_dev):.0f} "
          f"(curve minimum 2^{design.min_log2_std(p.lwe_dimension):.0f})")
    kn = p.glwe_dimension * p.polynomial_size
    print(f"   sigma_glwe = 2^{math.log2(p.glwe_modular_std_dev.std_dev):.0f} "
          f"(curve minimum 2^{design.min_log2_std(kn):.0f} at kN={kn})")
    print(f"   worst-chain gate error 2^{design.gate_error_log2(p):.1f} "
          f"(fresh-input 2^{design.gate_error_log2(p, worst_chain=False):.1f})")

    print("== 3. encrypted gates ==")
    cks, sks = boolean.gen_keys(p, secret_seed=1, mask_seed=2, noise_seed=3)
    rng = np.random.default_rng(0)
    B = 2048
    a = rng.integers(0, 2, B).astype(bool)
    b = rng.integers(0, 2, B).astype(bool)
    ca, cb = cks.encrypt(a), cks.encrypt(b)
    out = np.asarray(sks.and_(ca, cb))  # compiles on first call
    assert np.array_equal(cks.decrypt(out), a & b)
    np.asarray(sks.xor(ca, cb))         # warm the XOR pipeline too
    t0 = time.perf_counter()
    out = np.asarray(sks.xor(ca, cb))
    dt = time.perf_counter() - t0
    assert np.array_equal(cks.decrypt(out), a ^ b)
    print(f"   {B} XOR gates in {dt*1e3:.0f} ms -> {B/dt:.0f} gates/s "
          f"(incl. host pull; see bench.py for the device-time number)")

    print("== 4. noise vs the NPE ==")
    phase = cks.lwe_secret_key.decrypt(out.astype(np.uint32)).astype(np.int64)
    enc = np.where(a ^ b, 1 << 29, (7 << 29)).astype(np.int64)
    err = ((phase - enc + (1 << 31)) % (1 << 32)) - (1 << 31)
    v = design._fresh_gate_variance(p)
    print(f"   measured 2^{math.log2(err.std() / 2**32):.2f} vs "
          f"NPE 2^{math.log2(math.sqrt(v.get_variance())):.2f}")


if __name__ == "__main__":
    main()
