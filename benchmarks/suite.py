"""Per-operation benchmark suite — the criterion-harness analog.

Mirrors concrete-benchmark/src/generics/ (42 generic engine benches): every
engine-level operation timed over a parameter grid, batched (the device's
unit of work is a ciphertext batch, not a single ciphertext). Emits one JSON line per
(op, params, batch) to stdout; human-readable table to stderr.

Small ops are CHAINED inside one jit (scan) so the numbers measure device
compute, not per-dispatch host overhead. Heavy ops (>= tens of ms) are
timed per dispatch, each ending in jax.block_until_ready.

Usage: python benchmarks/suite.py [--ops op1,op2] [--batch 1024] [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.timing import time_device  # noqa: E402


def _timeit(fn, *args, reps=3):
    """Per-dispatch timing for heavy ops, each call device-synchronized."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", default="")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from concrete_tpu.core import bootstrap as bs
    from concrete_tpu.core import bootstrap_mxu as bsx
    from concrete_tpu.core import lwe as lwe_ops
    from concrete_tpu.core import packing
    from concrete_tpu.math import ntt
    from concrete_tpu.params import (
        DEFAULT_PARAMETERS,
        TFHE_LIB_PARAMETERS,
        TPU128_PARAMETERS,
    )

    rng = np.random.default_rng(0)
    B = args.batch
    results = []

    def record(op, params_name, dt, unit_count, batch=None):
        rec = {
            "op": op,
            "params": params_name,
            "batch": batch if batch is not None else B,
            "ms": round(dt * 1e3, 4),
            "per_s": round(unit_count / dt, 1),
        }
        results.append(rec)
        print(json.dumps(rec))
        print(f"{op:40s} {params_name:12s} {dt*1e3:10.3f} ms {unit_count/dt:14.1f}/s", file=sys.stderr)

    param_sets = {"default": DEFAULT_PARAMETERS, "tfhe_lib": TFHE_LIB_PARAMETERS,
                  "tpu128": TPU128_PARAMETERS}
    if args.quick:
        param_sets = {"default": DEFAULT_PARAMETERS}
    want = set(args.ops.split(",")) if args.ops else None

    def wanted(op):
        return not want or op in want

    for pname, params in param_sets.items():
        cfg = bs.ServerConfig.from_boolean_parameters(params)
        n, N = cfg.lwe_dimension, cfg.polynomial_size
        l, ks1 = cfg.pbs_level, cfg.glwe_size
        bsk = jnp.asarray(np.stack(
            [rng.integers(0, p, size=(n, l, ks1, ks1, N), dtype=np.uint32) for p in cfg.primes],
            axis=1))
        ksk = jnp.asarray(rng.integers(
            0, 1 << 32, size=(cfg.big_lwe_dimension, cfg.ks_level, n + 1), dtype=np.uint32))
        cts = jnp.asarray(rng.integers(0, 1 << 32, size=(B, n + 1), dtype=np.uint32))
        big = jnp.asarray(rng.integers(0, 1 << 32, size=(B, cfg.big_lwe_dimension + 1), dtype=np.uint32))
        glwe = jnp.asarray(rng.integers(0, 1 << 32, size=(B, ks1, N), dtype=np.uint32))
        lut = bs.trivial_lut_constant(cfg, np.uint32(1 << 29))

        def run(op, fn, *a, unit=B):
            """Heavy op: per-dispatch timing."""
            if wanted(op):
                record(op, pname, _timeit(jax.jit(fn), *a), unit)

        def run_chained(op, step, init, unit=B, reps=32):
            """Small op: `step` maps the carry to a same-structure carry;
            `reps` applications chained in one jit (no dispatch overhead).
            Elementwise ops get thousands of reps so the chain's device time
            clears the dispatch-overhead floor."""
            if wanted(op):
                record(op, pname, time_device(step, init, reps=reps), unit)

        # -- elementwise / linear LWE ops (chained: dispatch-free) -----------
        run_chained("lwe_add", lambda c: c + c, cts, reps=4096)
        run_chained("lwe_sub", lambda c: c - cts, cts, reps=4096)
        run_chained("lwe_neg", lambda c: jnp.zeros_like(c) - c, cts, reps=4096)
        run_chained("lwe_scalar_mul", lambda c: c * np.uint32(3), cts, reps=4096)
        run_chained("lwe_plaintext_add",
                    lambda c: lwe_ops.add_plaintext(c, np.uint32(12345)), cts,
                    reps=4096)
        wts = (1, 3, 5, 7)
        cts4 = jnp.asarray(rng.integers(0, 1 << 32, size=(B, 4, n + 1), dtype=np.uint32))

        def aff_step(c4):
            out = lwe_ops.affine_transform(c4, wts, np.uint32(7))  # [B, n+1]
            return c4 + out[:, None, :]
        run_chained("lwe_affine_transform", aff_step, cts4, reps=256)

        def ks_step(bc):
            out = lwe_ops.keyswitch(ksk, bc, base_log=cfg.ks_base_log,
                                    level_count=cfg.ks_level)   # [B, n+1]
            return bc + jnp.pad(out, ((0, 0), (0, bc.shape[1] - out.shape[1])))
        run_chained("keyswitch", ks_step, big, reps=16)

        def ms_step(c):
            out = bs.pbs_modulus_switch(c, N)
            return c + out.astype(c.dtype)
        run_chained("modulus_switch", ms_step, cts, reps=512)

        def se_step(g):
            out = bs.sample_extract(g)                          # [B, kN+1]
            # fold the whole output back in (sum defeats dead-code elim)
            return g + out.sum(axis=1, dtype=g.dtype)[:, None, None]
        run_chained("sample_extract", se_step, glwe, reps=512)

        # -- NTT / external products / cmux ---------------------------------
        plan0 = cfg.plan(cfg.primes[0])

        def nttf_step(g):
            out = ntt.forward(plan0, g % np.uint32(cfg.primes[0]))
            return g + out
        run_chained("ntt_forward", nttf_step, glwe)

        def ntti_step(g):
            out = ntt.inverse(plan0, g % np.uint32(cfg.primes[0]))
            return g + out
        run_chained("ntt_inverse", ntti_step, glwe)

        run_chained("external_product",
                    lambda g: bs.external_product(cfg, bsk[0], g), glwe,
                    reps=16)
        run_chained("cmux", lambda g: bs.cmux(cfg, bsk[0], g, g + g), glwe,
                    reps=16)

        bsk_raw = rng.integers(0, 1 << 32, size=(n, l, ks1, ks1, N), dtype=np.uint32)
        rings = jnp.asarray(bsx.bsk_to_mxu(bsk_raw, cfg))
        run_chained("external_product_mxu",
                    lambda g: bsx.external_product_mxu(cfg, rings[0], g), glwe,
                    reps=16)
        run_chained("cmux_mxu",
                    lambda g: bsx.cmux_mxu(cfg, rings[0], g, g + g), glwe,
                    reps=16)

        # -- packing keyswitch ----------------------------------------------
        pksk = jnp.asarray(rng.integers(
            0, 1 << 32, size=(n, cfg.ks_level, ks1, N), dtype=np.uint32))

        def pk_step(c):
            out = packing.keyswitch_lwe_to_glwe(
                pksk, c, base_log=cfg.ks_base_log, level_count=cfg.ks_level)
            return c + out.sum(axis=(1, 2), dtype=c.dtype)[:, None]
        run_chained("packing_keyswitch", pk_step, cts, reps=16)
        m_pack = min(B, N)

        def pkb_step(c):
            out = packing.packing_keyswitch(
                pksk, c, base_log=cfg.ks_base_log, level_count=cfg.ks_level)
            return c + out.sum(dtype=c.dtype)
        run_chained("packing_keyswitch_batch", pkb_step, cts[:m_pack],
                    unit=m_pack, reps=16)

        # -- bootstrap pipelines --------------------------------------------
        run("blind_rotate_mxu",
            lambda r, c: bsx.blind_rotate_mxu(cfg, r, lut, c), rings, cts)
        run("pbs", lambda bk, c: bs.bootstrap(cfg, bk, lut, c), bsk, cts)
        run("pbs_mxu", lambda r, c: bsx.bootstrap_mxu(cfg, r, lut, c), rings, cts)
        run("multi_lut_pbs_mxu (4 luts)",
            lambda r, c: bsx.bootstrap_many_lut_mxu(cfg, r, lut, c, 2),
            rings, cts, unit=4 * B)
        run("gate_bootstrap (pbs+ks)",
            lambda bk, k, c: bs.bootstrap_keyswitch(cfg, bk, k, lut, c),
            bsk, ksk, cts)
        run("gate_bootstrap_mxu (pbs+ks)",
            lambda r, k, c: bsx.bootstrap_keyswitch_mxu(cfg, r, k, lut, c),
            rings, ksk, cts)
        if pname == "tfhe_lib" and wanted("gate_bootstrap_fast"):
            # the SAFE fast mode: levels-only (limb_drop corrupts GGSW mask
            # components, key-amplified ~(1+N/2) — see docs/performance.md)
            fcfg = cfg.with_fast_mode(limb_drop=0, levels=2)
            frings = jnp.asarray(bsx.bsk_to_mxu(bsk_raw[:, :fcfg.pbs_level], fcfg))
            run("gate_bootstrap_fast (l=2)",
                lambda r, k, c: bsx.bootstrap_keyswitch_mxu(fcfg, r, k, lut, c),
                frings, ksk, cts)

        # -- key material: generation + conversions (host + device) ---------
        if wanted("keygen") and not args.quick:
            from concrete_tpu.core.ggsw import StandardBootstrapKey, bsk_to_ntt
            from concrete_tpu.core.glwe import GlweSecretKey
            from concrete_tpu.core.lwe import LweSecretKey
            from concrete_tpu.csprng import (EncryptionRandomGenerator,
                                             SecretRandomGenerator)

            sgen = SecretRandomGenerator(1)
            lsk = LweSecretKey.generate_binary(n, sgen)
            gsk = GlweSecretKey.generate_binary(cfg.glwe_dimension, N, sgen)
            t0 = time.perf_counter()
            std_bsk = StandardBootstrapKey.generate(
                lsk, gsk, cfg.pbs_base_log, cfg.pbs_level, 2.0 ** -25,
                EncryptionRandomGenerator(2, 3))
            record("bsk_generate (host)", pname, time.perf_counter() - t0, 1)
            t0 = time.perf_counter()
            bsk_to_ntt(std_bsk.data, cfg.primes, 32)
            record("bsk_to_ntt (host)", pname, time.perf_counter() - t0, 1)
            t0 = time.perf_counter()
            bsx.bsk_to_mxu(std_bsk.data, cfg)
            record("bsk_to_mxu (host)", pname, time.perf_counter() - t0, 1)
            t0 = time.perf_counter()
            lwe_ops.LweKeyswitchKey.generate(
                gsk.into_lwe_key(), lsk, cfg.ks_base_log, cfg.ks_level,
                2.0 ** -20, EncryptionRandomGenerator(4, 5))
            record("ksk_generate (host)", pname, time.perf_counter() - t0, 1)
            t0 = time.perf_counter()
            lsk.encrypt(np.zeros(B, np.uint32), 2.0 ** -20,
                        EncryptionRandomGenerator(6, 7))
            record("lwe_encrypt (host)", pname, time.perf_counter() - t0, B)

    # -- u64 torus regime (the highlevel crate's Torus) ----------------------
    if wanted("u64"):
        # bl<=7 avoids the digit sub-split (R=6 not 12) — the recommended
        # u64 regime (docs/performance.md "u64 torus")
        cfg64 = bs.ServerConfig(
            lwe_dimension=630, glwe_dimension=1, polynomial_size=1024,
            pbs_base_log=7, pbs_level=3, ks_base_log=4, ks_level=7, bits=64)
        n64, N64 = cfg64.lwe_dimension, cfg64.polynomial_size
        bsk_raw64 = rng.integers(0, 1 << 64, size=(n64, 3, 2, 2, N64), dtype=np.uint64)
        rings64 = jnp.asarray(bsx.bsk_to_mxu(bsk_raw64, cfg64))
        lut64 = bs.trivial_lut_constant(cfg64, np.uint64(1) << np.uint64(60))
        cts64 = jnp.asarray(rng.integers(0, 1 << 64, size=(B, n64 + 1), dtype=np.uint64))
        record("pbs_mxu_u64", "n630_N1024_l3_bl7",
               _timeit(jax.jit(lambda r, c: bsx.bootstrap_mxu(cfg64, r, lut64, c)),
                       rings64, cts64), B)
        import dataclasses as _dc

        fcfg64 = _dc.replace(cfg64, mxu_limb_drop=2, primes=())
        frings64 = jnp.asarray(bsx.bsk_to_mxu(bsk_raw64, fcfg64))
        record("pbs_mxu_u64_fast (drop=2)", "n630_N1024_l3_bl7",
               _timeit(jax.jit(
                   lambda r, c: bsx.bootstrap_mxu(fcfg64, r, lut64, c)),
                   frings64, cts64), B)
        ksk64 = jnp.asarray(rng.integers(
            0, 1 << 64, size=(cfg64.big_lwe_dimension, cfg64.ks_level, n64 + 1),
            dtype=np.uint64))
        big64 = jnp.asarray(rng.integers(
            0, 1 << 64, size=(B, cfg64.big_lwe_dimension + 1), dtype=np.uint64))

        # the limb-plane path is the accelerator's u64 keyswitch
        # (lwe.keyswitch_limbs, like LWEKSK.run_keyswitch off the CPU)
        ksk8 = jnp.asarray(lwe_ops.ksk_to_limbs(np.asarray(ksk64)))

        def ks64_step(bc):
            out = lwe_ops.keyswitch_limbs(ksk8, bc, base_log=4, level_count=7)
            return bc + jnp.pad(out, ((0, 0), (0, bc.shape[1] - out.shape[1])))
        record("keyswitch_u64 (limb planes)", "n630_N1024_l7",
               time_device(ks64_step, big64, reps=16), B)

    # Nussbaumer-domain backend: the N > 4096 production path (the direct
    # toeplitz RHS is O(N^2); the reference reaches N <= 16384 through FFTW,
    # concrete-core .../math/fft/mod.rs:28). Same engine-bench shape as the
    # pbs_sweep rows, pushed past the mxu envelope; u32 + u64 torus.
    if wanted("nuss"):
        from concrete_tpu.core import bootstrap_nuss as bsn

        Bn = min(B, 256)  # large-N rows: batch capped by device memory
        for N in ([8192] if args.quick else [8192, 16384]):
            for bits_n in (32, 64):
                dtn = np.uint32 if bits_n == 32 else np.uint64
                cfgN = bs.ServerConfig(
                    lwe_dimension=100, glwe_dimension=1, polynomial_size=N,
                    pbs_base_log=2, pbs_level=3, ks_base_log=2, ks_level=5,
                    bits=bits_n)
                planN = bsn.NussPlan.from_config(cfgN)
                bsk_rawN = rng.integers(
                    0, 1 << bits_n, size=(100, 3, 2, 2, N), dtype=dtn)
                t0 = time.perf_counter()
                ringsN = jnp.asarray(bsn.bsk_to_nuss(bsk_rawN, cfgN))
                record(f"bsk_to_nuss_N{N}_u{bits_n}", f"n100_l3_L{planN.l}",
                       time.perf_counter() - t0, 1, batch=Bn)
                lutN = bs.trivial_lut_constant(
                    cfgN, dtn(1) << dtn(bits_n - 3))
                ctsN = jnp.asarray(rng.integers(
                    0, 1 << bits_n, size=(Bn, 101), dtype=dtn))
                fN = jax.jit(lambda r, c, cfg=cfgN, lut=lutN, L=planN.l:
                             bsn.bootstrap_nuss(cfg, r, lut, c, l=L))
                record(f"pbs_nuss_N{N}_u{bits_n} (L={planN.l})", "n100_l3",
                       _timeit(fN, ringsN, ctsN), Bn, batch=Bn)

    # PBS sweep over polynomial sizes — the reference's engine-bench grid
    # (concrete-benchmark/src/generics/lwe_ciphertext_discarding_bootstrap.rs:
    #  n=100, B=2^2, l=3, N in {256..4096})
    if wanted("pbs_sweep"):
        from concrete_tpu.core import bootstrap_mxu as bsx2

        for N in ([512, 1024] if args.quick else [256, 512, 1024, 2048, 4096]):
            cfg = bs.ServerConfig(
                lwe_dimension=100, glwe_dimension=1, polynomial_size=N,
                pbs_base_log=2, pbs_level=3, ks_base_log=2, ks_level=5)
            bsk_raw = rng.integers(0, 1 << 32, size=(100, 3, 2, 2, N), dtype=np.uint32)
            rings = jnp.asarray(bsx2.bsk_to_mxu(bsk_raw, cfg))
            lut = bs.trivial_lut_constant(cfg, np.uint32(1 << 29))
            cts = jnp.asarray(rng.integers(0, 1 << 32, size=(B, 101), dtype=np.uint32))
            f = jax.jit(lambda r, c, cfg=cfg, lut=lut: bsx2.bootstrap_mxu(cfg, r, lut, c))
            record(f"pbs_sweep_N{N}", "n100_b4_l3", _timeit(f, rings, cts), B)

    # host-side CSPRNG throughput (native AES-CTR when available);
    # parameter-independent, so measured once
    if wanted("csprng"):
        from concrete_tpu.csprng import aes as aes_mod

        rk = aes_mod.key_schedule(bytes(range(16)))
        nbytes = 1 << 24
        aes_mod.ctr_fill(rk, 0, 1024)  # warm
        t0 = time.perf_counter()
        aes_mod.ctr_fill(rk, 7, nbytes // 16)
        dt = time.perf_counter() - t0
        record("csprng_ctr_fill", "-", dt, nbytes)

        # generator-level throughput, the concrete-csprng criterion analog
        # (concrete-csprng/benches/benchmark.rs:4-31: unbounded parent vs
        # bounded fork child; the bound bookkeeping is the delta)
        from concrete_tpu.csprng import AesCtrGenerator

        g = AesCtrGenerator(key=1234)
        g.generate_bytes(4096)  # warm
        t0 = time.perf_counter()
        g.generate_bytes(nbytes)
        record("csprng_unbounded_bytes", "-", time.perf_counter() - t0, nbytes)
        child = AesCtrGenerator(key=1234).try_fork(1, nbytes + 4096)[0]
        child.generate_bytes(4096)
        t0 = time.perf_counter()
        child.generate_bytes(nbytes)
        record("csprng_bounded_bytes", "-", time.perf_counter() - t0, nbytes)

    # full boolean key generation (client + server keys): the
    # concrete-boolean `gen_keys` analog (lib.rs:96) — host-side AES mask
    # material + BSK/KSK encryption dominate
    if wanted("gen_keys"):
        from concrete_tpu import boolean

        for kname, kparams in param_sets.items():
            t0 = time.perf_counter()
            boolean.gen_keys(kparams, secret_seed=1, mask_seed=2, noise_seed=3)
            record("gen_keys", kname, time.perf_counter() - t0, 1)

    return results


if __name__ == "__main__":
    main()
