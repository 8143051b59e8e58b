"""Smoke run of concrete-tpu on one NVIDIA GPU, through the entry points a
user calls, at the full widths of the shipped parameter sets.

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --four-cards    # four cards: the sharded pipelines only

Phases (one card):
  device    the default device is a GPU (never falls back to the CPU)
  gates     boolean AND/XOR/NAND/MUX at B=2048 on TFHE_LIB, DEFAULT and
            TPU128 with real keys: decrypted against the plaintext, and the
            resolved ("auto") backend bit-identical to the other of mxu/ntt;
            compile seconds and median steady seconds per call
  trace     a profiler trace of one TFHE_LIB AND call at B=2048: device
            busy share and the device ops that take the time
  serving   a warmed TFHE_LIB server answers mixed-size requests without
            compiling again
  u64       a 4-bit lookup table through the u64 PBS (LWE128_630 /
            RLWE128_1024_1) on B=1024, mxu bit-identical to ntt
  large-n   one gate at N=8192 through nuss, bit-identical to ntt
With --four-cards: gate_pipeline_dp at dp=4 and gate_pipeline_dp_tp_mxu at
dp=2 x tp=2 on TFHE_LIB, B=8192, bit-identical to the one-card gate.

Every phase prints one line with its numbers and the card's name and power
limit. The last line of standard output is one JSON object
{"ok": true, "device": {...}}; it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import sys
import time


class Smoke:
    def __init__(self, card: str):
        self.card = card
        self.t0 = time.perf_counter()

    def emit(self, phase: str, **fields):
        parts = [f"{k}={v}" for k, v in fields.items()]
        print(f"[{phase}] " + " ".join(parts)
              + f" | t={time.perf_counter() - self.t0:.1f}s"
              + f" | card: {self.card}", flush=True)


def _block(x):
    import jax

    return jax.block_until_ready(x)


def timed(fn):
    """(result, seconds) of one call, device-synchronized."""
    t0 = time.perf_counter()
    out = _block(fn())
    return out, time.perf_counter() - t0


def steady(fn, reps: int) -> float:
    """Median seconds of `reps` device-synchronized calls."""
    times = []
    for _ in range(reps):
        times.append(timed(fn)[1])
    return statistics.median(times)


def dot_lowering(hlo: str) -> dict:
    """What an optimized HLO module made of its matrix products: every
    cuBLAS GEMM custom call and every remaining dot, as
    "target:out<-lhs,rhs" element types, and how many f32 values the module
    holds at all (the gate path is integer end to end)."""
    types = dict(re.findall(r"%([\w.\-]+) = \(?([a-z0-9]+)\[", hlo))
    gemms = re.findall(
        r"= \(?([a-z0-9]+)\[[^\n]*? custom-call\(%([\w.\-]+), %([\w.\-]+)\)"
        r'[^\n]*?custom_call_target="([^"]+)"', hlo)
    dots = re.findall(r"= ([a-z0-9]+)\[[^\]]*\]\S* dot\(%([\w.\-]+), %([\w.\-]+)",
                      hlo)
    products = [f"{t}:{o}<-{types.get(x, '?')},{types.get(y, '?')}"
                for o, x, y, t in gemms if "gemm" in t or "matmul" in t]
    products += [f"dot:{o}<-{types.get(x, '?')},{types.get(y, '?')}"
                 for o, x, y in dots]
    return {"products": sorted(set(products)),
            "f32_values": hlo.count("f32[")}


def gates_phase(sm: Smoke, name: str, params, batch: int, seed: int,
                reps: int, dump_hlo: str | None = None):
    """Four gates through the resolved backend and the other of mxu/ntt."""
    import jax.numpy as jnp
    import numpy as np

    from concrete_tpu import boolean
    from concrete_tpu.boolean import server_key

    t0 = time.perf_counter()
    cks, sks = boolean.gen_keys(params, secret_seed=seed, mask_seed=seed + 1,
                                noise_seed=seed + 2)
    keygen_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    a, b, c = (rng.integers(0, 2, batch).astype(bool) for _ in range(3))
    ca, cb, cc = (jnp.asarray(cks.encrypt(x, mask_seed=seed + 10 + i,
                                          noise_seed=seed + 20 + i))
                  for i, x in enumerate((a, b, c)))
    want = {"and": a & b, "xor": a ^ b, "nand": ~(a & b),
            "mux": np.where(c, a, b)}
    calls = {"and": lambda k: k.and_(ca, cb), "xor": lambda k: k.xor(ca, cb),
             "nand": lambda k: k.nand(ca, cb),
             "mux": lambda k: k.mux(cc, ca, cb)}
    resolved = sks.resolved_backend()
    backends = [resolved] + [x for x in ("mxu", "ntt") if x != resolved]
    outs, rows = {}, {}
    for backend in backends:
        k = sks if backend == resolved else dataclasses.replace(
            sks, backend=backend, _bsk_ntt=None, _bsk_mxu=None,
            _bsk_nuss=None, _ksk8=None)
        _, conv_s = timed(lambda: (k._bootstrap_keys(), k._keyswitch_key()))
        first, med = {}, {}
        for gate, call in calls.items():
            out, first[gate] = timed(lambda: call(k))
            med[gate] = steady(lambda: call(k), reps)
            got = np.asarray(out)
            if not np.array_equal(cks.decrypt(got), want[gate]):
                raise AssertionError(f"{name} {backend} {gate}: wrong decryption")
            outs[(backend, gate)] = got
        rows[backend] = med
        sm.emit("gates", preset=name, backend=backend,
                auto=backend == resolved, B=batch, keygen_s=f"{keygen_s:.2f}",
                key_convert_s=f"{conv_s:.2f}",
                compile_2in_s=f"{first['and'] - med['and']:.2f}",
                compile_mux_s=f"{first['mux'] - med['mux']:.2f}",
                **{f"{g}_ms": f"{med[g] * 1e3:.2f}" for g in calls},
                decrypt_ok=True)
    for gate in calls:
        for backend in backends[1:]:
            if not np.array_equal(outs[(backend, gate)], outs[(resolved, gate)]):
                raise AssertionError(
                    f"{name} {gate}: {backend} differs from {resolved}")
    cfg = sks.cfg
    pipe = server_key._gate_pipeline(cfg, resolved)
    scale, offset = server_key._GATE_LIN["and"]
    hlo = pipe.lower(sks._bootstrap_keys(), sks._keyswitch_key(), scale,
                     offset, ca, cb).compile().as_text()
    if dump_hlo:
        with open(f"{dump_hlo}/gate_{name}_{resolved}.hlo.txt", "w") as f:
            f.write(hlo)
    low = dot_lowering(hlo)
    if low["f32_values"]:
        raise AssertionError(f"{name}: f32 values on the gate path: {low}")
    faster = min(rows, key=lambda bk: rows[bk]["and"])
    sm.emit("gates", preset=name, resolved=resolved, faster_and=faster,
            bit_identical="/".join(backends), dot_lowering=json.dumps(low))
    return cks, sks, (ca, cb)


def device_ops(xplane: str, plane_prefix: str = "/device:GPU"):
    """(op events, module events) of the first device plane of a profiler
    trace: [(name, start_ns, duration_ns)]."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane)
    for plane in pd.planes:
        if plane.name.startswith(plane_prefix):
            lines = {line.name: line for line in plane.lines}
            pick = lambda n: [(e.name, e.start_ns, e.duration_ns)  # noqa: E731
                              for e in lines[n].events] if n in lines else []
            ops = pick("XLA Ops") or [
                ev for n in lines if n.startswith("Stream") for ev in pick(n)]
            return ops, pick("XLA Modules")
    raise AssertionError(f"no {plane_prefix} plane in the trace")


def trace_phase(sm: Smoke, sks, cts, plane_prefix: str = "/device:GPU"):
    """Profile one warmed AND call: device busy share over the module's
    window and the device ops that take the time."""
    import glob
    import os
    import tempfile

    import jax

    a, b = cts
    _block(sks.and_(a, b))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        _, wall = timed(lambda: sks.and_(a, b))
        jax.profiler.stop_trace()
        xplane = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                           recursive=True)[0]
        ops, modules = device_ops(xplane, plane_prefix)
    if not ops:
        raise AssertionError("the trace holds no device op")
    spans = sorted((t, t + dur) for _, t, dur in ops)
    busy, end = 0.0, -1.0
    for t, u in spans:
        if u > end:
            busy += u - max(t, end)
            end = u
    if modules:
        window = max(t + u for _, t, u in modules) - min(t for _, t, _ in modules)
    else:
        window = spans[-1][1] - spans[0][0]
    by_name = {}
    for name, _, dur in ops:
        by_name[name] = by_name.get(name, 0.0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    sm.emit("trace", preset="TFHE_LIB", gate="and", wall_ms=f"{wall * 1e3:.2f}",
            device_window_ms=f"{window / 1e6:.2f}",
            device_busy_ms=f"{busy / 1e6:.2f}",
            idle_share=f"{1 - busy / window:.4f}", n_ops=len(ops),
            top_ops_ms=json.dumps({k: round(v / 1e6, 3) for k, v in top}))


def serving_phase(sm: Smoke, cks, sks, seed: int):
    """Warm one tier, then serve mixed request sizes with no new compile."""
    import numpy as np

    from concrete_tpu.boolean import server_key

    t = sks.warmup(batch_sizes=(2048,), gates=("and", "xor"))
    pipe = server_key._gate_pipeline(sks.cfg, sks.resolved_backend())
    compiled_before = pipe._cache_size()
    rng = np.random.default_rng(seed)
    lat = []
    for i, size in enumerate((3, 17, 500, 2048, 64)):
        if sks._pad_size(size) != 2048:
            raise AssertionError(f"request {size} misses the warmed tier")
        a = rng.integers(0, 2, size).astype(bool)
        b = rng.integers(0, 2, size).astype(bool)
        ct_a, ct_b = cks.encrypt(a), cks.encrypt(b)
        gate = "and" if i % 2 == 0 else "xor"
        t0 = time.perf_counter()
        out = np.asarray(getattr(sks, "and_" if gate == "and" else "xor")(
            ct_a, ct_b))
        lat.append(time.perf_counter() - t0)
        if not np.array_equal(cks.decrypt(out), a & b if gate == "and" else a ^ b):
            raise AssertionError(f"served {gate} of {size}: wrong decryption")
    if pipe._cache_size() != compiled_before:
        raise AssertionError("a gate pipeline compiled after warm-up")
    sm.emit("serving", preset="TFHE_LIB", warmup_s=json.dumps(
        {f"{g}@{b}": round(s, 2) for (g, b), s in t.items()}),
        request_sizes="3,17,500,2048,64",
        latency_ms=",".join(f"{x * 1e3:.1f}" for x in lat),
        compiles_after_warmup=0, decrypt_ok=True)


def u64_phase(sm: Smoke, batch: int, seed: int, lwe_params=None,
              rlwe_params=None):
    """4-bit lookup table through the u64 PBS (LWE128_630 / RLWE128_1024_1
    unless given), decoded under the output (RLWE) key."""
    import numpy as np

    from concrete_tpu.highlevel import (LWE128_630, LWEBSK,
                                        RLWE128_1024_1, Encoder,
                                        LWESecretKey, RLWESecretKey,
                                        VectorLWE)

    sk = LWESecretKey.new(lwe_params or LWE128_630, secret_seed=seed)
    rlwe_sk = RLWESecretKey.new(rlwe_params or RLWE128_1024_1,
                                secret_seed=seed + 1)
    bsk = LWEBSK.new(sk, rlwe_sk, base_log=7, level=3, mask_seed=seed + 2,
                     noise_seed=seed + 3)
    enc_in = Encoder.new(0.0, 15.0, nb_bit_precision=4, nb_bit_padding=1)
    enc_out = Encoder.new(0.0, 15.0, nb_bit_precision=4, nb_bit_padding=1)
    table = lambda x: float((3 * int(round(x)) + 1) % 16)  # noqa: E731
    xs = np.random.default_rng(seed).integers(0, 16, batch).astype(float)
    v = VectorLWE.encode_encrypt(sk, xs, enc_in, mask_seed=seed + 6,
                                 noise_seed=seed + 7)
    resolved = bsk.resolved_backend()
    results, fields = {}, {}
    for backend in [resolved] + [x for x in ("mxu", "ntt") if x != resolved]:
        k = bsk if backend == resolved else dataclasses.replace(
            bsk, backend=backend, _bsk_ntt=None, _bsk_mxu=None, _bsk_nuss=None)
        results[backend], first = timed(
            lambda: v.bootstrap_all_with_function(k, table, enc_out))
        med = steady(lambda: v.bootstrap_all_with_function(k, table, enc_out),
                     1)
        fields[f"{backend}_first_s"] = f"{first:.2f}"
        fields[f"{backend}_pbs_ms"] = f"{med * 1e3:.2f}"
    for backend, res in results.items():
        if not np.array_equal(res.data, results[resolved].data):
            raise AssertionError(f"u64 PBS: {backend} differs from {resolved}")
    got = np.round(results[resolved].decrypt_decode(
        rlwe_sk.to_lwe_secret_key()))
    want = np.array([table(x) for x in xs])
    bad = int(np.sum(got != want))
    if bad:
        raise AssertionError(f"u64 LUT: {bad}/{batch} slots decode wrong")
    sm.emit("u64", params="LWE128_630/RLWE128_1024_1 bl=7 l=3", B=batch,
            resolved=resolved, bit_identical="/".join(results), decode_ok=True,
            **fields)


def large_n_phase(sm: Smoke, params, batch: int, seed: int, reps: int):
    """One AND gate at a large N through nuss and ntt."""
    import jax.numpy as jnp
    import numpy as np

    from concrete_tpu import boolean

    t0 = time.perf_counter()
    cks, sks = boolean.gen_keys(params, secret_seed=seed, mask_seed=seed + 1,
                                noise_seed=seed + 2)
    keygen_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, 2, batch).astype(bool) for _ in range(2))
    ca = jnp.asarray(cks.encrypt(a, mask_seed=seed + 3, noise_seed=seed + 4))
    cb = jnp.asarray(cks.encrypt(b, mask_seed=seed + 5, noise_seed=seed + 6))
    resolved = sks.resolved_backend()
    outs, fields = {}, {}
    for backend in ("nuss", "ntt"):
        k = dataclasses.replace(sks, backend=backend, _bsk_ntt=None,
                                _bsk_mxu=None, _bsk_nuss=None, _ksk8=None)
        _, conv = timed(lambda: (k._bootstrap_keys(), k._keyswitch_key()))
        out, first = timed(lambda: k.and_(ca, cb))
        med = steady(lambda: k.and_(ca, cb), reps)
        outs[backend] = np.asarray(out)
        if not np.array_equal(cks.decrypt(outs[backend]), a & b):
            raise AssertionError(f"large N {backend}: wrong decryption")
        fields.update({f"{backend}_key_convert_s": f"{conv:.2f}",
                       f"{backend}_compile_s": f"{first - med:.2f}",
                       f"{backend}_and_ms": f"{med * 1e3:.2f}"})
    if not np.array_equal(outs["nuss"], outs["ntt"]):
        raise AssertionError("large N: nuss differs from ntt")
    sm.emit("large-n", N=params.polynomial_size, k=params.glwe_dimension,
            bl=params.pbs_base_log, l=params.pbs_level,
            n=params.lwe_dimension, B=batch,
            resolved=resolved, keygen_s=f"{keygen_s:.2f}",
            bit_identical="nuss/ntt", decrypt_ok=True, **fields)


def four_cards_phase(sm: Smoke, params, batch: int, seed: int):
    """dp=4 and dp=2 x tp=2 gate pipelines against the one-card gate."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from concrete_tpu import boolean
    from concrete_tpu.boolean.client_key import PLAINTEXT_TRUE
    from concrete_tpu.core import bootstrap as bs
    from concrete_tpu.parallel import mesh as pm

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found "
                         f"{len(jax.devices())}")
    cks, sks = boolean.gen_keys(params, secret_seed=seed,
                                mask_seed=seed + 1, noise_seed=seed + 2)
    sks = dataclasses.replace(sks, backend="mxu")
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, 2, batch).astype(bool) for _ in range(2))
    ca = cks.encrypt(a, mask_seed=seed + 3, noise_seed=seed + 4)
    cb = cks.encrypt(b, mask_seed=seed + 5, noise_seed=seed + 6)
    ref, ref_s = timed(lambda: sks.and_(jnp.asarray(ca), jnp.asarray(cb)))
    ref = np.asarray(ref)
    if not np.array_equal(cks.decrypt(ref), a & b):
        raise AssertionError("one-card reference: wrong decryption")
    neg_eighth = np.uint32((-(1 << 29)) % (1 << 32))
    lin = (ca + cb).astype(np.uint32)
    lin[..., -1] += neg_eighth
    lin = jnp.asarray(lin)
    lut = bs.trivial_lut_constant(sks.cfg, PLAINTEXT_TRUE)
    runs = {
        "dp4": (pm.gate_pipeline_dp(sks.cfg, pm.make_mesh(4, 1), "mxu"),
                sks.bsk_mxu, sks._keyswitch_key()),
        "dp2xtp2": (pm.gate_pipeline_dp_tp_mxu(sks.cfg, pm.make_mesh(2, 2)),
                    sks.bsk_mxu, sks.ksk),
    }
    fields = {"one_card_first_s": f"{ref_s:.2f}"}
    for name, (pipe, bsk, ksk) in runs.items():
        out, first = timed(lambda: pipe(bsk, ksk, lut, lin))
        med = steady(lambda: pipe(bsk, ksk, lut, lin), 3)
        got = np.asarray(out)
        if not np.array_equal(got, ref):
            raise AssertionError(f"{name}: differs from the one-card gate")
        if not np.array_equal(cks.decrypt(got), a & b):
            raise AssertionError(f"{name}: wrong decryption")
        fields.update({f"{name}_first_s": f"{first:.2f}",
                       f"{name}_ms": f"{med * 1e3:.2f}",
                       f"{name}_gates_per_s": f"{batch / med:.0f}"})
    sm.emit("four-cards", B=batch,
            bit_identical_to_one_card="dp4,dp2xtp2", decrypt_ok=True,
            **fields)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded pipelines on four cards")
    ap.add_argument("--dump-hlo", metavar="DIR",
                    help="write each gate pipeline's optimized HLO here")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (default device is {dev.platform}: "
              f"{dev.device_kind}); refusing to run", file=sys.stderr)
        return 2
    from concrete_tpu import native
    from concrete_tpu.profiling import card_description

    sm = Smoke(card_description())
    print(f"card: {sm.card}", flush=True)
    sm.emit("device", platform=dev.platform, kind=repr(dev.device_kind),
            count=len(devices), jax=jax.__version__,
            native_aes=native.load_aes() is not None)

    from concrete_tpu.params import (DEFAULT_PARAMETERS, TFHE_LIB_PARAMETERS,
                                     TPU128_PARAMETERS)

    t_all = time.perf_counter()
    if args.four_cards:
        four_cards_phase(sm, TFHE_LIB_PARAMETERS, 8192, 41)
    else:
        cks, sks, cts = gates_phase(sm, "TFHE_LIB", TFHE_LIB_PARAMETERS,
                                    2048, 11, 3, args.dump_hlo)
        trace_phase(sm, sks, cts)
        serving_phase(sm, cks, sks, 12)
        gates_phase(sm, "DEFAULT", DEFAULT_PARAMETERS, 2048, 21, 3,
                    args.dump_hlo)
        gates_phase(sm, "TPU128", TPU128_PARAMETERS, 2048, 31, 3,
                    args.dump_hlo)
        u64_phase(sm, 1024, 51)
        large_n_phase(sm, dataclasses.replace(
            TFHE_LIB_PARAMETERS, polynomial_size=8192), 64, 61, 3)
    sm.emit("done", wall_s=f"{time.perf_counter() - t_all:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
