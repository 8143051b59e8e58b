"""Profiling and roofline accounting for the server-side kernels.

The reference's performance tooling is criterion benchmarks; here the
equivalents are jax.profiler traces plus an analytic roofline model: this
module computes per-op work from shapes (int8 matrix-product operations,
u32 lane operations and device-memory bytes) so that measured times can be
compared with the device's published peaks.

Peaks come from one table keyed by `device_kind`; a device missing from it
is an error, not a default.

Example:
    >>> from concrete_tpu.profiling import ntt_roofline
    >>> r = ntt_roofline(1024, 2, 3, 256)
    >>> r.bound_seconds("NVIDIA H100 80GB HBM3") > 0
    True
    >>> peaks("Unknown Accelerator")
    Traceback (most recent call last):
    ...
    ValueError: no published peaks for device kind 'Unknown Accelerator'
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

# Published dense peaks (NVIDIA H100 data sheet, SXM part, no sparsity; they
# assume the full 700 W power limit): int8 tensor-core operations per second
# and device-memory bytes per second.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1.979e15,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_kind: str) -> dict:
    """The published peaks of `device_kind` (jax.Device.device_kind)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}") from None


def card_description() -> str:
    """Name and power limit of every visible NVIDIA card, as `nvidia-smi`
    reports them (a card set below its maximum power limit runs slower
    under load, so every measurement carries this line)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


@dataclasses.dataclass
class Roofline:
    """Work accounting for one op invocation."""

    name: str
    lane_ops: float          # elementary u32 vector-unit ops
    hbm_bytes: float         # minimum device-memory traffic (in+out once)
    int8_ops: float = 0.0    # int8 matrix-product ops (2 per MAC)

    def bound_seconds(self, device_kind: str) -> float:
        """Speed-of-light time on `device_kind`: the larger of the int8
        matrix-product bound and the memory bound. The data sheet gives no
        u32 lane rate, so `lane_ops` does not enter the bound (it stays a
        lower bound)."""
        pk = peaks(device_kind)
        return max(self.int8_ops / pk["int8_ops_per_s"],
                   self.hbm_bytes / pk["hbm_bytes_per_s"])


# Cost model constants (ops per element) for the u32 Montgomery pipeline.
MONT_MUL_OPS = 12          # 2x mul32_hilo (4 mults + folds) + REDC adds/selects
MOD_ADD_OPS = 3
BUTTERFLY_OPS = MONT_MUL_OPS + 2 * MOD_ADD_OPS + 4  # rolls/selects amortized


def ntt_roofline(n: int, n_polys: int, n_primes: int, batch: int) -> Roofline:
    """One batched forward (or inverse) NTT."""
    import math

    stages = int(math.log2(n))
    elems = batch * n_polys * n_primes * n
    ops = elems * (stages * BUTTERFLY_OPS + MONT_MUL_OPS)  # + twist
    return Roofline("ntt", ops, elems * 4 * 2)


def external_product_roofline(cfg, batch: int) -> Roofline:
    """One batched external product (decompose + NTT + MAC + INTT + CRT)."""
    import math

    n = cfg.polynomial_size
    P = len(cfg.primes)
    l, ks1 = cfg.pbs_level, cfg.glwe_size
    stages = int(math.log2(n))
    fwd = batch * l * ks1 * P * n * (stages * BUTTERFLY_OPS + MONT_MUL_OPS)
    mac = batch * l * ks1 * ks1 * P * n * (MONT_MUL_OPS + MOD_ADD_OPS)
    inv = batch * ks1 * P * n * (stages * BUTTERFLY_OPS + MONT_MUL_OPS)
    dec = batch * ks1 * n * (l * 8 + 4)
    crt = batch * ks1 * n * (P - 1) * (2 * MONT_MUL_OPS + 8)
    ggsw_bytes = l * ks1 * ks1 * P * n * 4
    io_bytes = batch * ks1 * n * 4 * 2 + ggsw_bytes
    return Roofline("external_product", fwd + mac + inv + dec + crt, io_bytes)


def pbs_roofline(cfg, batch: int) -> Roofline:
    ep = external_product_roofline(cfg, batch)
    n_iter = cfg.lwe_dimension
    rot = batch * cfg.glwe_size * cfg.polynomial_size * 4 * 12  # barrel stages
    return Roofline("pbs", n_iter * (ep.lane_ops + rot), n_iter * ep.hbm_bytes)


@contextlib.contextmanager
def trace(path: str):
    """jax.profiler trace context (view with tensorboard / xprof)."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def measure(fn, *args, reps: int = 3):
    """Wall-clock an already-jitted function (device-synchronized)."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def report_pbs_efficiency(cfg, batch: int, measured_seconds: float,
                          device_kind: str) -> dict:
    """Compare a measured NTT-path PBS time against its roofline."""
    rl = pbs_roofline(cfg, batch)
    sol = rl.bound_seconds(device_kind)
    return {
        "lane_ops": rl.lane_ops,
        "hbm_bytes": rl.hbm_bytes,
        "speed_of_light_s": sol,
        "measured_s": measured_seconds,
        "efficiency": sol / measured_seconds if measured_seconds else 0.0,
    }


def mxu_external_product_roofline(
    n_iterations: int,
    poly_size: int,
    glwe_size: int,
    level: int,
    n_sub: int,
    n_limbs: int,
    batch: int,
) -> Roofline:
    """Blind rotation on the toeplitz-matmul path (core/bootstrap_mxu.py).

    The dominant term is the int8 dot per CMux:
    [B, R*N] x [R*N, (k+1)*n_limbs*N] with R = level*(k+1)*n_sub. Memory
    traffic per iteration: the built table out+in, the dot output S out+in,
    the digit matrix, and the accumulator update.

    >>> r = mxu_external_product_roofline(630, 1024, 2, 3, 1, 4, 2048)
    >>> r.int8_ops == 2 * 630 * 2048 * 6144 * 8192
    True
    """
    big_n = poly_size
    rows = level * glwe_size * n_sub * big_n
    cols = glwe_size * n_limbs * big_n
    macs = n_iterations * batch * rows * cols
    rhs_bytes = rows * cols
    s_bytes = batch * cols * 4
    acc_bytes = glwe_size * batch * big_n * 4
    per_iter_hbm = 2 * rhs_bytes + 2 * s_bytes + batch * rows + 3 * acc_bytes
    return Roofline(
        name=f"mxu_blind_rotate(N={big_n}, B={batch})",
        lane_ops=0.0,
        hbm_bytes=float(n_iterations * per_iter_hbm),
        int8_ops=2.0 * macs,
    )
