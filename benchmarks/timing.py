"""Device timing helpers for the benchmarks: every measurement ends in
jax.block_until_ready, so it covers the device's work and not only the
enqueue."""

import time

import jax


def time_device(step, init, reps=32, warmup=True):
    """step: x -> x (same structure). Returns seconds per step.

    Chains `reps` applications inside one jit (one dispatch), so host
    dispatch overhead is amortized over the chain.
    """

    @jax.jit
    def run(x):
        def body(c, _):
            return step(c), None

        out, _ = jax.lax.scan(body, x, None, length=reps)
        return out

    if warmup:
        jax.block_until_ready(run(init))
    t0 = time.perf_counter()
    jax.block_until_ready(run(init))
    return (time.perf_counter() - t0) / reps


def time_fn(fn, *args, reps=5):
    """Seconds per call of fn(*args), after one warm-up call. For big
    single computations where chaining isn't possible."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps
