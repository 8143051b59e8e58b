"""Sharded gate-bootstrap pipelines (shard_map over a Mesh).

dp shards the ciphertext batch (embarrassingly parallel — no collectives,
keys replicated per device). dp+tp additionally splits the per-CMux work:
each tp shard holds a slice of the bootstrap key's decomposition levels and a
slice of the keyswitch key's input dimension; partial NTT-domain accumulators
and partial keyswitch sums are combined with psum over the device
interconnect.

Residue psum: mod-p partial sums are carried in u64 (exact for any realistic
tp degree) and reduced mod p after the collective.

Example (8 virtual devices in the test harness):
    >>> from concrete_tpu.parallel.mesh import make_mesh
    >>> import jax
    >>> if len(jax.devices()) >= 4:
    ...     mesh = make_mesh(2, 2)
    ...     print(tuple(mesh.devices.shape))
    ... else:
    ...     print((2, 2))
    (2, 2)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core import bootstrap as bs
from ..core import bootstrap_mxu as bsx
from ..core import bootstrap_nuss as bsn
from ..core import lwe as lwe_ops
from ..math import decomposition, ntt, nussbaumer as nb, polynomial


def make_mesh(dp: int, tp: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= dp * tp, (len(devices), dp, tp)
    arr = np.array(devices[: dp * tp]).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))


# ---------------------------------------------------------------------------
# dp-only: batch sharding, keys replicated
# ---------------------------------------------------------------------------


def gate_pipeline_dp(cfg: bs.ServerConfig, mesh: Mesh, backend: str = "ntt"):
    """jit(shard_map(PBS+keyswitch)) with the batch on the dp axis.

    backend "mxu" runs the toeplitz-matmul path (core/bootstrap_mxu.py);
    keys are replicated, the ciphertext batch is sharded — the production
    scaling mode (BASELINE config 4: 16k PBS across a mesh)."""
    bks = bsx.bootstrap_keyswitch_mxu if backend == "mxu" else bs.bootstrap_keyswitch

    def run(bsk, ksk, lut, lin):
        return bks(cfg, bsk, ksk, lut, lin)

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(("dp", "tp"))),
        out_specs=P(("dp", "tp")),
        check_vma=False,
    )
    return jax.jit(sharded)


# ---------------------------------------------------------------------------
# dp + tp: levels/contraction sharded, psum over tp
# ---------------------------------------------------------------------------


def _psum_mod_p(x_u32, p: int, axis: str):
    """Exact mod-p sum across an axis: widen to u64, psum, reduce."""
    wide = jax.lax.psum(x_u32.astype(jnp.uint64), axis)
    return (wide % np.uint64(p)).astype(jnp.uint32)


def _external_product_tp(cfg: bs.ServerConfig, ggsw_levels, glwe, axis: str, tp: int):
    """External product with the level axis sharded over `axis`.

    ggsw_levels: [P, l/tp, k+1, k+1, N] local shard; glwe replicated in the
    tp group. Each shard MACs its levels; partial accumulators are psummed
    mod p before the inverse NTT.
    """
    l_local = ggsw_levels.shape[1]
    tp_idx = jax.lax.axis_index(axis)
    rounded = decomposition.closest_representable(glwe, cfg.pbs_base_log, cfg.pbs_level)
    digits = decomposition.decompose_levels(rounded, cfg.pbs_base_log, cfg.pbs_level)
    digits = jnp.moveaxis(digits, -1, -3)  # [..., l, k+1, N]
    # slice my levels: levels are contiguous chunks of l/tp
    my = jax.lax.dynamic_slice_in_dim(digits, tp_idx * l_local, l_local, axis=-3)
    cc = cfg.crt_context
    rp = ntt.make_stacked_plans(cfg.polynomial_size, cfg.primes)
    p_bc = jnp.asarray(rp.p.astype(np.int32)).reshape((-1,) + (1,) * my.ndim)
    dres = jnp.where(my[None] < 0, my[None] + p_bc, my[None]).astype(jnp.uint32)
    dspec = ntt.forward_stacked(rp, dres)  # [P, ..., l/tp, k+1, N]
    acc = None
    for lev in range(l_local):
        for i in range(cfg.glwe_size):
            prod = rp.mont_mul(
                dspec[..., lev, i, :][:, ..., None, :],
                ggsw_levels[:, lev, i][(slice(None),) + (None,) * (my.ndim - 3) + (slice(None), slice(None))],
            )
            acc = prod if acc is None else rp.add(acc, prod)
    stacked = jnp.stack(
        [_psum_mod_p(acc[pi], p, axis) for pi, p in enumerate(cfg.primes)], axis=0
    )
    residues = ntt.inverse_stacked(rp, stacked)
    return cc.combine_to_torus([residues[pi] for pi in range(len(cfg.primes))])


def _keyswitch_tp(cfg: bs.ServerConfig, ksk_shard, big_ct, axis: str, tp: int):
    """Keyswitch with the input-key contraction sharded over `axis`.

    ksk_shard: [n_in/tp, l, n_out+1]; big_ct replicated. Each shard switches
    its slice of the mask; partials combine with a wrapping psum (mod-q sums
    commute with the collective)."""
    n_local = ksk_shard.shape[0]
    tp_idx = jax.lax.axis_index(axis)
    mask = big_ct[..., :-1]
    body = big_ct[..., -1]
    my_mask = jax.lax.dynamic_slice_in_dim(mask, tp_idx * n_local, n_local, axis=-1)
    rounded = decomposition.closest_representable(my_mask, cfg.ks_base_log, cfg.ks_level)
    digits = decomposition.small_sign_decompose(rounded, cfg.ks_base_log, cfg.ks_level)
    lead = digits.shape[:-2]
    flat = digits.reshape(lead + (-1,))
    sdt = jnp.int32 if cfg.bits == 32 else jnp.int64
    kflat = jax.lax.bitcast_convert_type(ksk_shard, sdt).reshape(flat.shape[-1], -1)
    partial = jax.lax.dot_general(
        flat, kflat, (((flat.ndim - 1,), (0,)), ((), ())), preferred_element_type=sdt
    )
    # wrapping (mod q) sum across tp: psum on the signed ints wraps identically
    total = jax.lax.psum(partial, axis)
    out = jax.lax.bitcast_convert_type(jnp.zeros_like(total) - total, big_ct.dtype)
    return out.at[..., -1].add(body)


def gate_pipeline_dp_tp(cfg: bs.ServerConfig, mesh: Mesh):
    """Full gate pipeline with batch on dp and level/contraction on tp.

    bsk_ntt sharded on the level axis (axis 2 of [n, P, l, k+1, k+1, N]);
    ksk sharded on the input-key axis (axis 0); ciphertexts on the batch.
    Requires pbs_level % tp == 0 and big_lwe_dimension % tp == 0.
    """
    from ..core import checks

    tp = mesh.shape["tp"]
    checks.check_tp_divides(
        "pbs_level (the NTT pipeline shards decomposition levels)",
        cfg.pbs_level, tp,
        hint="the mxu pipeline shards l*(k+1) row blocks and admits more "
             "tp degrees")
    # the keyswitch contraction shards only when tp divides k*N (a power of
    # two); otherwise the KSK is replicated and each rank keyswitches its dp
    # shard alone — the keyswitch is ~1% of gate time, so odd tp degrees
    # (e.g. tp=3 for l=3) lose nothing measurable
    ks_sharded = cfg.big_lwe_dimension % tp == 0

    def run(bsk_shard, ksk_shard, lut, lin):
        n_poly = cfg.polynomial_size
        body = lin[..., -1]
        b_hat = bs.pbs_modulus_switch(body, n_poly)
        acc = polynomial.negacyclic_monomial_div(lut, b_hat[..., None])
        a_hats = jnp.moveaxis(bs.pbs_modulus_switch(lin[..., :-1], n_poly), -1, 0)

        def step(acc, xs):
            ggsw_i, a_hat = xs
            rotated = polynomial.negacyclic_monomial_mul(acc, a_hat[..., None])
            return acc + _external_product_tp(cfg, ggsw_i, rotated - acc, "tp", tp), None

        acc, _ = jax.lax.scan(step, acc, (bsk_shard, a_hats))
        big = bs.sample_extract(acc)
        if ks_sharded:
            return _keyswitch_tp(cfg, ksk_shard, big, "tp", tp)
        return lwe_ops.keyswitch(
            ksk_shard, big, base_log=cfg.ks_base_log,
            level_count=cfg.ks_level)

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(
            P(None, None, "tp"),             # bsk levels
            P("tp") if ks_sharded else P(),  # ksk rows (or replicated)
            P(),                             # lut replicated
            P("dp"),                         # ciphertext batch
        ),
        out_specs=P("dp"),
        check_vma=False,
    )
    return jax.jit(sharded)


# ---------------------------------------------------------------------------
# dp + tp on the MXU path: digit row-blocks sharded, wrapping psum
# ---------------------------------------------------------------------------


def gate_pipeline_dp_tp_mxu(cfg: bs.ServerConfig, mesh: Mesh):
    """MXU-path gate pipeline: batch on dp, external-product row blocks on tp.

    The toeplitz rings [n, R, k+1, 2N] are sharded on the block axis R (the
    gadget levels); each tp shard dots its digit row-blocks against its ring
    slice and the per-device partial sums combine with a plain wrapping psum
    (exact mod 2^32 — integer sums commute with the collective, no mod-p
    bookkeeping). The keyswitch contraction is sharded as in the NTT variant.
    Requires row_blocks % tp == 0 and big_lwe_dimension % tp == 0.
    """
    from ..core import checks

    plan = bsx.MxuPlan.from_config(cfg)
    tp = mesh.shape["tp"]
    checks.check_tp_divides(
        f"row_blocks = pbs_level*(k+1)*n_sub = {plan.level}*"
        f"{plan.glwe_size}*{plan.n_sub}", plan.row_blocks, tp)
    ks_sharded = cfg.big_lwe_dimension % tp == 0  # see gate_pipeline_dp_tp
    blocks_local = plan.row_blocks // tp
    N = cfg.polynomial_size

    def run(rings_shard, ksk_shard, lut, lin):
        body = lin[..., -1]
        b_hat = bs.pbs_modulus_switch(body, N)
        a_hats = jnp.moveaxis(bs.pbs_modulus_switch(lin[..., :-1], N), -1, 0)
        acc = jnp.moveaxis(jnp.broadcast_to(lut, lin.shape[:-1] + lut.shape[-2:]), -2, 0)
        acc = polynomial.negacyclic_monomial_div(acc, b_hat[None, :])
        tp_idx = jax.lax.axis_index("tp")

        def step(acc, xs):
            rings_i, a_hat = xs                     # [R/tp, k+1, 2N], [B]
            rot = polynomial.negacyclic_monomial_mul(acc, a_hat[None, :])
            d8 = bsx._digit_matrix(plan, rot - acc)  # [B, R*N] full digits
            my = jax.lax.dynamic_slice_in_dim(
                d8, tp_idx * blocks_local * N, blocks_local * N, axis=1)
            rhs = bsx.build_tables(                  # local [R/tp*N, cols]
                rings_i, N, plan.n_words, plan.limb_drop)
            s = jax.lax.dot_general(
                my, rhs, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
            s = jax.lax.psum(s, "tp")         # wrapping == exact mod 2^bits
            upd = bsx.recombine_limb_planes(plan, s)
            return acc + upd, None

        acc, _ = jax.lax.scan(step, acc, (rings_shard, a_hats))
        big = bs.sample_extract(jnp.moveaxis(acc, 0, -2))
        if ks_sharded:
            return _keyswitch_tp(cfg, ksk_shard, big, "tp", tp)
        return lwe_ops.keyswitch(
            ksk_shard, big, base_log=cfg.ks_base_log,
            level_count=cfg.ks_level)

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(
            P(None, "tp"),                   # rings: row blocks sharded
            P("tp") if ks_sharded else P(),  # ksk rows (or replicated)
            P(),                             # lut replicated
            P("dp"),                         # ciphertext batch
        ),
        out_specs=P("dp"),
        check_vma=False,
    )
    return jax.jit(sharded)


# ---------------------------------------------------------------------------
# dp + tp on the Nussbaumer path (large N): per-frequency row blocks sharded
# ---------------------------------------------------------------------------


def gate_pipeline_dp_tp_nuss(cfg: bs.ServerConfig, mesh: Mesh,
                             l: int | None = None):
    """Nussbaumer-path gate pipeline (N > 4096 class): batch on dp,
    per-frequency external-product row blocks R' on tp.

    The rings [n, 2L*R', (k+1)*words, 2M] are viewed as [n, 2L, R', ., 2M]
    and sharded on the R' (gadget level x sub-digit x column) axis, so each
    tp shard dots its row blocks for EVERY frequency and the per-device
    partial sums combine with one wrapping psum per CMux (exact: the i32
    partial dot sums add to the single-device sums with no overflow — the
    plan's K-row bound covers the full contraction). The inverse polynomial
    transform + recombine then run replicated in the tp group; the
    keyswitch shards as in the other pipelines. Requires
    row_blocks % tp == 0. Bit-identical to bootstrap_keyswitch_nuss
    (tests/test_parallel.py)."""
    from ..core import checks

    plan = bsn.NussPlan.from_config(cfg, l)
    tp = mesh.shape["tp"]
    checks.check_tp_divides(
        f"nuss row_blocks R' = pbs_level*(k+1)*n_sub = {plan.level}*"
        f"{plan.glwe_size}*{plan.n_sub}", plan.row_blocks, tp)
    ks_sharded = cfg.big_lwe_dimension % tp == 0  # see gate_pipeline_dp_tp
    blocks_local = plan.row_blocks // tp
    N, M, two_l = cfg.polynomial_size, plan.m, plan.two_l

    def run(rings_shard, ksk_shard, lut, lin):
        body = lin[..., -1]
        b_hat = bs.pbs_modulus_switch(body, N)
        a_hats = jnp.moveaxis(bs.pbs_modulus_switch(lin[..., :-1], N), -1, 0)
        acc = jnp.moveaxis(
            jnp.broadcast_to(lut, lin.shape[:-1] + lut.shape[-2:]), -2, 0)
        acc = polynomial.negacyclic_monomial_div(acc, b_hat[None, :])
        acc = nb.chunk(acc, plan.l)[..., :plan.l, :]    # chunk-major
        tp_idx = jax.lax.axis_index("tp")

        def step(acc, xs):
            rings_i, a_hat = xs        # [2L, R'/tp, planes, 2M], [B]
            rot = nb.monomial_mul_chunked(acc, a_hat[None, :], plan.l)
            d8 = bsn._digit_matrix_nuss(plan, rot - acc)   # [B, 2L, R'M]
            d8r = d8.reshape(d8.shape[0], two_l, plan.row_blocks, M)
            my = jax.lax.dynamic_slice_in_dim(
                d8r, tp_idx * blocks_local, blocks_local, axis=2)
            my = my.reshape(d8.shape[0], two_l, blocks_local * M)
            rhs = bsx.build_tables(
                rings_i.reshape(two_l * blocks_local, -1, 2 * M),
                M, plan.n_words, 0, plan.limb_hi_drop)
            rhs = rhs.reshape(two_l, blocks_local * M, -1)
            s = jax.lax.dot_general(
                my, rhs, (((2,), (1,)), ((1,), (0,))),
                preferred_element_type=jnp.int32)          # [2L, B, cols]
            s = jax.lax.psum(s, "tp")        # exact partial-sum combine
            return acc + bsn._recombine_nuss(plan, s), None

        acc, _ = jax.lax.scan(step, acc, (rings_shard, a_hats))
        acc = nb.unchunk(acc, plan.l)
        big = bs.sample_extract(jnp.moveaxis(acc, 0, -2))
        if ks_sharded:
            return _keyswitch_tp(cfg, ksk_shard, big, "tp", tp)
        return lwe_ops.keyswitch(
            ksk_shard, big, base_log=cfg.ks_base_log,
            level_count=cfg.ks_level)

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(
            P(None, None, "tp"),             # rings: [n, 2L, R'|tp, ., 2M]
            P("tp") if ks_sharded else P(),  # ksk rows (or replicated)
            P(),                             # lut replicated
            P("dp"),                         # ciphertext batch
        ),
        out_specs=P("dp"),
        check_vma=False,
    )

    def outer(rings, ksk, lut, lin):
        # callers pass the standard bsk_to_nuss layout [n, 2L*R', ., 2M]
        r5 = rings.reshape(rings.shape[0], two_l, plan.row_blocks,
                           rings.shape[2], rings.shape[3])
        return sharded(r5, ksk, lut, lin)

    return jax.jit(outer)
