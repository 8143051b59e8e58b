"""Multi-process rehearsal of the sharded gate pipeline, on the CPU only.

The reference has no distributed backend (SURVEY.md §2 tail: rayon only).
This module rehearses a multi-host layout on one machine: N processes x
M virtual CPU devices each, `jax.distributed` + Gloo collectives, the same
`gate_pipeline_dp_tp_mxu` shard_map running unchanged over the GLOBAL
mesh, with the server keys replicated once at setup (one broadcast) and
the ciphertext batch sharded (dp) across processes. It pins every worker
to the CPU and is never pointed at the GPUs: on a GPU host the sharded
pipelines run in ONE process that drives all local cards
(`parallel.mesh`; `python chip_smoke.py --four-cards`).

Two mesh orientations are rehearsed:
- dp across processes (batch over the process collective, tp inside);
- tp across processes (the cross-process psum — every per-CMux partial
  sum rides the process-to-process collective).

Run it via the driver hook::

    python -c "import __graft_entry__ as g; g.dryrun_multihost(2, 4)"

or directly (spawns the workers itself)::

    python -m concrete_tpu.parallel.multihost

Each worker checks its addressable output shards BIT-IDENTICAL against a
single-device reference computed from the broadcast keys, so key
replication, sharding layout, and the collectives are all on the hook.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

_ENV_ID = "CONCRETE_TPU_MH_PROCESS_ID"
_ENV_N = "CONCRETE_TPU_MH_NUM_PROCESSES"
_ENV_COORD = "CONCRETE_TPU_MH_COORDINATOR"
_ENV_DEV = "CONCRETE_TPU_MH_LOCAL_DEVICES"


def worker_env(pid: int, n_processes: int, coordinator: str,
               devices_per_process: int) -> dict:
    """The CONCRETE_TPU_MH_* environment block one worker process needs.

    Pure: computes the mapping `run()` injects into each spawned worker so
    `initialize_from_env` can reassemble the jax.distributed topology.

    >>> env = worker_env(1, 2, "localhost:1234", 4)
    >>> env["CONCRETE_TPU_MH_PROCESS_ID"], env["CONCRETE_TPU_MH_NUM_PROCESSES"]
    ('1', '2')
    >>> env["CONCRETE_TPU_MH_COORDINATOR"]
    'localhost:1234'
    >>> env["CONCRETE_TPU_MH_LOCAL_DEVICES"]
    '4'
    """
    return {
        _ENV_ID: str(pid),
        _ENV_N: str(n_processes),
        _ENV_COORD: coordinator,
        _ENV_DEV: str(devices_per_process),
    }


def initialize_from_env():
    """jax.distributed.initialize from the CONCRETE_TPU_MH_* variables; must
    run before any jax backend use. Returns (process_id, num_processes)."""
    pid = int(os.environ[_ENV_ID])
    n = int(os.environ[_ENV_N])
    ndev = int(os.environ.get(_ENV_DEV, "4"))
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={ndev}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=os.environ[_ENV_COORD],
        num_processes=n,
        process_id=pid,
    )
    return pid, n


def replicate_from_host0(value):
    """The setup-time key replication: host 0's array is broadcast to every
    process (the cross-host broadcast of the design; BSK ~100 MB at real params —
    a one-time cost). Non-zero processes pass a same-shaped placeholder."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.broadcast_one_to_all(value))


def make_global(mesh, spec, host_data):
    """Assemble a global jax.Array on `mesh` with PartitionSpec `spec` from
    identical per-host numpy data (keys replicated / batch that every host
    can regenerate deterministically): each process donates exactly its
    addressable shards."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        host_data.shape, sharding, lambda idx: host_data[idx])


def _worker() -> None:
    """One process of the rehearsal; asserts bit-identity and prints OK."""
    pid, n_proc = initialize_from_env()
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental import multihost_utils

    import __graft_entry__ as ge
    from concrete_tpu.core import bootstrap as bs
    from concrete_tpu.core import bootstrap_mxu as bsx
    from concrete_tpu.dispersion import StandardDev
    from concrete_tpu.params import BooleanParameters
    from concrete_tpu.parallel import gate_pipeline_dp_tp_mxu

    ndev_local = len(jax.local_devices())
    devices = jax.devices()
    assert len(devices) == n_proc * ndev_local

    params = BooleanParameters(
        lwe_dimension=16, glwe_dimension=1, polynomial_size=128,
        pbs_base_log=8, pbs_level=2, ks_base_log=4, ks_level=3,
        lwe_modular_std_dev=StandardDev(2.0 ** -20),
        glwe_modular_std_dev=StandardDev(2.0 ** -25))
    cfg = bs.ServerConfig.from_boolean_parameters(params)

    # --- key replication: host 0 owns the keys, everyone else receives ---
    if pid == 0:
        rings_h, ksk_h, _ = ge._synthetic_server_tensors(cfg, 1, kind="mxu")
        rings_h, ksk_h = np.asarray(rings_h), np.asarray(ksk_h)
    else:
        plan = bsx.MxuPlan.from_config(cfg)
        rings_h = np.zeros(
            (cfg.lwe_dimension, plan.row_blocks, plan.glwe_size,
             2 * cfg.polynomial_size), np.uint32)
        ksk_h = np.zeros(
            (cfg.big_lwe_dimension, cfg.ks_level, cfg.lwe_dimension + 1),
            np.uint32)
    rings_h = replicate_from_host0(rings_h)
    ksk_h = replicate_from_host0(ksk_h)
    assert rings_h.any() and ksk_h.any(), "broadcast produced zeros"

    lut = bs.trivial_lut_constant(cfg, np.uint32(1 << 29))
    batch = 4 * len(devices)
    rng = np.random.default_rng(7)  # same on every host (deterministic batch)
    lin_h = rng.integers(0, 1 << 32, size=(batch, cfg.lwe_dimension + 1),
                         dtype=np.uint32)

    # single-device reference from the broadcast keys (local compute)
    ref = np.asarray(bsx.bootstrap_keyswitch_mxu(
        cfg, jnp.asarray(rings_h), jnp.asarray(ksk_h), lut,
        jnp.asarray(lin_h)))

    def check(tag, mesh):
        fn = gate_pipeline_dp_tp_mxu(cfg, mesh)
        rings_g = make_global(mesh, P(None, "tp"), rings_h)
        ksk_g = make_global(
            mesh, P("tp") if cfg.big_lwe_dimension % mesh.shape["tp"] == 0
            else P(), ksk_h)
        lut_g = make_global(mesh, P(), np.asarray(lut))
        lin_g = make_global(mesh, P("dp"), lin_h)
        out = fn(rings_g, ksk_g, lut_g, lin_g)
        # every addressable output shard must equal its reference slice
        for shard in out.addressable_shards:
            want = ref[shard.index]
            got = np.asarray(shard.data)
            assert np.array_equal(got, want), f"{tag}: shard {shard.index}"
        # and the fully-gathered result must round-trip the process collective
        full = np.asarray(multihost_utils.process_allgather(out, tiled=True))
        assert np.array_equal(full, ref), f"{tag}: allgather mismatch"
        print(f"  [proc {pid}] {tag}: bit-identical OK "
              f"(batch={batch}, devices={len(devices)})", flush=True)

    # 1) production shape: dp ACROSS processes, tp inside each process
    check("dp-across-hosts tp=2",
          Mesh(np.array(devices).reshape(-1, 2), ("dp", "tp")))
    # 2) the hard one: tp ACROSS processes — every CMux psum crosses the
    #    process boundary (cross-process collective rehearsal)
    check("tp-across-hosts tp=%d" % n_proc,
          Mesh(np.array(devices).reshape(n_proc, -1).T.copy(), ("dp", "tp")))

    # --- production shape: REAL TPU128 keys (n=630, k=4, N=256) ----------
    # The toy config above is the fast tier; this stage rehearses the real
    # key-broadcast width (~70 MB server-key class) and psum widths. The
    # client key is deterministic from the shared seed, so every host
    # derives it locally (it is tiny); the SERVER keys are generated on
    # proc 0 only and broadcast — the actual cross-host setup cost of the design.
    # Reference gate flow: concrete-boolean/src/server_key/mod.rs:55-166.
    if not os.environ.get("CONCRETE_TPU_MH_FAST"):
        from concrete_tpu import boolean as bool_api
        from concrete_tpu.boolean.client_key import PLAINTEXT_TRUE
        from concrete_tpu.params import TPU128_PARAMETERS

        cks = bool_api.ClientKey.new(TPU128_PARAMETERS, secret_seed=101)
        cfg_t = bs.ServerConfig.from_boolean_parameters(TPU128_PARAMETERS)
        plan_t = bsx.MxuPlan.from_config(cfg_t)
        if pid == 0:
            sks = bool_api.ServerKey.new(cks, mask_seed=102, noise_seed=103)
            rings_t = np.asarray(sks.bsk_mxu)
            ksk_t = np.asarray(sks.ksk)
        else:
            rings_t = np.zeros(
                (cfg_t.lwe_dimension, plan_t.row_blocks, cfg_t.glwe_size,
                 2 * cfg_t.polynomial_size), np.uint32)
            ksk_t = np.zeros(
                (cfg_t.big_lwe_dimension, cfg_t.ks_level,
                 cfg_t.lwe_dimension + 1), np.uint32)
        mb = (rings_t.nbytes + ksk_t.nbytes) / 1e6
        rings_t = replicate_from_host0(rings_t)
        ksk_t = replicate_from_host0(ksk_t)
        assert rings_t.any() and ksk_t.any(), "real-key broadcast zeros"

        batch = 4 * len(devices)
        rng = np.random.default_rng(11)
        av = rng.integers(0, 2, batch).astype(bool)
        bv = rng.integers(0, 2, batch).astype(bool)
        # fixed encryption seeds -> identical ciphertext batch on every host
        ca = cks.encrypt(av, mask_seed=7, noise_seed=8)
        cb = cks.encrypt(bv, mask_seed=9, noise_seed=10)
        with np.errstate(over="ignore"):
            lin_t = ca + cb                                  # AND combo
            lin_t[..., -1] += np.uint32((-int(PLAINTEXT_TRUE)) % (1 << 32))
        lut_t = bs.trivial_lut_constant(cfg_t, PLAINTEXT_TRUE)
        ref_t = np.asarray(bsx.bootstrap_keyswitch_mxu(
            cfg_t, jnp.asarray(rings_t), jnp.asarray(ksk_t), lut_t,
            jnp.asarray(lin_t)))
        assert np.array_equal(cks.decrypt(ref_t), av & bv)
        mesh = Mesh(np.array(devices).reshape(-1, 2), ("dp", "tp"))
        fn = gate_pipeline_dp_tp_mxu(cfg_t, mesh)
        out = fn(make_global(mesh, P(None, "tp"), rings_t),
                 make_global(mesh, P("tp"), ksk_t),
                 make_global(mesh, P(), np.asarray(lut_t)),
                 make_global(mesh, P("dp"), lin_t))
        for shard in out.addressable_shards:
            assert np.array_equal(np.asarray(shard.data), ref_t[shard.index])
        full = np.asarray(multihost_utils.process_allgather(out, tiled=True))
        assert np.array_equal(full, ref_t), "real keys: allgather mismatch"
        assert np.array_equal(cks.decrypt(full), av & bv)
        print(f"  [proc {pid}] TPU128 real keys (n=630 k=4 N=256, "
              f"{mb:.0f} MB key broadcast): dp-across-hosts "
              f"encrypt->AND->decrypt OK, bit-identical OK", flush=True)

    multihost_utils.sync_global_devices("done")
    if pid == 0:
        tiers = ("toy matrix" if os.environ.get("CONCRETE_TPU_MH_FAST")
                 else "toy matrix + TPU128 real keys")
        print(f"multihost worker matrix OK ({n_proc} processes x "
              f"{ndev_local} devices; {tiers})", flush=True)


def run(n_processes: int = 2, devices_per_process: int = 4,
        timeout: float = 900.0) -> None:
    """Spawn the worker processes and wait; raises on any failure."""
    import portpicker

    port = portpicker.pick_unused_port()
    procs = []
    for pid in range(n_processes):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update(worker_env(pid, n_processes, f"localhost:{port}",
                              devices_per_process))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "concrete_tpu.parallel.multihost"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
        ))
    failed = []
    outputs = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed.append(pid)
        outputs.append(out)
        if p.returncode != 0:
            failed.append(pid)
    for pid, out in enumerate(outputs):
        for line in out.splitlines():
            if not any(s in line for s in ("WARNING", "INFO", "Gloo", "E0", "W0")):
                print(line)
    if failed:
        raise RuntimeError(
            f"multihost workers failed: {sorted(set(failed))}\n"
            + "\n".join(outputs))


if __name__ == "__main__":
    if _ENV_ID in os.environ:
        _worker()
    else:
        run()
