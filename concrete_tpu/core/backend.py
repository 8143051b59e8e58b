"""Which product backend a blind rotation runs on, chosen from what can be
observed: the configuration (N, torus width, digit split) and the platform
of the default device.

Three backends compute the same exact external product and are
bit-identical:

- ``"mxu"``: one int8 toeplitz matmul per CMux (core/bootstrap_mxu.py);
  ``MxuPlan.from_config`` bounds it (N <= 4096, int32-exact contraction);
- ``"nuss"``: the same product in the Nussbaumer domain
  (core/bootstrap_nuss.py), 2L smaller matmuls, for N beyond the direct
  table; selected by name only;
- ``"ntt"``: the exact prime-NTT path (core/bootstrap.py), which takes any
  configuration and is the reference the other two are tested against.

On the CPU every configuration keeps ``"ntt"``, so the test suite's cost
does not depend on the int8 paths. On an accelerator ``"mxu"`` runs
wherever its plan admits the configuration, and ``"ntt"`` elsewhere. The
rule is measured (H100, PERF.md): mxu beat ntt at the TFHE_LIB, DEFAULT
and TPU128 gate shapes (B=2048) and on the u64 PBS, while at N=8192
(B=64) ntt beat nuss.

>>> from concrete_tpu.core.bootstrap import ServerConfig
>>> cfg = ServerConfig(lwe_dimension=630, glwe_dimension=1,
...     polynomial_size=1024, pbs_base_log=7, pbs_level=3,
...     ks_base_log=2, ks_level=8)
>>> resolve(cfg, platform="cpu")
'ntt'
>>> resolve(cfg, platform="gpu")
'mxu'
>>> import dataclasses
>>> resolve(dataclasses.replace(cfg, polynomial_size=8192, primes=()),
...         platform="gpu")
'ntt'
"""

from __future__ import annotations

import jax

from .bootstrap import ServerConfig

def resolve(cfg: ServerConfig, platform: str | None = None) -> str:
    """The backend ``"auto"`` stands for on `platform` (default: the
    platform of JAX's default backend)."""
    from .bootstrap_mxu import MxuPlan

    if platform is None:
        platform = jax.default_backend()
    if platform == "cpu":
        return "ntt"
    try:
        MxuPlan.from_config(cfg)
    except NotImplementedError:
        return "ntt"
    return "mxu"


def int8_keyswitch(int8_product: bool, base_log: int, n_rows: int) -> bool:
    """Whether a keyswitch with `n_rows` = n_in * level digit rows runs as
    the int8 limb contraction (lwe.keyswitch_limbs): where the product
    itself runs on int8 (`int8_product`), with digits that fit int8
    (base_log <= 7) and an int32-exact contraction.

    >>> int8_keyswitch(True, 2, 1024 * 8), int8_keyswitch(False, 2, 1024 * 8)
    (True, False)
    """
    return int8_product and base_log <= 7 and n_rows * 8192 < 2 ** 31
