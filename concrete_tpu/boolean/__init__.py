"""Boolean-gate API with gate bootstrapping — the canonical TFHE workload.

Mirrors the `concrete-boolean` crate: booleans encode as +-1/8 on the torus
(lib.rs:53-59), every binary gate is one linear combination + PBS with a
constant 1/8 test polynomial + keyswitch (server_key/mod.rs), NOT is a free
negation, MUX costs two PBS. Unlike the reference's one-ciphertext-at-a-time
API, every operation here is batched: ciphertext arrays [..., n+1] evaluate
whole gate vectors per call — the device's unit of work.
"""

from .client_key import ClientKey, PLAINTEXT_TRUE, PLAINTEXT_FALSE
from .server_key import ServerKey
from ..params import DEFAULT_PARAMETERS, TFHE_LIB_PARAMETERS, BooleanParameters


def gen_keys(
    parameters: BooleanParameters = DEFAULT_PARAMETERS,
    *,
    secret_seed: int | None = None,
    mask_seed: int | None = None,
    noise_seed: int | None = None,
):
    """Generate a (client, server) key pair (concrete-boolean/src/lib.rs:96).

    Seeds are optional; fixing all three makes keygen bit-reproducible.

    >>> import numpy as np
    >>> from concrete_tpu import boolean
    >>> from tests_support import TINY_PARAMS  # doctest: +SKIP
    >>> cks, sks = boolean.gen_keys(secret_seed=1, mask_seed=2, noise_seed=3)  # doctest: +SKIP
    >>> ct = sks.and_(cks.encrypt(np.array([True])), cks.encrypt(np.array([True])))  # doctest: +SKIP
    >>> bool(cks.decrypt(np.asarray(ct))[0])  # doctest: +SKIP
    True
    """
    cks = ClientKey.new(parameters, secret_seed=secret_seed)
    sks = ServerKey.new(cks, mask_seed=mask_seed, noise_seed=noise_seed)
    return cks, sks


__all__ = [
    "gen_keys",
    "ClientKey",
    "ServerKey",
    "BooleanParameters",
    "DEFAULT_PARAMETERS",
    "TFHE_LIB_PARAMETERS",
    "PLAINTEXT_TRUE",
    "PLAINTEXT_FALSE",
]
