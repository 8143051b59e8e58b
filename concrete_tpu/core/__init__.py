"""Crypto core: LWE/GLWE/GGSW encryption, keyswitching, external products and
programmable bootstrapping.

Split by trust/performance boundary, mirroring FHE deployment:
- *client side* (key generation, encrypt, decrypt) runs host-side in numpy,
  bit-reproducible under fixed CSPRNG seeds (reference semantics:
  concrete-core .../crypto/);
- *server side* (keyswitch, external product, blind rotation, PBS) runs as
  jitted JAX functions over ciphertext batches on the device.
"""

from .lwe import LweSecretKey, LweKeyswitchKey
from .glwe import GlweSecretKey
from .ggsw import encrypt_constant_ggsw, StandardBootstrapKey

__all__ = [
    "LweSecretKey",
    "LweKeyswitchKey",
    "GlweSecretKey",
    "encrypt_constant_ggsw",
    "StandardBootstrapKey",
]
