"""Forkable AES-128-CTR cryptographically secure PRNG.

Batch-first re-design of `concrete-csprng`: the same (aes_ctr, byte_ctr) state
machine, 128-byte batches (8 AES blocks) and deterministic fork-tree semantics
(counter ranges carved per child), so that key/mask/noise generation is
bit-reproducible given a fixed seed. The AES core is a vectorized numpy
implementation (the reference uses AES-NI / aes-soft).
"""

from .generator import AesCtrGenerator, State
from .random import RandomGenerator
from .encryption import EncryptionRandomGenerator, SecretRandomGenerator

__all__ = [
    "AesCtrGenerator",
    "State",
    "RandomGenerator",
    "EncryptionRandomGenerator",
    "SecretRandomGenerator",
]
