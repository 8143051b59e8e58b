"""Independent CSPRNG stream validation.

Cross-checks the package's AES-CTR construction — 128-byte batches of a
little-endian u128 counter (concrete-csprng/src/counter/mod.rs:106-151,
software.rs:76-89) — against a second, from-first-principles AES
implementation (tests/aes_independent.py), covering block batching, byte_ctr
offsets, the u128 counter wrap, and fork offsets beyond 2^64 bytes.
"""

import numpy as np
import pytest

from concrete_tpu.csprng import aes
from concrete_tpu.csprng.generator import AesCtrGenerator, State

from aes_independent import SBOX, encrypt_block, ctr_stream


def test_independent_sbox_spot_values():
    # FIPS-197 Fig. 7 spot entries: S[0x00]=0x63, S[0x53]=0xed, S[0xff]=0x16
    assert SBOX[0x00] == 0x63
    assert SBOX[0x53] == 0xED
    assert SBOX[0xFF] == 0x16


def test_independent_aes_fips197_vector():
    # FIPS-197 Appendix B
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    pt = bytes.fromhex("3243f6a8885a308d313198a2e0370734")
    assert encrypt_block(key, pt).hex() == "3925841d02dc09fbdc118597196a0b32"
    # SP 800-38A F.1.1 ECB-AES128 block #1
    pt2 = bytes.fromhex("6bc1bee22e409f96e93d7e117393172a")
    assert encrypt_block(key, pt2).hex() == "3ad77bb40d7a3660a89ecaf32466ef97"


@pytest.mark.parametrize(
    "first_block,n_blocks",
    [
        (0, 16),                         # stream start, two 8-block batches
        (7, 9),                          # unaligned batch boundary
        ((1 << 64) - 3, 8),              # lo-word carry into hi
        ((1 << 128) - 3, 8),             # u128 counter wrap
        (1 << 100, 4),                   # deep offset beyond 2^64 bytes
    ],
)
def test_ctr_fill_matches_independent_aes(first_block, n_blocks):
    """ctr_fill (native AES-NI when available, numpy otherwise) must equal
    the independent little-endian-counter stream at every edge."""
    key = bytes(range(16))
    rks = aes.key_schedule(key)
    got = aes.ctr_fill(rks, first_block, n_blocks)
    want = ctr_stream(key, first_block, n_blocks)
    np.testing.assert_array_equal(got, want)


def test_ctr_fill_numpy_fallback_matches(monkeypatch):
    """Pin the numpy fallback too (native may be the default on this host)."""
    from concrete_tpu import native

    monkeypatch.setattr(native, "load_aes", lambda: None)
    key = bytes(reversed(range(16)))
    rks = aes.key_schedule(key)
    for first_block in (0, (1 << 128) - 2, (1 << 64) - 1):
        np.testing.assert_array_equal(
            aes.ctr_fill(rks, first_block, 6), ctr_stream(key, first_block, 6)
        )


def test_generator_stream_byte_offsets():
    """generate_bytes at arbitrary byte_ctr offsets slices the independent
    stream exactly (counter/mod.rs:279-296 byte-at-a-time semantics)."""
    key = b"\x42" * 16
    ref = ctr_stream(key, 0, 24)
    for sizes in [(1, 2, 3, 40, 13), (15, 1, 17, 128)]:
        g = AesCtrGenerator(key=int.from_bytes(key, "little"))
        pos = 0
        for n in sizes:
            got = g.generate_bytes(n)
            np.testing.assert_array_equal(got, ref[pos: pos + n])
            pos += n
        assert g.state.gpos == pos


def test_fork_offsets_beyond_2_64_bytes():
    """Fork children starting deeper than 2^64 bytes into the stream draw
    from the right counters (counter/mod.rs:303-349 range carving)."""
    key = b"\x07" * 16
    g = AesCtrGenerator(key=int.from_bytes(key, "little"))
    big = 1 << 68                       # bytes per child, > 2^64
    kids = g.try_fork(2, big)
    # child 1 starts at byte offset 2^68 = counter 2^64
    got = kids[1].generate_bytes(32)
    want = ctr_stream(key, 1 << 64, 2)
    np.testing.assert_array_equal(got, want)
    # parent advanced past both children: next parent byte at 2^69
    got_p = g.generate_bytes(16)
    want_p = ctr_stream(key, 1 << 65, 1)
    np.testing.assert_array_equal(got_p, want_p)


def test_generator_counter_wrap_continues_stream():
    """A generator positioned just below the 2^128-counter wrap crosses it
    exactly like the independent stream (u128 wrapping_add semantics)."""
    key = b"\x99" * 16
    start_block = (1 << 128) - 2
    g = AesCtrGenerator(
        key=int.from_bytes(key, "little"), state=State(aes_ctr=start_block)
    )
    got = g.generate_bytes(64)          # 4 blocks: 2 before wrap, 2 after
    want = ctr_stream(key, start_block, 4)
    np.testing.assert_array_equal(got, want)
    # state wrapped around the 2^132-byte grid
    assert g.state.gpos == ((start_block * 16 + 64) % (1 << 132))


def test_deep_fork_tree_stream_parity():
    """A two-level fork tree lands every leaf on the independent stream at
    its carved offset."""
    key = b"\x31" * 16
    g = AesCtrGenerator(key=int.from_bytes(key, "little"))
    level1 = g.try_fork(3, 4096)
    leaves = level1[2].try_fork(4, 1024)
    # leaf (2,3) covers bytes [2*4096 + 3*1024, +1024)
    start = 2 * 4096 + 3 * 1024
    got = leaves[3].generate_bytes(1024)
    want = ctr_stream(key, start // 16, 1024 // 16)
    np.testing.assert_array_equal(got, want)
