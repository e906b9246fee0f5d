"""Frozen copy of hal_tpu_torch/dna.py for the benchmark's plain reference (numpy
only; the same code, imports pointing at hal_bench.reference).  It is the
yardstick: the port may change, this copy does not.

Nibble-packed DNA codec, vectorized with numpy.

The on-disk DNA encoding is byte-compatible with the reference HAL format
(see reference api/inc/halCommon.h:183-196 and
reference api/impl/halCommon.cpp:224-236): two bases per byte, the
*even* position in the high nibble, codes 0..4 = acgtn lowercase, 8..12 =
ACGTN uppercase.  Everything here is bulk numpy — there is no per-base
Python loop anywhere in the framework.
"""

from __future__ import annotations

import numpy as np

# 4-bit code -> ASCII char (0 marks invalid)
UNPACK_MAP = np.zeros(16, dtype=np.uint8)
for _i, _c in enumerate(b"acgtn"):
    UNPACK_MAP[_i] = _c
for _i, _c in enumerate(b"ACGTN"):
    UNPACK_MAP[8 + _i] = _c

# ASCII char -> 4-bit code; invalid chars map to 4 ('n')
PACK_MAP = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"acgtn"):
    PACK_MAP[_c] = _i
for _i, _c in enumerate(b"ACGTN"):
    PACK_MAP[_c] = 8 + _i

# ASCII -> reverse complement ASCII (identity for non-ACGT)
COMP_MAP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"acgtACGT", b"tgcaTGCA"):
    COMP_MAP[_a] = _b


def pack_dna(seq: np.ndarray | bytes | str) -> np.ndarray:
    """ASCII base array -> packed uint8 array (2 bases/byte, even=high nibble)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    codes = PACK_MAP[arr]
    n = len(codes)
    if n % 2:
        codes = np.concatenate([codes, np.zeros(1, dtype=np.uint8)])
    pairs = codes.reshape(-1, 2)
    return (pairs[:, 0] << 4 | pairs[:, 1]).astype(np.uint8)


# byte -> two ASCII bases in one lookup (little-endian uint16 = [hi, lo]);
# one fancy-index on N/2 elements + a view instead of two strided stores and
# a full-length lookup — ~3x faster whole-genome unpacks (the MafBlockBuilder
# ASCII cache build was the hal2maf window bottleneck)
PAIR_MAP = np.zeros(256, dtype=np.uint16)
for _b in range(256):
    PAIR_MAP[_b] = int(UNPACK_MAP[_b >> 4]) | (int(UNPACK_MAP[_b & 0x0F]) << 8)
if np.little_endian is False:  # big-endian hosts: swap the byte order
    PAIR_MAP = PAIR_MAP.byteswap()


def unpack_dna(packed: np.ndarray, start: int, length: int) -> np.ndarray:
    """Slice [start, start+length) of the logical base string as ASCII uint8."""
    if length <= 0:
        return np.zeros(0, dtype=np.uint8)
    first_byte = start >> 1
    last_byte = (start + length - 1) >> 1
    chunk = np.asarray(packed[first_byte : last_byte + 1], dtype=np.uint8)
    pairs = PAIR_MAP[chunk].view(np.uint8)
    off = start & 1
    return pairs[off : off + length]


def write_dna(packed: np.ndarray, start: int, seq: np.ndarray | bytes | str) -> None:
    """Write ASCII bases into a packed buffer at logical position `start` (in place)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    n = len(arr)
    if n == 0:
        return
    codes = PACK_MAP[arr]
    end = start + n  # exclusive
    # head partial byte
    i = 0
    if start & 1:
        b = start >> 1
        packed[b] = (packed[b] & 0xF0) | codes[0]
        i = 1
    # tail partial byte
    j = n
    if end & 1:
        b = (end - 1) >> 1
        packed[b] = (packed[b] & 0x0F) | (codes[n - 1] << 4)
        j = n - 1
    if j > i:
        mid = codes[i:j].reshape(-1, 2)
        packed[(start + i) >> 1 : (start + j) >> 1] = (mid[:, 0] << 4 | mid[:, 1]).astype(np.uint8)


def reverse_complement(seq: np.ndarray | bytes | str) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    return COMP_MAP[arr[::-1]]


def to_str(arr: np.ndarray) -> str:
    return arr.tobytes().decode()
