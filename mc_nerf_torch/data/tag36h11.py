"""tag36h11 family: codewords and bitmap layout (own copy of
``mc_nerf_tpu/data/tag36h11.py``).

The black square is 8x8 cells: 6x6 data cells inside a 1-cell black
border ring, on the white cube face; the detected quad is the square's
outer boundary.  Bit i of the 36-bit codeword (MSB first) lives at row
i // 6, col i % 6 of the data grid in canonical orientation (row 0 at the
'lt' edge); a set bit is a white cell.  The codewords are the first 12 of
the public tag36h11 family; the cube renderer and the C++ detector share
this table, and only ids 0-5 are used (one per cube face).
"""

from __future__ import annotations

import numpy as np

# first 12 codewords of tag36h11 (36 bits each)
TAG36H11_CODES = (
    0x0000000D5D628584,
    0x0000000D97F18B49,
    0x0000000DD280910E,
    0x0000000E479E9C98,
    0x0000000EBCBCA822,
    0x0000000F31DAB3AC,
    0x0000000056A5D085,
    0x000000010652E1D4,
    0x000000022B1DFEAD,
    0x0000000265AD0472,
    0x000000034FE91B86,
    0x00000003FF962CD5,
)

GRID = 8          # black square is GRID x GRID cells
DATA = 6          # inner data grid
N_BITS = DATA * DATA


def tag_bitmap(tag_id: int) -> np.ndarray:
    """[8, 8] float bitmap of the black square: 1.0 = white, 0.0 = black.

    Row 0 is the canonical top ('lt' -> 'rt' edge); border ring is black.
    """
    code = TAG36H11_CODES[tag_id]
    bm = np.zeros((GRID, GRID), dtype=np.float32)
    for i in range(N_BITS):
        bit = (code >> (N_BITS - 1 - i)) & 1
        r, c = i // DATA, i % DATA
        bm[r + 1, c + 1] = float(bit)
    return bm


def rotate_bits(bits: np.ndarray, k: int) -> np.ndarray:
    """Rotate a [6, 6] bit grid by k*90 deg counter-clockwise."""
    return np.rot90(bits, k)


def decode_bits(bits: np.ndarray, max_hamming: int = 1):
    """Match a sampled [6, 6] bit grid against the family, all 4 rotations.

    Returns (tag_id, rotation k such that rot90(bits, k) == canonical) or
    (None, None).  Mirrors libapriltag's rotation search; used by tests and
    as the golden model for the C++ decoder.
    """
    for k in range(4):
        rb = np.rot90(bits, k)
        word = 0
        for i in range(N_BITS):
            word = (word << 1) | int(rb[i // DATA, i % DATA])
        for tag_id, code in enumerate(TAG36H11_CODES):
            if bin(word ^ code).count("1") <= max_hamming:
                return tag_id, k
    return None, None
