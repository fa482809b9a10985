"""RDS group 0A bitstreams (program service name), a frozen copy of the
port's ``rds/coding.py`` transmitter side: CRC checkwords with the RBDS
offset words, differential encoding and biphase symbols."""

from __future__ import annotations

import numpy as np

GENPOLY = 0b10110111001   # x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1
OFFSET_WORDS = {"A": 0b0011111100, "B": 0b0110011000, "C": 0b0101101000,
                "D": 0b0110110100}


def _crc(msg16: int) -> int:
    value = msg16 << 10
    for shift in range(25, 9, -1):
        if (value >> shift) & 1:
            value ^= GENPOLY << (shift - 10)
    return value


def _block_bits(msg16: int, block_type: str) -> list[int]:
    word = (msg16 << 10) | (_crc(msg16) ^ OFFSET_WORDS[block_type])
    return [(word >> (25 - i)) & 1 for i in range(26)]


def ps_bitstream(pi: int, pty: int, ps_name: str, repeats: int) -> list[int]:
    """``repeats`` cycles of the four 0A groups carrying the 8-character
    ``ps_name`` (no alternative frequencies)."""
    ps = (ps_name + " " * 8)[:8]
    bits: list[int] = []
    for _ in range(repeats):
        for seg in range(4):
            block_b = ((pty & 0x1F) << 5) | (1 << 3) | seg   # 0A, music
            chars = ps[2 * seg:2 * seg + 2]
            for msg, t in ((pi, "A"), (block_b, "B"), (0xE0E0, "C"),
                           ((ord(chars[0]) << 8) | ord(chars[1]), "D")):
                bits.extend(_block_bits(msg, t))
    return bits


def biphase(bits) -> np.ndarray:
    """Differentially encode ``bits``, then one biphase symbol pair a bit:
    1 -> (+1, -1), 0 -> (-1, +1)."""
    d = np.bitwise_xor.accumulate(np.asarray(bits, np.int64))
    hi = np.where(d == 1, 1.0, -1.0)
    return np.stack([hi, -hi], 1).reshape(-1)
