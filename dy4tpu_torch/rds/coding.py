"""RDS/RBDS channel coding: CRC checkwords, offset words, syndrome matrix.

Derived from first principles of the RBDS standard (the reference's
hand-unrolled parity equations, fmMonoBlock.py:126-152 and 181-190, encode
the same public spec constants — spec appendix p.23):

* generator polynomial g(x) = x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1
* a transmitted 26-bit block is  m(x)*x^10 + (m(x)*x^10 mod g) + offset
* offset words select the block type A/B/C/C'/D

Syndrome convention: we use  s(r) = r(x) mod g(x)  directly, under which a
valid block of type T satisfies  s(r) == offset_T  (because
m*x^10 + crc == 0 mod g and deg(offset) < 10).  This is mathematically
equivalent to the spec's H-matrix syndrome (which folds in an extra x^10
factor) — the *decisions* (which windows are valid, which type) are
bit-identical, which is what "bit-exact RDS group decode" requires.

``syndrome_matrix()`` gives the GF(2) matrix S with s = (window @ S) mod 2,
so frame synchronisation over every bit position of a block becomes one
int8 matmul — MXU-friendly — instead of the reference's per-window
hand-unrolled XOR ladder.
"""

from __future__ import annotations

import functools

import numpy as np

# g(x), MSB first: x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1
GENPOLY = 0b10110111001
NBITS_BLOCK = 26
NBITS_MSG = 16
NBITS_CRC = 10

# Offset words (10 bits, MSB first), RBDS standard block types.
OFFSET_WORDS: dict[str, int] = {
    "A": 0b0011111100,
    "B": 0b0110011000,
    "C": 0b0101101000,
    "Cp": 0b1101010000,
    "D": 0b0110110100,
}

BLOCK_TYPES = ("A", "B", "C", "Cp", "D")


def _poly_mod(value: int, nbits: int) -> int:
    """Remainder of a ``nbits``-bit polynomial modulo g(x), GF(2)."""
    for shift in range(nbits - 1, NBITS_CRC - 1, -1):
        if (value >> shift) & 1:
            value ^= GENPOLY << (shift - NBITS_CRC)
    return value


def crc(msg16: int) -> int:
    """10-bit checkword for a 16-bit message: m*x^10 mod g."""
    return _poly_mod(msg16 << NBITS_CRC, NBITS_BLOCK)


def encode_block(msg16: int, block_type: str) -> int:
    """26-bit on-air block: message ++ (crc xor offset)."""
    return (msg16 << NBITS_CRC) | (crc(msg16) ^ OFFSET_WORDS[block_type])


def syndrome(block26: int) -> int:
    """s = r mod g; equals the offset word for a valid block."""
    return _poly_mod(block26, NBITS_BLOCK)


@functools.cache
def syndrome_matrix() -> np.ndarray:
    """[26, 10] GF(2) matrix: syndrome bits = window_bits @ S mod 2.

    Row j is x^(25-j) mod g(x) as 10 bits MSB-first, so that a window
    given as bits[0..25] MSB-first yields the same 10-bit syndrome as
    ``syndrome()``.
    """
    rows = []
    for j in range(NBITS_BLOCK):
        rem = _poly_mod(1 << (NBITS_BLOCK - 1 - j), NBITS_BLOCK)
        rows.append([(rem >> (NBITS_CRC - 1 - b)) & 1
                     for b in range(NBITS_CRC)])
    return np.asarray(rows, dtype=np.int8)


@functools.cache
def offset_syndromes() -> np.ndarray:
    """[5, 10] expected syndrome bit patterns for A, B, C, Cp, D."""
    out = []
    for t in BLOCK_TYPES:
        o = OFFSET_WORDS[t]
        out.append([(o >> (NBITS_CRC - 1 - b)) & 1 for b in range(NBITS_CRC)])
    return np.asarray(out, dtype=np.int8)


@functools.cache
def burst_error_table(max_burst: int = 5) -> "np.ndarray":
    """[1024] int32 lookup: error-syndrome -> 26-bit error pattern
    (MSB-first over the block), or -1 when not correctable.

    The RBDS (26,16) shortened cyclic code corrects any single error
    burst spanning <= 5 bits (spec annex B).  Verified here by
    construction: all 367 burst patterns of length <= 5 have distinct
    nonzero syndromes, none equal to an offset word (so a valid block
    of a different type can never be "corrected" into the expected
    one).  The reference has no correction at all — a single bit error
    drops the block and costs the whole group (fmMonoBlock.py:199-283).
    """
    table = np.full(1 << NBITS_CRC, -1, np.int64)
    for length in range(1, max_burst + 1):
        for p in range(NBITS_BLOCK - length + 1):
            mids = [0] if length == 1 else range(1 << (length - 2))
            for mid in mids:
                pat = (1 if length == 1
                       else (1 << (length - 1)) | (mid << 1) | 1)
                e = pat << (NBITS_BLOCK - p - length)
                s = syndrome(e)
                assert table[s] in (-1, e), (s, e)
                table[s] = e
    return table.astype(np.int64)


def bits_of(value: int, nbits: int) -> list[int]:
    return [(value >> (nbits - 1 - i)) & 1 for i in range(nbits)]


def int_of(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


# ---------------------------------------------------------------------------
# Group assembly (transmitter side; the reference only has a per-block
# checkword generator, fmMonoBlock.py:126-152).


def make_group_0a(pi: int, pty: int, segment: int, chars: str,
                  tp: int = 0, ta: int = 0, ms: int = 1, di: int = 0,
                  af: int = 0xE0E0) -> list[int]:
    """One type-0A group (program service name) as 4x26 block bits.

    ``segment`` in 0..3 addresses PS characters 2*segment, 2*segment+1.
    """
    assert 0 <= segment < 4 and len(chars) == 2
    block_a = pi
    block_b = ((0 << 12)            # group type 0
               | (0 << 11)          # version A
               | (tp << 10)
               | ((pty & 0x1F) << 5)
               | (ta << 4) | (ms << 3) | (di << 2)
               | (segment & 0x3))
    block_c = af
    block_d = (ord(chars[0]) << 8) | ord(chars[1])
    bits: list[int] = []
    for msg, t in ((block_a, "A"), (block_b, "B"), (block_c, "C"),
                   (block_d, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def af_words(af_mhz) -> list[int]:
    """Pack a VHF alternative-frequency list into 0A block-C words.

    RDS method A: the first code is ``224 + count``, then one code per
    carrier (``code = (f - 87.5 MHz) / 100 kHz``, valid 87.6-107.9),
    padded to pairs with the 205 filler.  Returns the 16-bit words to
    cycle through successive 0A groups' block C.
    """
    codes = [224 + len(af_mhz)]
    for f in af_mhz:
        n = round((f - 87.5) / 0.1)
        if not 1 <= n <= 204:
            raise ValueError(f"AF {f} MHz outside 87.6-107.9")
        codes.append(n)
    if len(codes) % 2:
        codes.append(205)                  # filler
    return [(codes[i] << 8) | codes[i + 1]
            for i in range(0, len(codes), 2)]


def make_ps_bitstream(pi: int, pty: int, ps_name: str,
                      repeats: int = 1, af_mhz=()) -> list[int]:
    """Groups carrying an 8-char program service name, repeated;
    ``af_mhz`` (optional) cycles an alternative-frequency list through
    block C (method A)."""
    ps = (ps_name + " " * 8)[:8]
    afw = af_words(af_mhz) if af_mhz else [0xE0E0]   # 224 = no AF list
    k = 0
    bits: list[int] = []
    for _ in range(repeats):
        for seg in range(4):
            bits.extend(make_group_0a(pi, pty, seg, ps[2 * seg:2 * seg + 2],
                                      af=afw[k % len(afw)]))
            k += 1
    return bits


def make_group_2a(pi: int, pty: int, segment: int, chars: str,
                  tp: int = 0, ab_flag: int = 0) -> list[int]:
    """One type-2A group (radiotext): 4 characters per group, ``segment``
    in 0..15 addressing radiotext chars 4*segment..4*segment+3."""
    assert 0 <= segment < 16 and len(chars) == 4
    block_a = pi
    block_b = ((2 << 12)            # group type 2
               | (0 << 11)          # version A
               | (tp << 10)
               | ((pty & 0x1F) << 5)
               | ((ab_flag & 1) << 4)
               | (segment & 0xF))
    block_c = (ord(chars[0]) << 8) | ord(chars[1])
    block_d = (ord(chars[2]) << 8) | ord(chars[3])
    bits: list[int] = []
    for msg, t in ((block_a, "A"), (block_b, "B"), (block_c, "C"),
                   (block_d, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def make_group_2b(pi: int, pty: int, segment: int, chars: str,
                  tp: int = 0, ab_flag: int = 0) -> list[int]:
    """One type-2B group (radiotext, version B): 2 characters per group
    in block D only (32-char text), block C carries PI under the C'
    offset (spec 3.1.5.3)."""
    assert 0 <= segment < 16 and len(chars) == 2
    block_a = pi
    block_b = ((2 << 12)
               | (1 << 11)          # version B
               | (tp << 10)
               | ((pty & 0x1F) << 5)
               | ((ab_flag & 1) << 4)
               | (segment & 0xF))
    block_d = (ord(chars[0]) << 8) | ord(chars[1])
    bits: list[int] = []
    for msg, t in ((block_a, "A"), (block_b, "B"), (pi, "Cp"),
                   (block_d, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def make_rt_bitstream(pi: int, pty: int, text: str,
                      repeats: int = 1, ab_flag: int = 0,
                      version: str = "A") -> list[int]:
    """Groups carrying radiotext (version A: <=64 chars in C+D; version
    B: <=32 chars in D only), 0x0D-terminated when shorter, repeated."""
    cpg = 4 if version == "A" else 2           # chars per group
    cap = 16 * cpg
    rt = text[:cap]
    if len(rt) < cap:
        rt = (rt + "\r").ljust(cap)
    n_seg = -(-max(len(text) + 1, cpg) // cpg)
    bits: list[int] = []
    for _ in range(repeats):
        for seg in range(min(16, n_seg)):
            chars = rt[cpg * seg:cpg * (seg + 1)]
            if version == "A":
                bits.extend(make_group_2a(pi, pty, seg, chars,
                                          ab_flag=ab_flag))
            else:
                bits.extend(make_group_2b(pi, pty, seg, chars,
                                          ab_flag=ab_flag))
    return bits


def make_group_1a(pi: int, pty: int, day: int, hour: int, minute: int,
                  tp: int = 0, variant: int = 0, slow_label: int = 0
                  ) -> list[int]:
    """One type-1A group (programme item number + slow labelling,
    spec 3.1.5.2): block D is the PIN (day 5b, hour 5b, minute 6b),
    block C a slow-labelling code (variant in bits 14-12)."""
    assert 1 <= day < 32 and 0 <= hour < 24 and 0 <= minute < 60
    block_a = pi
    block_b = ((1 << 12) | (0 << 11) | (tp << 10)
               | ((pty & 0x1F) << 5))
    block_c = ((variant & 0x7) << 12) | (slow_label & 0xFFF)
    block_d = ((day & 0x1F) << 11) | ((hour & 0x1F) << 6) | (minute & 0x3F)
    bits: list[int] = []
    for msg, t in ((block_a, "A"), (block_b, "B"), (block_c, "C"),
                   (block_d, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def make_group_3a(pi: int, pty: int, app_group: str, aid: int,
                  message: int = 0, tp: int = 0) -> list[int]:
    """One type-3A group (open-data-application announcement, spec
    3.1.5.4): block B's low 5 bits name the group the ODA rides in
    (``app_group`` like "8A"), block C is the app message word, block D
    the 16-bit application id (AID)."""
    gt = int(app_group[:-1])
    ver = {"A": 0, "B": 1}[app_group[-1]]
    assert 0 <= gt < 16 and 0 <= aid < (1 << 16)
    block_a = pi
    block_b = ((3 << 12) | (0 << 11) | (tp << 10)
               | ((pty & 0x1F) << 5)
               | ((gt & 0xF) << 1) | ver)
    bits: list[int] = []
    for msg, t in ((block_a, "A"), (block_b, "B"), (message, "C"),
                   (aid, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def make_group_10a(pi: int, pty: int, segment: int, chars: str,
                   tp: int = 0, ab_flag: int = 0) -> list[int]:
    """One type-10A group (programme type name, spec 3.1.5.19): 8-char
    PTYN over 2 segments of 4 chars (blocks C+D)."""
    assert 0 <= segment < 2 and len(chars) == 4
    block_a = pi
    block_b = ((10 << 12) | (0 << 11) | (tp << 10)
               | ((pty & 0x1F) << 5)
               | ((ab_flag & 1) << 4)
               | (segment & 0x1))
    block_c = (ord(chars[0]) << 8) | ord(chars[1])
    block_d = (ord(chars[2]) << 8) | ord(chars[3])
    bits: list[int] = []
    for msg, t in ((block_a, "A"), (block_b, "B"), (block_c, "C"),
                   (block_d, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def make_ptyn_bitstream(pi: int, pty: int, ptyn: str,
                        repeats: int = 1, ab_flag: int = 0) -> list[int]:
    """Groups carrying an 8-char programme type name (10A), repeated."""
    name = (ptyn + " " * 8)[:8]
    bits: list[int] = []
    for _ in range(repeats):
        for seg in range(2):
            bits.extend(make_group_10a(pi, pty, seg,
                                       name[4 * seg:4 * seg + 4],
                                       ab_flag=ab_flag))
    return bits


def make_group_14a(pi: int, pty: int, variant: int, info_word: int,
                   pi_on: int, tp: int = 0, tp_on: int = 0) -> list[int]:
    """One type-14A group (enhanced other networks, spec 3.1.5.13):
    block B's low 4 bits select the variant, bit 4 is TP(ON), block C
    carries the variant's information word and block D the PI(ON).

    Variants used here: 0-3 PS(ON) segment (two chars), 4 AF(ON) method
    A code pair, 13 PTY(ON)+TA(ON), 14 PIN(ON)."""
    assert 0 <= variant < 16 and 0 <= info_word < (1 << 16)
    block_a = pi
    block_b = ((14 << 12) | (0 << 11) | (tp << 10)
               | ((pty & 0x1F) << 5)
               | ((tp_on & 1) << 4)
               | (variant & 0xF))
    bits: list[int] = []
    for msg, t in ((block_a, "A"), (block_b, "B"), (info_word, "C"),
                   (pi_on, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def make_group_14b(pi: int, pty: int, pi_on: int, tp_on: int = 0,
                   ta_on: int = 0, tp: int = 0) -> list[int]:
    """One type-14B group (EON change-over switch, spec 3.1.5.13):
    block B carries TP(ON) bit 4 / TA(ON) bit 3, block C the PI under
    the C' offset, block D the PI(ON)."""
    block_a = pi
    block_b = ((14 << 12) | (1 << 11) | (tp << 10)
               | ((pty & 0x1F) << 5)
               | ((tp_on & 1) << 4) | ((ta_on & 1) << 3))
    bits: list[int] = []
    for msg, t in ((block_a, "A"), (block_b, "B"), (pi, "Cp"),
                   (pi_on, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def make_eon_bitstream(pi: int, pty: int, pi_on: int, ps_on: str,
                       af_on_mhz=(), pty_on: int = 0, ta_on: int = 0,
                       pin_on=None) -> list[int]:
    """One pass of 14A groups describing an other-network service:
    PS(ON) (variants 0-3), optional AF(ON) (variant 4, method A),
    PTY(ON)/TA(ON) (variant 13), optional PIN(ON) (variant 14)."""
    ps = (ps_on + " " * 8)[:8]
    bits: list[int] = []
    for seg in range(4):
        w = (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])
        bits.extend(make_group_14a(pi, pty, seg, w, pi_on))
    for w in (af_words(af_on_mhz) if af_on_mhz else ()):
        bits.extend(make_group_14a(pi, pty, 4, w, pi_on))
    bits.extend(make_group_14a(pi, pty, 13,
                               ((pty_on & 0x1F) << 11) | (ta_on & 1),
                               pi_on))
    if pin_on is not None:
        day, hour, minute = pin_on
        w = ((day & 0x1F) << 11) | ((hour & 0x1F) << 6) | (minute & 0x3F)
        bits.extend(make_group_14a(pi, pty, 14, w, pi_on))
    return bits


def make_group_15b(pi: int, pty: int, segment: int, tp: int = 0,
                   ta: int = 0, ms: int = 1, di: int = 0) -> list[int]:
    """One type-15B group (fast basic tuning/switching, spec 3.1.5.21):
    blocks B and D carry IDENTICAL words (type/TP/PTY/TA/MS/DI/segment —
    a 0B block B without the PS chars), block C is the PI under C'."""
    assert 0 <= segment < 4
    block_b = ((15 << 12) | (1 << 11) | (tp << 10)
               | ((pty & 0x1F) << 5)
               | ((ta & 1) << 4) | ((ms & 1) << 3) | ((di & 1) << 2)
               | (segment & 0x3))
    bits: list[int] = []
    for msg, t in ((pi, "A"), (block_b, "B"), (pi, "Cp"),
                   (block_b, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def make_group_oda(pi: int, pty: int, app_group: str, payload5: int,
                   block_c: int, block_d: int, tp: int = 0) -> list[int]:
    """One open-data group (e.g. 8A RDS-TMC, spec 3.1.5.12/annex): the
    37-bit ODA payload rides in block B's low 5 bits + blocks C and D.
    Pair with a 3A announcement (``make_group_3a``) naming the AID."""
    gt = int(app_group[:-1])
    ver = {"A": 0, "B": 1}[app_group[-1]]
    assert ver == 0, "ODA version-B carriers lose block C to PI"
    block_b = ((gt << 12) | (ver << 11) | (tp << 10)
               | ((pty & 0x1F) << 5) | (payload5 & 0x1F))
    bits: list[int] = []
    for msg, t in ((pi, "A"), (block_b, "B"), (block_c, "C"),
                   (block_d, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def make_group_rtplus(pi: int, pty: int, app_group: str,
                      tag1: tuple[int, int, int],
                      tag2: tuple[int, int, int] = (0, 0, 0),
                      toggle: int = 0, running: int = 1,
                      tp: int = 0) -> list[int]:
    """One RadioText+ application group (RT+ spec R06/040_1 §2.1; AID
    0x4BD7, announce with ``make_group_3a``): each ``tag`` is
    (content_type, start, length) pointing into the current radiotext."""
    ct1, s1, l1 = tag1
    ct2, s2, l2 = tag2
    assert 0 <= ct1 < 64 and 0 <= ct2 < 64 and l1 < 64 and l2 < 32
    b5 = ((toggle & 1) << 4) | ((running & 1) << 3) | ((ct1 >> 3) & 0x7)
    block_c = (((ct1 & 0x7) << 13) | ((s1 & 0x3F) << 7)
               | ((l1 & 0x3F) << 1) | ((ct2 >> 5) & 1))
    block_d = ((ct2 & 0x1F) << 11) | ((s2 & 0x3F) << 5) | (l2 & 0x1F)
    return make_group_oda(pi, pty, app_group, b5, block_c, block_d, tp=tp)


def make_group_ert(pi: int, pty: int, app_group: str, addr: int,
                   four_bytes: bytes, tp: int = 0) -> list[int]:
    """One Enhanced-RadioText application group (RDS Forum eRT spec;
    AID 0x6552, announce with ``make_group_3a(message=1)`` for UTF-8):
    ``addr`` selects one of 32 four-byte text segments carried in
    blocks C+D."""
    assert 0 <= addr < 32 and len(four_bytes) == 4
    block_c = (four_bytes[0] << 8) | four_bytes[1]
    block_d = (four_bytes[2] << 8) | four_bytes[3]
    return make_group_oda(pi, pty, app_group, addr, block_c, block_d,
                          tp=tp)


def make_group_tmc_single(pi: int, pty: int, event: int, location: int,
                          extent: int = 0, direction: int = 0,
                          diversion: int = 0, duration: int = 0,
                          tp: int = 0) -> list[int]:
    """One RDS-TMC Alert-C single-group user message (ISO 14819-1 §5.3;
    AID 0xCD46 on 8A, announce with ``make_group_3a``)."""
    assert 0 <= event < (1 << 11) and 0 <= location < (1 << 16)
    b5 = (0 << 4) | (1 << 3) | (duration & 0x7)     # T=0, F=1 (single)
    block_c = (((diversion & 1) << 15) | ((direction & 1) << 14)
               | ((extent & 0x7) << 11) | (event & 0x7FF))
    return make_group_oda(pi, pty, "8A", b5, block_c, location, tp=tp)


def make_station_bitstream(pi: int, pty: int, ps: str, *,
                           groups: int = 96, radiotext: str = None,
                           rt_title: str = None, rt_artist: str = None,
                           af_mhz=(), ptyn: str = None, clock=None,
                           rtplus_group: str = "12A",
                           tp: int = 0, ta: int = 0, ms: int = 1
                           ) -> list[int]:
    """A realistic broadcaster's group schedule (one call = one
    station): 0A dominates (PS + AF, like real transmitters at ~4/s of
    the 11.4 groups/s budget), 2A radiotext cycles its segments, and
    the slower services (10A PTYN, 4A clock at ``clock=(y,mo,d,h,mi,
    offset_half_hours)``, 3A RadioText+ announcement + RT+ tags for
    ``rt_title``/``rt_artist`` found in the radiotext) are sprinkled at
    their spec-typical rates.  Complements the single-service
    ``make_*_bitstream`` helpers by exercising a decoder against an
    INTERLEAVED stream — what an off-air capture actually looks like.
    """
    ps = (ps + " " * 8)[:8]
    afw = af_words(af_mhz) if af_mhz else [0xE0E0]
    rt = radiotext
    n_rt_seg = 0 if rt is None else min(16, -(-min(len(rt) + 1, 64) // 4))
    rt_pad = None if rt is None else (rt[:64] + "\r").ljust(64)[:64]

    tags = []
    if rt is not None:
        for ctype, sub in ((1, rt_title), (4, rt_artist)):
            if sub:
                start = rt.find(sub)
                if start < 0:
                    raise ValueError(f"{sub!r} not in radiotext")
                tags.append((ctype, start, len(sub) - 1))
    ps_seg = rt_seg = ptyn_seg = af_k = 0
    bits: list[int] = []
    for g in range(groups):
        slot = g % 12
        if clock is not None and g % 48 == 24:
            y, mo, d, h, mi, off = clock
            bits.extend(make_group_4a(pi, pty, ymd_to_mjd(y, mo, d),
                                      h, mi, off, tp=tp))
        elif tags and slot == 5:
            bits.extend(make_group_3a(pi, pty, rtplus_group, 0x4BD7))
        elif tags and slot == 11:
            bits.extend(make_group_rtplus(
                pi, pty, rtplus_group, tags[0],
                tags[1] if len(tags) > 1 else (0, 0, 0), toggle=1,
                tp=tp))
        elif ptyn is not None and slot == 8:
            p2 = (ptyn + " " * 8)[:8]
            bits.extend(make_group_10a(pi, pty, ptyn_seg % 2,
                                       p2[4 * (ptyn_seg % 2):]
                                       [:4], tp=tp))
            ptyn_seg += 1
        elif rt_pad is not None and slot % 3 == 1:
            seg = rt_seg % n_rt_seg
            bits.extend(make_group_2a(pi, pty, seg,
                                      rt_pad[4 * seg:4 * seg + 4],
                                      tp=tp))
            rt_seg += 1
        else:
            bits.extend(make_group_0a(pi, pty, ps_seg % 4,
                                      ps[2 * (ps_seg % 4):]
                                      [:2], tp=tp, ta=ta, ms=ms,
                                      af=afw[af_k % len(afw)]))
            ps_seg += 1
            af_k += 1
    return bits


def ymd_to_mjd(year: int, month: int, day: int) -> int:
    """Modified Julian Day from a calendar date (RDS standard annex G)."""
    l = 1 if month in (1, 2) else 0
    return (14956 + day + int((year - 1900 - l) * 365.25)
            + int((month + 1 + l * 12) * 30.6001))


def mjd_to_ymd(mjd: int) -> tuple[int, int, int]:
    """Calendar date from Modified Julian Day (RDS standard annex G)."""
    yp = int((mjd - 15078.2) / 365.25)
    mp = int((mjd - 14956.1 - int(yp * 365.25)) / 30.6001)
    day = mjd - 14956 - int(yp * 365.25) - int(mp * 30.6001)
    k = 1 if mp in (14, 15) else 0
    return 1900 + yp + k, mp - 1 - k * 12, day


def make_group_4a(pi: int, pty: int, mjd: int, hour: int, minute: int,
                  offset_half_hours: int = 0, tp: int = 0) -> list[int]:
    """One type-4A group (clock-time/date, beyond the reference's 0A-only
    application layer): 17-bit MJD spans blocks B/C, UTC hour/minute and
    the signed local-time offset (half-hours) sit in C/D."""
    assert 0 <= mjd < (1 << 17) and 0 <= hour < 24 and 0 <= minute < 60
    sign = 1 if offset_half_hours < 0 else 0
    off = abs(offset_half_hours)
    assert off < 32
    block_a = pi
    block_b = ((4 << 12)            # group type 4
               | (0 << 11)          # version A
               | (tp << 10)
               | ((pty & 0x1F) << 5)
               | ((mjd >> 15) & 0x3))
    block_c = ((mjd & 0x7FFF) << 1) | ((hour >> 4) & 1)
    block_d = ((hour & 0xF) << 12) | ((minute & 0x3F) << 6) \
        | (sign << 5) | off
    bits: list[int] = []
    for msg, t in ((block_a, "A"), (block_b, "B"), (block_c, "C"),
                   (block_d, "D")):
        bits.extend(bits_of(encode_block(msg, t), NBITS_BLOCK))
    return bits


def differential_encode(bits) -> list[int]:
    """d_k = b_k xor d_{k-1} (inverse of the receiver's xor decode,
    fmMonoBlock.py:108-118)."""
    out, prev = [], 0
    for b in bits:
        prev = int(b) ^ prev
        out.append(prev)
    return out


def manchester_halves(dbits) -> np.ndarray:
    """Biphase symbols: bit 1 -> (1, 0), bit 0 -> (0, 1) as +/-1 amplitudes.

    Matches the receiver pairing decode (fmMonoBlock.py:106-115:
    pair (1,0) -> 1, pair (0,1) -> 0).
    """
    out = np.empty(2 * len(dbits), dtype=np.float32)
    for k, d in enumerate(dbits):
        hi, lo = (1.0, -1.0) if d else (-1.0, 1.0)
        out[2 * k], out[2 * k + 1] = hi, lo
    return out
