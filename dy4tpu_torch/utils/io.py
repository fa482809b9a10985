"""Stream and file I/O for IQ captures and PCM audio.

Host equivalents of the reference's ``src/iofunc.cpp`` (u8 stdin block
reader :113-120, f32 bin files :33-62, u8 raw files :64-89, interleaved
stereo writer :90-111) and the ``model/wavio.py`` bin<->wav bridge.
Device-facing code gets plain numpy arrays; normalisation to float happens
on device (pipeline/receiver.py) where the reference does it on read.
"""

from __future__ import annotations

import sys
import wave
from typing import BinaryIO, Iterator, Optional

import numpy as np


def read_iq_blocks(stream: Optional[BinaryIO], block_size: int,
                   ) -> Iterator[np.ndarray]:
    """Yield u8 IQ blocks of exactly ``block_size`` bytes from a byte
    stream (default stdin), like ``readStdinBlockData`` + the EOF check
    (iofunc.cpp:113-120, project.cpp:292-296).  A trailing partial block
    is dropped, matching the reference's exit-on-short-read."""
    f = stream if stream is not None else sys.stdin.buffer
    while True:
        buf = f.read(block_size)
        if buf is None or len(buf) < block_size:
            return
        yield np.frombuffer(buf, np.uint8)


def write_pcm(stream: Optional[BinaryIO], pcm_s16: np.ndarray) -> None:
    """Write int16 PCM samples as S16LE bytes (project.cpp:313-317)."""
    f = stream if stream is not None else sys.stdout.buffer
    f.write(np.ascontiguousarray(pcm_s16, dtype="<i2").tobytes())
    f.flush()


def read_raw_u8(path: str) -> np.ndarray:
    """Whole u8 capture file (readRawData, iofunc.cpp:64-77)."""
    return np.fromfile(path, np.uint8)


def u8_to_float(x: np.ndarray) -> np.ndarray:
    """(x - 128) / 128 normalisation (iofunc.cpp:85-89)."""
    return (x.astype(np.float32) - 128.0) / 128.0


def float_to_u8(x: np.ndarray) -> np.ndarray:
    """Inverse quantisation used when fabricating captures
    (model/fmRateChange.py:60-66)."""
    return np.clip(np.round(x * 128.0 + 128.0), 0, 255).astype(np.uint8)


def read_bin_f32(path: str) -> np.ndarray:
    """float32 binary dump (readBinData, iofunc.cpp:33-47)."""
    return np.fromfile(path, np.float32)


def write_bin_f32(path: str, x: np.ndarray) -> None:
    """float32 binary dump (writeBinData, iofunc.cpp:49-62) — the
    cross-language golden-vector format (spec p.5)."""
    np.asarray(x, np.float32).tofile(path)


def write_wav(path: str, audio: np.ndarray, fs: float,
              scale: float = 32767.0) -> None:
    """Write mono [N] or stereo [N, 2] float audio in [-1, 1] to a 16-bit
    WAV (model/wavio.py:39-81; fmMonoBlock.py:777-782 divides by 2)."""
    a = np.asarray(audio)
    ch = 1 if a.ndim == 1 else a.shape[1]
    pcm = np.clip(a * scale, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(int(round(fs)))
        w.writeframes(pcm.tobytes())


def read_wav(path: str) -> tuple[np.ndarray, float]:
    """Read a 16-bit WAV to float [-1, 1]; returns (audio, fs) with audio
    [N] mono or [N, ch]."""
    with wave.open(path, "rb") as w:
        n, ch, fs = w.getnframes(), w.getnchannels(), w.getframerate()
        data = np.frombuffer(w.readframes(n), "<i2").astype(np.float32)
    data /= 32768.0
    return (data if ch == 1 else data.reshape(-1, ch)), float(fs)
