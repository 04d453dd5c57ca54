"""Rollout video recorder with its own GIF writer.

Port of mujoco_mbrl_tpu/utils/recorder.py (the reference's Recorder,
``src/mbrl/utils.py:34-54``): collect frames during a rollout and write
an animated GIF (or the raw frames as .npz). The JAX module writes the
GIF through PIL; this package encodes it itself (GIF89a, a fixed 3-3-2
RGB palette, LZW), so it needs nothing beyond numpy.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

# the fixed 256-colour palette: 3 bits red, 3 green, 2 blue
_PALETTE = np.stack(np.meshgrid(np.arange(8) * 255 // 7,
                                np.arange(8) * 255 // 7,
                                np.arange(4) * 255 // 3,
                                indexing='ij'), -1).reshape(256, 3)


def quantize(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) indices into the 3-3-2 palette."""
    f = np.asarray(frame, np.uint8).astype(np.int64)
    return ((f[..., 0] >> 5) << 5 | (f[..., 1] >> 5) << 2
            | f[..., 2] >> 6).astype(np.uint8)


def _lzw(indices: np.ndarray) -> bytes:
    """GIF LZW code stream of 8-bit indices (minimum code size 8)."""
    clear, eoi = 256, 257
    out, acc, nacc = bytearray(), 0, 0
    size, table, nxt = 9, {}, 258

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    emit(clear)
    data = indices.reshape(-1).tolist()
    prefix = data[0]
    for k in data[1:]:
        key = (prefix, k)
        if key in table:
            prefix = table[key]
            continue
        emit(prefix)
        if nxt == 4096:                 # table full: start over
            emit(clear)
            table, nxt, size = {}, 258, 9
        else:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        prefix = k
    emit(prefix)
    emit(eoi)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(path: str, frames, fps: int = 25) -> str:
    """Write uint8 RGB frames (each (H, W, 3)) as a looping GIF89a."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w = frames[0].shape[:2]
    delay = max(int(round(100 / fps)), 1)       # hundredths of a second
    buf = bytearray(b'GIF89a')
    buf += struct.pack('<HHBBB', w, h, 0xF7, 0, 0)  # 256-colour table
    buf += _PALETTE.astype(np.uint8).tobytes()
    buf += b'\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00'   # loop forever
    for f in frames:
        buf += struct.pack('<BBBBHBB', 0x21, 0xF9, 4, 0, delay, 0, 0)
        buf += struct.pack('<BHHHHB', 0x2C, 0, 0, w, h, 0)
        buf.append(8)                               # LZW minimum code size
        data = _lzw(quantize(f))
        for i in range(0, len(data), 255):
            chunk = data[i:i + 255]
            buf.append(len(chunk))
            buf += chunk
        buf.append(0)
    buf.append(0x3B)
    with open(path, 'wb') as fh:
        fh.write(bytes(buf))
    return path


def gif_frame_count(path: str) -> int:
    """Image descriptors in a GIF file, read block by block."""
    with open(path, 'rb') as fh:
        b = fh.read()
    if b[:6] not in (b'GIF87a', b'GIF89a'):
        raise ValueError(f'{path} is not a GIF')
    flags, i, n = b[10], 13, 0
    if flags & 0x80:
        i += 3 << ((flags & 7) + 1)

    def skip_blocks(i):
        while b[i]:
            i += b[i] + 1
        return i + 1

    while b[i] != 0x3B:
        if b[i] == 0x21:                            # extension
            i = skip_blocks(i + 2)
        elif b[i] == 0x2C:                          # image
            n += 1
            lflags = b[i + 9]
            i += 10
            if lflags & 0x80:
                i += 3 << ((lflags & 7) + 1)
            i = skip_blocks(i + 1)
        else:
            raise ValueError(f'{path}: unknown block {b[i]:#x} at {i}')
    return n


class Recorder:
    def __init__(self, fps: int = 25):
        self.frames: List[np.ndarray] = []
        self.fps = fps

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def record_frame(self, frame: np.ndarray, t: Optional[int] = None):
        self.frames.append(np.asarray(frame))

    def make_movie(self, path: str) -> str:
        """Write frames to `<path>.gif` (returns the written filename)."""
        if not self.frames:
            return ''
        out = path if path.endswith('.gif') else path + '.gif'
        os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
        return write_gif(out, self.frames, self.fps)

    def save_frames(self, path: str) -> str:
        out = path if path.endswith('.npz') else path + '.npz'
        os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
        np.savez_compressed(out, frames=np.stack(self.frames))
        return out
