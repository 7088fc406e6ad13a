"""PNG streams built by hand, for the port's PNG reader: each row filtered
by a chosen PNG filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), or by the
filter PIL's encoder picks, so a frame can be encoded as PIL encodes it
where PIL is absent (the card's machine).  Used by
tests/test_torch_image_io.py and chip_smoke.py.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def candidates(img: np.ndarray) -> np.ndarray:
    """(5, H, W*C) uint8: every row of (H, W, C) uint8 ``img`` under each of
    the five filters (PNG spec, section 9)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    upleft = np.zeros_like(x)
    upleft[1:, c:] = x[:-1, :-c]
    pa, pb = np.abs(up - upleft), np.abs(left - upleft)
    pc = np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (0, left, up, (left + up) >> 1, paeth)
    return np.stack([(x - p) & 0xFF for p in preds]).astype(np.uint8)


# the filters PIL's encoder tries, in its order (Average only with its
# "optimize" option, which PNG saves do not set by default)
PIL_ORDER = np.array([0, 2, 1, 4])


def pil_kinds(img: np.ndarray) -> np.ndarray:
    """The filter PIL's encoder picks for each row: of PIL_ORDER, the least
    sum of the filtered bytes read as signed, the first of equals."""
    cand = candidates(img)[PIL_ORDER].view(np.int8).astype(np.int64)
    return PIL_ORDER[np.argmin(np.abs(cand).sum(axis=2), axis=0)]


def chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def png_bytes(img: np.ndarray, kinds, colour: int | None = None,
              depth: int = 8, interlace: int = 0, palette=None,
              idat_chunks: int = 1) -> bytes:
    """A PNG stream of (H, W, C) uint8 ``img`` (C = 1 palette indices where
    ``palette`` is given), each row filtered by ``kinds`` (one filter for
    all rows, or one a row, or "pil"), its IDAT split into ``idat_chunks``
    chunks."""
    h, w, c = img.shape
    if colour is None:
        colour = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[c]
    kinds = pil_kinds(img) if isinstance(kinds, str) else np.broadcast_to(
        np.asarray(kinds), (h,))
    rows = candidates(img)[kinds, np.arange(h)]
    raw = np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1)
    data = zlib.compress(raw.tobytes(), 6)
    cuts = np.linspace(0, len(data), idat_chunks + 1).astype(int)
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                  colour, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    for s, e in zip(cuts[:-1], cuts[1:]):
        out += chunk(b"IDAT", data[s:e])
    return out + chunk(b"IEND", b"")
