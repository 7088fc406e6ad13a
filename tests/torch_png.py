"""PNG streams built by hand, for the port's PNG reader: each row filtered
by a chosen PNG filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), or by the
filter PIL's encoder picks, so a frame can be encoded as PIL encodes it
where PIL is absent (the card's machine).  ``png_bytes`` writes 8-bit rows
(its ``depth`` and ``interlace`` set the header alone, as a broken file's
do); ``encode`` writes the samples at any bit depth (1, 2, 4, 8 or 16),
plain or Adam7-interlaced.  Used by tests/test_torch_image_io.py,
tests/test_torch_png_depths.py and chip_smoke.py.
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


# Adam7's seven passes: first row, first column, row step, column step
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def pack_rows(img: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, C) samples -> (H, row bytes) uint8: big-endian at 16 bits,
    packed high bits first below 8."""
    h, w, c = img.shape
    if depth == 16:
        return img.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return img.astype(np.uint8).reshape(h, w * c)
    shifts = np.arange(depth - 1, -1, -1)
    bits = (img.reshape(h, w * c, 1).astype(np.uint8) >> shifts) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def encode(img: np.ndarray, kinds=0, depth: int = 8, interlace: bool = False,
           palette=None, colour: int | None = None) -> bytes:
    """A PNG stream of (H, W, C) samples ``img`` (values below 2**depth; C = 1
    palette indices where ``palette`` is given) at bit ``depth``, plain or
    Adam7-interlaced, each pass's rows filtered by ``kinds`` (one filter, or
    "pil")."""
    h, w, c = img.shape
    if colour is None:
        colour = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[c]
    bpp = max(1, c * depth // 8)
    raw = []
    for r0, c0, dr, dc in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = img[r0::dr, c0::dc]
        if sub.size == 0:
            continue
        rows = pack_rows(sub, depth).reshape(sub.shape[0], -1, bpp)
        k = pil_kinds(rows) if isinstance(kinds, str) else np.full(
            len(rows), kinds)
        filt = candidates(rows)[k, np.arange(len(rows))]
        raw.append(np.concatenate([k.astype(np.uint8)[:, None], filt], 1))
    data = zlib.compress(b"".join(r.tobytes() for r in raw), 6)
    out = SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + chunk(b"IDAT", data) + chunk(b"IEND", b"")
