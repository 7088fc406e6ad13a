"""Frame files: PNG on the standard library's ``zlib`` and numpy, and JPEG
through PIL.

The card's machine has no PIL, so every PNG the port reads or writes goes
through this module and never through PIL: one code path for PNG.

* ``read_png(path)`` -> (H, W, C) samples: every PNG format, as PIL opens
  them: colour types 0, 2, 3, 4 and 6 (gray, RGB, palette through ``PLTE``
  expanded to RGB, gray+alpha, RGBA) at each bit depth the format allows
  (1, 2, 4 and 8 for gray and palette, 16 for all but palette), plain or
  Adam7-interlaced, all five row filters, the ``IDAT`` chunks
  concatenated, each chunk's CRC checked.  Samples come as uint8 at bit
  depth 8 and below (gray at 1, 2 or 4 bits as stored, 0 to 2**depth - 1)
  and uint16 at 16.  A truncated stream, a bad CRC, a stream shorter or
  longer than its header says, a palette index past ``PLTE`` or a depth the
  colour type does not allow raises a ``ValueError`` that names the file.
  ``tRNS`` is ignored, as ``.convert("RGB")`` ignores it.
* ``read_rgb(path)`` -> (H, W, 3) uint8, as PIL 12's ``.convert("RGB")``
  gives it: gray repeated, alpha dropped; gray at 1, 2 or 4 bits scaled to
  0-255 (x255, x85, x17); 16-bit gray clipped to 255 (PIL opens it as
  ``I;16``, whose conversion clips: 256 and 65535 both give 255), and every
  other 16-bit type's samples by their high byte.  A path that does not end
  in ``.png`` (``.jpg``, ``.jpeg``) is decoded by PIL; where PIL is absent
  it raises an ``ImportError`` that names the file.
* ``write_png(path, frame)``: RGB (H, W, 3) or gray (H, W) / (H, W, 1)
  uint8, non-interlaced, the Up filter on every row (one numpy subtraction
  for the whole frame; on smooth frames it compresses better than None),
  at zlib level ``ZLIB_LEVEL``.

Decoding: the None, Sub and Up filters are whole-frame numpy operations
(Sub a running sum along each row, a run of Up rows a running sum down the
columns, both modulo 256).  Average and Paeth take the pixel to the left, so
a frame that holds either (PIL's encoder and most others write Paeth rows)
is decoded along its anti-diagonals: pixel (r, x) needs only (r, x-1),
(r-1, x) and (r-1, x-1), so every pixel of one diagonal r + x = d is decoded
at once, H + W - 1 steps each vectorised over the rows and channels.  A
step is nine numpy calls: each filter's predictor is ``c + table[kind, a -
c, b - c]`` for the left, upper and upper-left pixels a, b, c, one lookup in
a table of the four predictors (Sub, Up, Average, Paeth); a None row is
first rewritten as the Sub row that decodes to the same bytes.  The filters
work on bytes, a pixel's bytes apart (one byte below 8 bits a pixel), so
16-bit and packed low-depth rows unfilter as 8-bit ones do; then the bytes
become samples.  An Adam7 file is seven such images, each unfiltered alone
and scattered to its rows and columns.
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np
from numpy.lib.stride_tricks import as_strided

__all__ = ["ZLIB_LEVEL", "frame_size", "read_png", "read_rgb", "write_png"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# zlib level of write_png: the fastest, since the video driver encodes on
# the host beside the forward (PERF.md has the time of a 1280x720 frame)
ZLIB_LEVEL = 1
# samples a pixel of each colour type (the palette's index is one), and the
# bit depths a sample of each may have (PNG spec, table 11.1)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's seven passes: first row, first column, row step, column step
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
_UP = 2


def _chunks(data: bytes, path):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while True:
        head = data[pos:pos + 8]
        if len(head) < 8:
            raise ValueError(f"{path}: truncated PNG stream (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", head)
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise ValueError(f"{path}: truncated PNG stream in the "
                             f"{ctype!r} chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: CRC mismatch in the {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length


def _unfilter_rows(ftype: np.ndarray, filt: np.ndarray, bpp: int
                   ) -> np.ndarray:
    """None, Sub and Up rows, (H, W*bpp) uint8: whole-frame operations."""
    out = filt.copy()
    sub = ftype == 1
    if sub.any():
        rows = out[sub]
        out[sub] = np.cumsum(rows.reshape(len(rows), -1, bpp), axis=1,
                             dtype=np.uint8).reshape(rows.shape)
    up = np.flatnonzero(ftype == _UP)
    if up.size:
        # a run of Up rows is a running sum down the columns from the row
        # above the run (None and Sub rows are final already)
        for run in np.split(up, np.flatnonzero(np.diff(up) != 1) + 1):
            s, e = run[0], run[-1] + 1
            block = np.cumsum(out[s:e], axis=0, dtype=np.uint8)
            if s > 0:
                block += out[s - 1]
            out[s:e] = block
    return out


# the diagonal decode's predictor table: index (kind - 1) * _SPAN**2
# + (a - c + 255) * _SPAN + (b - c + 255) for kinds 1..4
_SPAN = 511
_ZERO = 255 * _SPAN + 255
_I32_SPAN, _I32_FF = np.int32(_SPAN), np.int32(0xFF)


@functools.lru_cache(maxsize=1)
def _predictor_table() -> np.ndarray:
    """(4 * 511 * 511,) int32: each filter's predictor less c, as a function
    of a - c and b - c (Paeth: a, b or c, whichever is nearest a + b - c,
    in that order of ties; Average: floor((a + b) / 2))."""
    d = np.arange(-255, 256, dtype=np.int32)
    da, db = np.broadcast_arrays(d[:, None], d[None, :])
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    paeth = np.where((pa <= pb) & (pa <= pc), da, np.where(pb <= pc, db, 0))
    return np.stack([da, db, (da + db) >> 1, paeth]).astype(np.int32).ravel()


def _skewed(buf: np.ndarray, h: int, w: int, bpp: int, lead: int
            ) -> np.ndarray:
    """The (h, w, bpp) view of ``buf`` (shape (h + w + 1, h + lead, bpp))
    whose pixel (r, x) is ``buf[x + r + 2, r + lead]``."""
    it, hl = buf.itemsize, h + lead
    return as_strided(buf.reshape(-1)[(2 * hl + lead) * bpp:],
                      shape=(h, w, bpp),
                      strides=((hl + 1) * bpp * it, hl * bpp * it, it))


def _unfilter_diagonals(ftype: np.ndarray, filt: np.ndarray, bpp: int
                        ) -> np.ndarray:
    """Any mix of the five filters, (H, W*bpp) uint8, a diagonal a step.

    The frame is skewed so that diagonal d is one contiguous slice:
    ``t[x + r + 2, r + 1]`` holds pixel (r, x), with a zero row above the
    frame and zeros left of it, so pixel (r, x)'s left, upper and upper-left
    neighbours are ``t[d-1, r+1]``, ``t[d-1, r]`` and ``t[d-2, r]`` at step
    d = x + r + 2.  Cells right of the frame compute values that nothing
    reads; cells left of it stay 0 (zero neighbours, zero input, and every
    predictor of (0, 0, 0) is 0)."""
    h = filt.shape[0]
    w = filt.shape[1] // bpp
    kind = ftype.astype(np.int32)
    rows = filt.reshape(h, w, bpp)
    none = kind == 0
    if none.any():
        # a None row decodes to its own bytes: as a Sub row, each byte less
        # the one a pixel to its left
        rows = rows.copy()
        rows[none, 1:] -= filt.reshape(h, w, bpp)[none, :-1]
        kind[none] = 1
    f = np.zeros((h + w + 1, h, bpp), np.int32)
    _skewed(f, h, w, bpp, 0)[...] = rows
    t = np.zeros((h + w + 1, h + 1, bpp), np.int32)
    base = np.ascontiguousarray(np.broadcast_to(
        ((kind - 1) * _SPAN * _SPAN + _ZERO)[:, None], (h, bpp)))
    table = _predictor_table()
    idx, pred = np.empty((h, bpp), np.int32), np.empty((h, bpp), np.int32)
    for d in range(2, h + w + 1):
        a, b, c = t[d - 1, 1:], t[d - 1, :-1], t[d - 2, :-1]
        np.subtract(a, c, out=idx)
        np.multiply(idx, _I32_SPAN, out=idx)
        np.add(idx, b, out=idx)
        np.subtract(idx, c, out=idx)
        np.add(idx, base, out=idx)
        table.take(idx, out=pred, mode="clip")   # in range by construction
        np.add(pred, c, out=pred)
        np.add(pred, f[d], out=pred)
        np.bitwise_and(pred, _I32_FF, out=t[d, 1:])
    return _skewed(t, h, w, bpp, 1).astype(np.uint8).reshape(h, w * bpp)


def _pass_samples(rows: np.ndarray, pw: int, channels: int, depth: int
                  ) -> np.ndarray:
    """Unfiltered rows (ph, rowbytes) uint8 -> (ph, pw, channels) samples:
    uint16 at depth 16 (big-endian), else uint8 (0 to 2**depth - 1)."""
    ph = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(ph, pw, channels)
    if depth == 8:
        return rows.reshape(ph, pw, channels)
    # 1, 2 or 4 bits, one channel (gray or a palette index), first sample in
    # the high bits of a byte
    bits = np.unpackbits(rows, axis=1).reshape(ph, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :pw, None]


def _decode(path) -> tuple[np.ndarray, int, int]:
    """A PNG file -> (samples (H, W, C), bit depth, colour type); a palette
    image's samples are its RGB entries."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {colour}")
    if depth not in _DEPTHS[colour]:
        raise ValueError(f"{path}: {depth}-bit samples are not a PNG "
                         f"format for colour type {colour}")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown PNG interlace method {interlace}")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    channels = _CHANNELS[colour]
    bits = channels * depth
    bpp = max(1, bits // 8)          # the filters' byte step
    passes = [(r0, c0, dr, dc, -(-(h - r0) // dr), -(-(w - c0) // dc))
              for r0, c0, dr, dc in (_ADAM7 if interlace else ((0, 0, 1, 1),))
              if r0 < h and c0 < w]
    sizes = [ph * (-(-pw * bits // 8) + 1) for *_, ph, pw in passes]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt IDAT stream ({e})") from None
    if len(raw) != sum(sizes):
        kind = f"{depth}-bit" + (" Adam7-interlaced" if interlace else "")
        raise ValueError(f"{path}: IDAT holds {len(raw)} bytes, a {w}x{h} "
                         f"{kind} frame needs {sum(sizes)}")
    img = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (r0, c0, dr, dc, ph, pw), size in zip(passes, sizes):
        rows = np.frombuffer(raw, np.uint8, size, pos).reshape(ph, -1)
        pos += size
        ftype, filt = rows[:, 0], rows[:, 1:]
        if ftype.max(initial=0) > 4:
            raise ValueError(f"{path}: unknown PNG row filter {ftype.max()}")
        unfilter = (_unfilter_diagonals if (ftype >= 3).any()
                    else _unfilter_rows)
        img[r0::dr, c0::dc] = _pass_samples(unfilter(ftype, filt, bpp), pw,
                                            channels, depth)
    if colour == 3:
        if img.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: a palette index past the "
                             f"{len(palette)} entries of PLTE")
        img = palette[img[..., 0]]
    return img, depth, colour


def read_png(path) -> np.ndarray:
    """A PNG file -> (H, W, C) samples: C = 1 gray, 2 gray+alpha, 3 RGB
    (and palette, expanded), 4 RGBA; uint8 at bit depth 8 and below (gray
    at 1, 2 or 4 bits as stored, 0 to 2**depth - 1), uint16 at 16."""
    return _decode(path)[0]


def frame_size(path) -> tuple[int, int]:
    """(H, W) of a frame file, without decoding it: a PNG's IHDR, else
    PIL's header read."""
    if str(path).lower().endswith(".png"):
        with open(path, "rb") as fh:
            head = fh.read(24)
        if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
            raise ValueError(f"{path}: not a PNG file with an IHDR chunk")
        w, h = struct.unpack(">II", head[16:24])
        return h, w
    from PIL import Image
    with Image.open(path) as im:
        return im.size[1], im.size[0]


def _rgb_as_pil(img: np.ndarray, depth: int, colour: int) -> np.ndarray:
    """Decoded samples -> (H, W, 3) uint8 by PIL's rules (see the module
    docstring)."""
    if depth == 16:
        # 16-bit gray opens as I;16, which .convert("RGB") clips; every
        # other 16-bit type opens as 8-bit, each sample's high byte
        img = (np.minimum(img, 255) if colour == 0 else img >> 8).astype(
            np.uint8)
    elif depth < 8 and colour == 0:
        img = img * np.uint8(255 // (2 ** depth - 1))
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_rgb(path) -> np.ndarray:
    """A frame file -> (H, W, 3) uint8, as PIL's ``.convert("RGB")``."""
    if str(path).lower().endswith(".png"):
        return _rgb_as_pil(*_decode(path))
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: decoding this format needs PIL, which is "
                          f"not installed (PNG needs no PIL)") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def write_png(path, frame: np.ndarray) -> None:
    """Write (H, W, 3) RGB or (H, W) / (H, W, 1) gray uint8 as a PNG."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8:
        raise ValueError(f"{path}: write_png takes uint8, got {frame.dtype}")
    if frame.ndim == 3 and frame.shape[-1] == 1:
        frame = frame[..., 0]
    if frame.ndim == 2:
        colour = 0
    elif frame.ndim == 3 and frame.shape[-1] == 3:
        colour = 2
    else:
        raise ValueError(f"{path}: write_png takes (H, W, 3) or (H, W), got "
                         f"{frame.shape}")
    h, w = frame.shape[:2]
    flat = np.ascontiguousarray(frame).reshape(h, -1)
    rows = np.empty((h, flat.shape[1] + 1), np.uint8)
    rows[:, 0] = _UP
    rows[0, 1:] = flat[0]
    np.subtract(flat[1:], flat[:-1], out=rows[1:, 1:])
    body = (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), ZLIB_LEVEL))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(body)
