"""The port's PNG reader on every format PIL's ``.convert("RGB")`` reads, and
the depth eval's numpy resize, each held to PIL itself: bit depths 1, 2, 4
and 16 besides 8, Adam7 interlace, palettes at 1, 2 and 4 bits, each on
streams built by hand (tests/torch_png.py) under each row filter, decoded
exactly as PIL decodes the same bytes; ``_resize`` within 1e-6 of PIL's
mode-F BILINEAR (exactly for NEAREST) at up- and down-scales and a
non-integer factor; and the depth-eval CLI on a 16-bit PNG with an SDR
sample and PIL hidden.
"""
import io
import json
import struct
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

import torch_png  # noqa: E402
from vfidkr_torch.apps import depth_eval  # noqa: E402
from vfidkr_torch.utils.image_io import read_png, read_rgb  # noqa: E402


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _read_both(tmp_path, data):
    path = tmp_path / "f.png"
    path.write_bytes(data)
    return read_png(path), read_rgb(path)


# (colour type, channels, bit depth) of every PNG format but 8-bit, which
# tests/test_torch_image_io.py holds
FORMATS = [(0, 1, 1), (0, 1, 2), (0, 1, 4), (0, 1, 16), (3, 1, 1), (3, 1, 2),
           (3, 1, 4), (2, 3, 16), (4, 2, 16), (6, 4, 16)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("kinds", [0, 4, "pil"])
@pytest.mark.parametrize("colour,c,depth", FORMATS)
def test_depths_decode_as_pil_decodes_them(tmp_path, colour, c, depth, kinds,
                                           interlace):
    rng = np.random.RandomState(depth * 10 + c)
    h, w = 13, 19                     # ragged against every Adam7 step
    img = rng.randint(0, 2 ** depth, (h, w, c))
    palette = rng.randint(0, 256, (2 ** depth, 3)) if colour == 3 else None
    data = torch_png.encode(img, kinds, depth, interlace, palette)
    samples, rgb = _read_both(tmp_path, data)
    want = palette[img[..., 0]] if colour == 3 else img
    assert samples.dtype == (np.uint16 if depth == 16 else np.uint8)
    np.testing.assert_array_equal(samples, want)
    np.testing.assert_array_equal(rgb, _pil_rgb(data))


@pytest.mark.parametrize("kinds", [0, 1, 2, 3, 4, "pil"])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("h,w", [(1, 1), (9, 3), (33, 20)])
def test_adam7_8bit_decodes_as_pil_decodes_it(tmp_path, kinds, c, h, w):
    rng = np.random.RandomState(h * w + c)
    img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    data = torch_png.encode(img, kinds, interlace=True)
    samples, rgb = _read_both(tmp_path, data)
    np.testing.assert_array_equal(samples, img)
    np.testing.assert_array_equal(rgb, _pil_rgb(data))


def test_16bit_gray_clips_as_pil_does(tmp_path):
    """PIL opens 16-bit gray as I;16, whose .convert("RGB") clips to 255
    (it does not take the high byte); 16-bit RGB takes the high byte."""
    values = np.array([[0, 255, 256, 1000, 65535]])
    _, rgb = _read_both(tmp_path, torch_png.encode(values[..., None],
                                                   depth=16))
    np.testing.assert_array_equal(rgb[..., 0], [[0, 255, 255, 255, 255]])
    _, rgb = _read_both(tmp_path, torch_png.encode(
        np.repeat(values[..., None], 3, -1), depth=16))
    np.testing.assert_array_equal(rgb[..., 0], [[0, 0, 1, 3, 255]])
    _, rgb = _read_both(tmp_path, torch_png.encode(
        np.array([[[0], [1]]]), depth=1))
    np.testing.assert_array_equal(rgb[..., 0], [[0, 255]])


@pytest.mark.parametrize("case,match", [
    ("truncated", "truncated"), ("crc", "CRC"),
    ("palette_index", "palette index"), ("rgb_4bit", "4-bit samples"),
    ("adam7_short", "Adam7-interlaced frame needs")])
def test_broken_files_still_raise(tmp_path, case, match):
    img = np.random.RandomState(0).randint(0, 4, (8, 6, 1))
    data = torch_png.encode(img, 0, depth=2, interlace=True)
    if case == "truncated":
        data = data[:len(data) // 2]
    elif case == "crc":
        data = data[:-20] + bytes([data[-20] ^ 1]) + data[-19:]
    elif case == "palette_index":
        data = torch_png.encode(img, 0, depth=2, palette=np.zeros((3, 3)))
    elif case == "rgb_4bit":
        data = torch_png.png_bytes(img.astype(np.uint8), 0, colour=2,
                                   depth=4)
    elif case == "adam7_short":
        # the header says Adam7, the stream holds the plain rows: fewer
        # bytes than the seven passes need
        plain = torch_png.encode(img, 0, depth=2)
        ihdr = plain[12:28] + b"\x01"
        data = (plain[:12] + ihdr + struct.pack(">I", zlib.crc32(ihdr))
                + plain[33:])
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        read_png(path)
    assert "bad.png" in str(err.value)


# ---------------------------------------------------------------------------
# the depth eval's resize
# ---------------------------------------------------------------------------

def _pil_resize(img, hw, nearest):
    h, w = hw
    mode = Image.NEAREST if nearest else Image.BILINEAR
    if img.ndim == 2:
        return np.asarray(Image.fromarray(img).resize((w, h), mode))
    return np.stack([np.asarray(Image.fromarray(img[..., c]).resize(
        (w, h), mode)) for c in range(img.shape[-1])], axis=-1)


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("src,dst", [
    ((480, 640), (256, 320)),       # down by 1.875 and 2
    ((120, 160), (256, 320)),       # up by 2.13 and 2
    ((37, 53), (256, 320)),         # up by non-integer factors
    ((300, 401), (64, 96)),         # down by 4.69 and 4.18
    ((256, 320), (256, 320)),       # no change
    ((100, 77), (101, 76))])        # one axis up, the other down
def test_resize_matches_pil(src, dst, nearest):
    rng = np.random.RandomState(src[0])
    img = rng.rand(*src, 3).astype(np.float32)
    depth = (rng.rand(*src) * (rng.rand(*src) > 0.2)).astype(np.float32)
    for x in (img, depth):
        got = depth_eval._resize(x, dst, nearest)
        want = _pil_resize(x, dst, nearest)
        assert got.shape == want.shape and got.dtype == np.float32
        if nearest:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_depth_eval_cli_runs_without_pil(tmp_path, capsys):
    rng = np.random.RandomState(3)
    h, w = 90, 120
    low = rng.rand(h // 10 + 1, w // 10 + 1, 3)
    img = np.kron(low, np.ones((10, 10, 1)))[:h, :w]
    frame = (img * 65535).astype(np.uint16)
    (tmp_path / "a.png").write_bytes(torch_png.encode(frame, "pil", depth=16,
                                                      interlace=True))
    hw = (64, 96)
    pairs = {k: rng.randint(0, n, 50) for k, n in
             (("xA", hw[1]), ("yA", hw[0]), ("xB", hw[1]), ("yB", hw[0]))}
    pairs["gt"] = rng.randint(-1, 2, 50)
    np.savez(tmp_path / "a.sdr.npz", **pairs)
    # the image as load_image reads it with PIL beside: the same
    want = _pil_resize((frame >> 8).astype(np.float32) / 255.0, hw, False)
    got = depth_eval.load_image(str(tmp_path / "a.png"), hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    argv = ["--data-root", str(tmp_path), "--input-height", str(hw[0]),
            "--input-width", str(hw[1]), "--device", "cpu"]
    mp = pytest.MonkeyPatch()
    try:
        for name in [m for m in sys.modules if m == "PIL" or
                     m.startswith("PIL.")]:
            mp.delitem(sys.modules, name)
        mp.setitem(sys.modules, "PIL", None)
        result = depth_eval.main(argv)
    finally:
        mp.undo()
    assert json.loads(capsys.readouterr().out.strip()) == result
    assert result["images"] == 1 and result["sdr"]["pairs"] == 50
    assert 0.0 <= result["sdr"]["total"] <= 1.0
