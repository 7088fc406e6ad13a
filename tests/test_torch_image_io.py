"""The port's PNG reader and writer (vfidkr_torch.utils.image_io) against
PIL: PIL-written files decode bit for bit as PIL decodes them, hand-built
streams under each of the five row filters decode to their raw arrays,
write_png round-trips and PIL reads its files equal, the formats it does
not read raise, and with PIL hidden the PNG paths of the readers, the
Vimeo-90K pipeline and the video driver still run.
"""
import struct
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

import torch_png  # noqa: E402
from vfidkr_torch.data import vimeo90k  # noqa: E402
from vfidkr_torch.utils.image_io import read_png, read_rgb, write_png  # noqa: E402


def smooth_frame(rng, h, w, c):
    """A smooth texture with noise, so PIL's encoder mixes its filters."""
    low = rng.rand(h // 8 + 2, w // 8 + 2, c)
    img = np.kron(low, np.ones((8, 8, 1)))[:h, :w] * 200
    return np.clip(img + rng.randint(0, 40, (h, w, c)), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("mode,h,w", [
    ("L", 33, 47), ("LA", 20, 31), ("RGB", 48, 64), ("RGB", 1, 1),
    ("RGB", 17, 5), ("RGBA", 29, 41), ("P", 26, 37), ("P", 9, 30)])
def test_pil_written_files_decode_as_pil_decodes_them(tmp_path, mode, h, w):
    rng = np.random.RandomState(h * w)
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 3}[mode]
    arr = smooth_frame(rng, h, w, c)
    im = Image.fromarray(arr[..., 0] if c == 1 else arr,
                         {"P": "RGB"}.get(mode, mode))
    if mode == "P":
        im = im.quantize(colors=50)
    path = tmp_path / "f.png"
    im.save(path)
    with Image.open(path) as ref:
        want_rgb = np.asarray(ref.convert("RGB"))
        want = np.asarray(ref.convert("RGB") if mode == "P" else ref)
    got = read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    np.testing.assert_array_equal(read_rgb(path), want_rgb)


@pytest.mark.parametrize("kinds", [0, 1, 2, 3, 4, "mixed", "pil"])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("h,w", [(23, 19), (3, 41), (40, 2)])
def test_each_filter_decodes_to_its_raw_array(tmp_path, kinds, c, h, w):
    rng = np.random.RandomState(c)
    img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    if kinds == "mixed":
        kinds = rng.randint(0, 5, h)
    path = tmp_path / "f.png"
    path.write_bytes(torch_png.png_bytes(img, kinds, idat_chunks=3))
    np.testing.assert_array_equal(read_png(path), img)


def test_pil_filter_choice_is_reproduced(tmp_path):
    """torch_png.pil_kinds picks the filters PIL's encoder picks (so the
    card's machine, which has no PIL, can time a PIL-filtered decode)."""
    img = smooth_frame(np.random.RandomState(3), 64, 96, 3)
    Image.fromarray(img).save(tmp_path / "f.png")
    data = (tmp_path / "f.png").read_bytes()
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(64, -1)
    assert len(set(rows[:, 0])) > 1
    np.testing.assert_array_equal(torch_png.pil_kinds(img), rows[:, 0])


@pytest.mark.parametrize("shape", [(31, 45, 3), (16, 9), (7, 12, 1), (1, 1, 3)])
def test_write_png_round_trips_and_pil_reads_it(tmp_path, shape):
    rng = np.random.RandomState(len(shape))
    img = smooth_frame(rng, shape[0], shape[1], 3)[..., :(
        shape[2] if len(shape) == 3 else 1)].reshape(shape)
    path = tmp_path / "f.png"
    write_png(path, img)
    got = read_png(path)
    np.testing.assert_array_equal(got.reshape(shape), img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im).reshape(shape), img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(path, img.astype(np.float32))


@pytest.mark.parametrize("case,match", [
    ("16bit", "16-bit"), ("interlaced", "interlaced"),
    ("truncated", "truncated"), ("crc", "CRC"), ("signature", "signature"),
    ("short_idat", "needs"), ("palette_index", "palette index")])
def test_unsupported_or_broken_files_raise(tmp_path, case, match):
    img = np.random.RandomState(0).randint(0, 256, (8, 6, 3)).astype(np.uint8)
    data = torch_png.png_bytes(img, 0)
    if case == "16bit":
        data = torch_png.png_bytes(img, 0, depth=16)
    elif case == "interlaced":
        data = torch_png.png_bytes(img, 0, interlace=1)
    elif case == "truncated":
        data = data[:len(data) // 2]
    elif case == "crc":
        data = data[:-20] + bytes([data[-20] ^ 1]) + data[-19:]
    elif case == "signature":
        data = b"\x00" + data[1:]
    elif case == "short_idat":
        # the header claims a ninth row the stream does not hold
        body = data[16:20] + struct.pack(">I", 9) + data[24:29]
        data = (data[:16] + body
                + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:])
    elif case == "palette_index":
        data = torch_png.png_bytes(img[..., :1] % 4, 0, palette=np.zeros(
            (3, 3)))
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        read_png(path)
    assert "bad.png" in str(err.value)


@pytest.fixture
def no_pil(monkeypatch):
    """PIL hidden: ``import PIL`` raises ImportError."""
    for name in [m for m in sys.modules if m == "PIL" or
                 m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_png_paths_run_without_pil(tmp_path, no_pil, capsys):
    rng = np.random.RandomState(1)
    frames = [smooth_frame(rng, 64, 64, 3) for _ in range(2)]
    clip = tmp_path / "clip"
    clip.mkdir()
    for i, frame in enumerate(frames):
        write_png(clip / f"{i:05d}.png", frame)
    np.testing.assert_array_equal(read_rgb(clip / "00000.png"), frames[0])
    seq = tmp_path / "vimeo" / "sequences" / "00000" / "0000"
    seq.mkdir(parents=True)
    for j, frame in enumerate((frames[0], frames[1], frames[0]), start=1):
        write_png(seq / f"im{j}.png", frame)
    x0, x1, y = vimeo90k.load_triplet(str(tmp_path / "vimeo"), "00000/0000",
                                      False, np.random.RandomState(0),
                                      (64, 64))
    np.testing.assert_array_equal(y, frames[1] / np.float32(255.0))
    np.testing.assert_array_equal(x0, x1)
    gray = tmp_path / "g.png"
    write_png(gray, frames[0][..., 0])
    np.testing.assert_array_equal(read_rgb(gray),
                                  np.repeat(frames[0][..., :1], 3, axis=-1))

    from vfidkr_torch.apps import interpolate_video
    summary = interpolate_video.main([
        "--frames-dir", str(clip), "--out-dir", str(tmp_path / "out"),
        "--device", "cpu"])
    assert summary["input_frames"] == 2
    assert summary["interpolated_frames"] == 1
    np.testing.assert_array_equal(
        read_rgb(tmp_path / "out" / "00002000.png"), frames[1])
    assert read_rgb(tmp_path / "out" / "00001001.png").shape == (64, 64, 3)
    assert "PIL" not in sys.modules or sys.modules["PIL"] is None

    (tmp_path / "f.jpg").write_bytes(b"not decoded")
    with pytest.raises(ImportError, match="f.jpg"):
        read_rgb(tmp_path / "f.jpg")
