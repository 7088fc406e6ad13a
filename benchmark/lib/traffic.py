"""The benchmark's two generators of traffic, read from a mix's data file
(``benchmark/traffic/<mix>.json``).

``clip``: a video clip that a caller interpolates pair by pair.  A smooth
random scene (uniform noise on a coarse grid, bicubic-upsampled) is made on
the device from the seed; frame k is its window moved ``motion`` px from
frame k-1; the frames are (H, W, 3) uint8 on the host, as a decoder hands
them over.  The clip is played forwards and backwards (``pingpong``), so
every pair, however long the window, is two neighbouring frames of one
smooth motion.

``triplets``: a pool of training triplets, each from a scene of its own:
the middle frame (the target) is the scene's centre crop, the first and
last the crops moved by ``-motion`` and ``+motion``; uint8 (H, W, 3) on the
host, as the trainer's decoder hands them over.  The order of the samples
(permutations of the pool, as the trainer's balanced sampler draws them)
and the augment records (temporal swap, flips; the crop is the whole
frame) are drawn from the seed.

The same seed gives the same frames, order and records; every seed gives
the same sizes and the same amount of work.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.lib.weights import generator

_FRAMES_STREAM, _ORDER_STREAM = 2, 3

# Each generator's keys, and the values of those that the harness's loop
# fixes: an evaluation cell runs one caller in a closed loop, one pair a
# forward.  A mix that asks for anything else needs harness code first.
GENERATORS = {
    "eval": ("clip", {"generator", "height", "width", "frames", "motion",
                      "loop", "callers", "batch", "why"},
             {"loop": "closed", "callers": 1, "batch": 1}),
    "train": ("triplets", {"generator", "height", "width", "pool", "batch",
                           "motion", "why"}, {}),
}


def check_mix(mix: dict, mode: str, name: str = "mix") -> None:
    """Raise unless ``mix`` is one that the generator of a ``mode`` cell
    reads whole: its generator, no key it does not read, and the loop,
    callers and batch that the harness implements."""
    generator_name, keys, fixed = GENERATORS[mode]
    if mix.get("generator") != generator_name:
        raise ValueError(f"{name}: a {mode} cell reads the "
                         f"{generator_name!r} generator, not "
                         f"{mix.get('generator')!r}")
    if set(mix) != keys:
        raise ValueError(f"{name}: keys {sorted(set(mix) - keys)} are not "
                         f"read, {sorted(keys - set(mix))} are missing")
    for key, value in fixed.items():
        if mix[key] != value:
            raise ValueError(f"{name}: {key} {mix[key]!r} is not "
                             f"implemented; the harness runs {key} {value!r}")


def _scene(g, n, h, w, pad_h, pad_w, device):
    coarse = torch.rand(n, 3, h // 16 + 1, w // 16 + 1, generator=g,
                        device=device)
    return F.interpolate(coarse, size=(h + pad_h, w + pad_w), mode="bicubic",
                         align_corners=False).clamp(0, 1)


def _u8(x: torch.Tensor) -> np.ndarray:
    """(3, H, W) in [0, 1] -> (H, W, 3) uint8 on the host."""
    return torch.round(x * 255).to(torch.uint8).permute(1, 2, 0).contiguous(
        ).cpu().numpy()


def make_clip(mix: dict, seed: int, device) -> list:
    """The clip's ``frames`` distinct frames, (H, W, 3) uint8."""
    h, w, n = mix["height"], mix["width"], mix["frames"]
    dx, dy = mix["motion"]
    g = generator(seed, device, _FRAMES_STREAM)
    scene = _scene(g, 1, h, w, abs(dy) * n, abs(dx) * n, device)[0]
    # frame k(y, x) = scene(y - k dy + oy, x - k dx + ox): content moves by
    # ``motion`` a frame
    oy, ox = max(dy, 0) * (n - 1), max(dx, 0) * (n - 1)
    return [_u8(scene[:, oy - k * dy:oy - k * dy + h,
                      ox - k * dx:ox - k * dx + w]) for k in range(n)]


def clip_index(k: int, frames: int) -> int:
    """The clip frame shown at step k of the forwards-and-backwards play."""
    period = 2 * (frames - 1)
    p = k % period
    return p if p < frames else period - p


def make_triplets(mix: dict, seed: int, device) -> list:
    """The pool: ``pool`` triplets (im1, im2, im3) of (H, W, 3) uint8."""
    h, w, n = mix["height"], mix["width"], mix["pool"]
    dx, dy = mix["motion"]
    px, py = abs(dx), abs(dy)
    g = generator(seed, device, _FRAMES_STREAM)
    scene = _scene(g, n, h, w, 2 * py, 2 * px, device)
    crop = lambda s, sx, sy: s[:, py + sy:py + sy + h, px + sx:px + sx + w]
    return [(_u8(crop(s, -dx, -dy)), _u8(crop(s, 0, 0)), _u8(crop(s, dx, dy)))
            for s in scene]


def batch_plans(mix: dict, seed: int):
    """Endless: for each batch, (pool indices, augment records), the
    indices running through seeded permutations of the pool and each record
    (swap, oy, ox, fliplr, flipud) with the whole frame as the crop."""
    rng = np.random.default_rng([int(seed), _ORDER_STREAM])
    n, b = mix["pool"], mix["batch"]
    order: list = []
    while True:
        while len(order) < b:
            order.extend(rng.permutation(n).tolist())
        idx, order = order[:b], order[b:]
        bits = rng.integers(0, 2, size=(b, 3))
        yield idx, [(int(s), 0, 0, int(lr), int(ud)) for s, lr, ud in bits]


def batch_plan(mix: dict, seed: int, steps: int) -> list:
    """The first ``steps`` of ``batch_plans``."""
    return list(itertools.islice(batch_plans(mix, seed), steps))


def augment_plain(triplet, record) -> dict:
    """The benchmark's own augment of one triplet: (x0, x1, y) (3, H, W)
    float32 in [0, 1], the first and last frames swapped and the three
    flipped as the record says."""
    first, mid, last = triplet
    swap, _, _, lr, ud = record
    if swap:
        first, last = last, first
    out = {}
    for key, im in (("x0", first), ("x1", last), ("y", mid)):
        if lr:
            im = im[:, ::-1]
        if ud:
            im = im[::-1]
        out[key] = torch.from_numpy(np.ascontiguousarray(im)).permute(
            2, 0, 1).float() / 255.0
    return out
