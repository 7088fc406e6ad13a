"""The plain versions of K7 and K3 against the JAX package, on the inputs
that reach the kernels' branches (tests/torch_geometry.py): the card holds
each kernel to its plain version, so these pin the plain versions to the
reference exactly where the kernels take their staged, direct-gather and
word-scan paths.

* ``finalize_plain`` (K3) against JAX's ``fill_holes_pallas`` (interpret
  mode) and ``fill_holes``: a full-height band of empty columns at the
  frame's edge, runs of holes across 32- and 64-cell word boundaries (at a
  size of whole 32x32 tiles and at a ragged one), and an all-hole field.
  Tolerance 1e-6 absolute and relative: the same divisions, the neighbours
  summed in the same order.
* ``filter_interpolate_plain`` (K7's plain version) at C = 196 against JAX's
  ``filter_interpolate(impl="block")``: across a sharp flow discontinuity
  (tiles past K7's staging box) and at a ragged 37x75 frame.  Tolerance
  1e-5 absolute and relative, float32 sums in another order.

The port is NCHW, the JAX package NHWC.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_geometry as geo  # noqa: E402
from vfidkr_tpu.ops import filter_interpolate as jax_filter_interpolate  # noqa: E402
from vfidkr_tpu.ops.flow_projection import fill_holes as jax_fill_holes  # noqa: E402
from vfidkr_tpu.ops.pallas.fillhole_kernel import fill_holes_pallas  # noqa: E402

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.ops import flow_projection as FP  # noqa: E402
from vfidkr_torch.ops.filter_interpolation import (  # noqa: E402
    filter_interpolate, filter_interpolate_plain)

CTX_SOURCE = (Path(__file__).resolve().parents[1] / "vfidkr_torch" / "csrc"
              / "filter_interpolate_ctx.cu")


def _hole_sums(layout):
    rng = np.random.RandomState(7)
    if layout == "edge band":
        flow = torch.from_numpy(geo.edge_band_flow(1, 48, 96))
        return FP.scatter4_plain(flow).numpy()
    if layout == "word-crossing runs":
        return geo.word_crossing_sums(rng, 2, 64, 128)
    if layout == "ragged word-crossing runs":
        return geo.word_crossing_sums(rng, 1, 70, 140)
    return np.zeros((1, 3, 40, 72), np.float32)          # all holes


@pytest.mark.parametrize("layout", ["edge band", "word-crossing runs",
                                    "ragged word-crossing runs", "all holes"])
def test_finalize_plain_matches_jax_fill(layout):
    acc = _hole_sums(layout)
    cnt = acc[:, 2]
    if layout == "edge band":
        assert (cnt[:, :, :24] <= 0).all() and (cnt[:, :, 24:] > 0).all()
    avg = np.where(cnt[:, None] > 0, acc[:, :2] / np.maximum(cnt, 1e-30)[:, None],
                   0.0).astype(np.float32).transpose(0, 2, 3, 1)
    kernels.reset_launches()
    got = FP.finalize(torch.from_numpy(acc)).numpy().transpose(0, 2, 3, 1)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    want = np.asarray(fill_holes_pallas(jnp.asarray(cnt), jnp.asarray(avg)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jax.jit(jax.vmap(jax_fill_holes))(jnp.asarray(cnt),
                                                         jnp.asarray(avg)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if layout == "all holes":
        assert not got.any()


def _warp_case(kind):
    rng = np.random.RandomState(11)
    if kind == "discontinuity":
        n, h, w = 2, 64, 96
        flow = geo.discontinuous_flow(rng, n, h, w)
    else:
        n, h, w = 2, 37, 75
        flow = geo.smooth_flow(rng, n, h, w, 8.0)
    return geo.k7_inputs(rng, n, 196, h, w, flow)


def _box_cells(flow):
    """Per 8x32 tile with a valid landing: the cells of the box that the
    4x4 windows of its valid pixels cover, as K7 reduces it."""
    n, _, h, w = flow.shape
    fx, fy = flow[:, 0], flow[:, 1]
    x2 = np.arange(w)[None, None, :] + fx
    y2 = np.arange(h)[None, :, None] + fy
    valid = ((x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
             & (np.abs(fx) < w / 2) & (np.abs(fy) < h / 2))
    ix, iy = np.floor(x2).astype(int), np.floor(y2).astype(int)
    cells = []
    for b in range(n):
        for y0 in range(0, h, 8):
            for x0 in range(0, w, 32):
                v = valid[b, y0:y0 + 8, x0:x0 + 32]
                if v.any():
                    xs = ix[b, y0:y0 + 8, x0:x0 + 32][v]
                    ys = iy[b, y0:y0 + 8, x0:x0 + 32][v]
                    cells.append((np.ptp(xs) + 4) * (np.ptp(ys) + 4))
    return np.array(cells)


def test_discontinuous_flow_spreads_past_the_staging_box():
    """The discontinuity sends some tiles down K7's direct gather and leaves
    the others staged; the ragged smooth flow stages every tile."""
    box_max = int(re.search(r"BOX_MAX = (\d+);", CTX_SOURCE.read_text())[1])
    jump = _box_cells(_warp_case("discontinuity")[1])
    assert (jump > box_max).any() and (jump <= box_max).any()
    assert (_box_cells(_warp_case("ragged")[1]) <= box_max).all()


@pytest.mark.parametrize("kind", ["discontinuity", "ragged"])
def test_ctx_warp_plain_matches_jax_block(kind):
    image, flow, filt = _warp_case(kind)
    kernels.reset_launches()
    got = filter_interpolate(*(torch.from_numpy(a) for a in (image, flow, filt)))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert torch.equal(got, filter_interpolate_plain(
        *(torch.from_numpy(a) for a in (image, flow, filt))))
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    want = jax_filter_interpolate(nhwc(image), nhwc(flow), nhwc(filt),
                                  impl="block")
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
