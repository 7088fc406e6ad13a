"""The plain versions of K7, K3, K2, K1 and K6 against the JAX package, on the
inputs that reach the kernels' branches (tests/torch_geometry.py): the card
holds each kernel to its plain version, so these pin the plain versions to
the reference exactly where the kernels take their staged, direct-gather,
word-scan, shared-memory-box, direct-add and ragged-edge paths.

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
* ``scatter4_plain`` (K2's plain version), plain and depth-weighted, against
  JAX's ``scatter4_band_pallas`` (interpret mode) on its own landing prep
  where the frame is whole 16x32 bands and the landings stay in its slab,
  else against JAX's XLA scatter: a converging flow (several sources a
  cell), a jump whose tiles' targets spread past K2's shared-memory box,
  landings exactly on the last column and row (the double add), and the
  ragged 37x75 and 37x76 frames.  The count to 1e-6 (whole numbers), the
  sums to 1e-5 absolute and relative.
* ``filter_interpolate_plain`` (K1's plain version) against JAX's
  ``filter_bandmm_pallas`` (interpret mode, through
  ``_filter_interpolate_slab``) at 16-row bands, else JAX's
  ``filter_interpolate(impl="block")``: the |f| == W/2, H/2 and W/2 - 0.5,
  H/2 - 0.5 rows and the inclusive edges, N = 6, and ragged widths (75,
  76) at C = 1, 3 and 8.  Tolerance 1e-5 absolute and relative.
* K6's plain versions, the flow gradient of ``scatter4`` (autograd through
  ``scatter4_plain``) and the depth projection's backward
  (``depth_flow_project_bwd_plain``, with and without the depth gradient),
  against JAX's VJPs on K2's inputs and at N = 6: through
  ``scatter4_bwd_pallas`` (interpret mode) where the frame is whole 16x32
  bands and every pixel's cells stay in its slab, else through
  ``_scatter4_transpose`` and ``jax.vjp`` of ``depth_flow_project``.
  Tolerance 1e-5 absolute and relative.

The port is NCHW, the JAX package NHWC.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_geometry as geo  # noqa: E402
import vfidkr_tpu.ops.flow_projection as P  # noqa: E402
from vfidkr_tpu.ops import filter_interpolate as jax_filter_interpolate  # noqa: E402
from vfidkr_tpu.ops.filter_interpolation import _filter_interpolate_slab  # noqa: E402
from vfidkr_tpu.ops.flow_projection import fill_holes as jax_fill_holes  # noqa: E402
from vfidkr_tpu.ops.pallas.fillhole_kernel import fill_holes_pallas  # noqa: E402
from vfidkr_tpu.ops.pallas.projection_band_kernel import (  # noqa: E402
    _bounds, scatter4_band_pallas)

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.ops import flow_projection as FP  # noqa: E402
from vfidkr_torch.ops.filter_interpolation import (  # noqa: E402
    filter_interpolate, filter_interpolate_plain)

CSRC = Path(__file__).resolve().parents[1] / "vfidkr_torch" / "csrc"
CTX_SOURCE = CSRC / "filter_interpolate_ctx.cu"
SCATTER_SOURCE = CSRC / "flow_project_scatter.cu"


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


# K2: (flow generator, N, H, W, JAX path): "band" where the frame is whole
# 16x32 bands and every landing stays within the banded kernel's slab
SCATTER_CASES = {
    "converging": (lambda r, n, h, w: geo.converging_flow(n, h, w), 2, 64, 64,
                   "band"),
    "jump": (geo.scatter_jump_flow, 2, 64, 128, "xla"),
    "border landings": (geo.border_landing_flow, 2, 64, 64, "band"),
    "ragged 37x75": (lambda r, n, h, w: geo.smooth_flow(r, n, h, w, 8.0),
                     2, 37, 75, "xla"),
    "ragged 37x76": (lambda r, n, h, w: geo.smooth_flow(r, n, h, w, 8.0),
                     2, 37, 76, "xla"),
}


def _scatter_case(kind):
    make, n, h, w, path = SCATTER_CASES[kind]
    rng = np.random.RandomState(13)
    return make(rng, n, h, w), geo.depth_weight(rng, n, h, w), path


def _k2_boxes(flow):
    """Per 8x32 source tile with a valid landing: the cells of the box its
    valid pixels' four targets cover, as K2 reduces it (widened to whole
    groups of four columns where W % 4 == 0, and its rows padded to a
    multiple of 32 cells)."""
    n, _, h, w = flow.shape
    x2 = np.arange(w)[None, None, :] + flow[:, 0]
    y2 = np.arange(h)[None, :, None] + flow[:, 1]
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    ix, iy = np.floor(x2).astype(int), np.floor(y2).astype(int)
    vec = 4 if w % 4 == 0 else 1
    cells = []
    for b in range(n):
        for y0 in range(0, h, 8):
            for x0 in range(0, w, 32):
                v = valid[b, y0:y0 + 8, x0:x0 + 32]
                if v.any():
                    xs = ix[b, y0:y0 + 8, x0:x0 + 32][v]
                    ys = iy[b, y0:y0 + 8, x0:x0 + 32][v]
                    bx0 = xs.min() // vec * vec
                    bx1 = min(xs.max() + 1, w - 1)
                    pitch = ((((bx1 - bx0) | (vec - 1)) + 1) + 31) // 32 * 32
                    cells.append(pitch * (min(ys.max() + 1, h - 1) - ys.min() + 1))
    return np.array(cells)


def test_scatter_inputs_reach_both_branches():
    """The jump sends some of K2's tiles to the direct adds and sums the
    others in shared memory; every other case sums every tile there; the
    border case lands on the last column and row; the converging flow puts
    several sources on a cell."""
    box_max = int(re.search(r"BOX_MAX = (\d+);", SCATTER_SOURCE.read_text())[1])
    for kind in SCATTER_CASES:
        boxes = _k2_boxes(_scatter_case(kind)[0])
        if kind == "jump":
            assert (boxes > box_max).any() and (boxes <= box_max).any()
        else:
            assert (boxes <= box_max).all(), kind
    flow = torch.from_numpy(_scatter_case("border landings")[0])
    cnt = FP.scatter4_plain(flow)[:, 2]
    assert cnt[:, -1, -1].min() >= 4 and cnt[:, 5, -1].min() >= 2
    cnt = FP.scatter4_plain(torch.from_numpy(_scatter_case("converging")[0]))
    assert cnt[:, 2].max() >= 8


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "depth-weighted"])
@pytest.mark.parametrize("kind", list(SCATTER_CASES))
def test_scatter_plain_matches_jax(kind, weighted):
    flow, depth, path = _scatter_case(kind)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    if weighted:
        prep = jax.vmap(P._depth_prep)(nhwc(flow), jnp.asarray(depth))
    else:
        prep = jax.vmap(P._scatter_prep)(nhwc(flow))
    if path == "band":
        assert not bool(P._oversize_pred(prep[0], prep[2], prep[4], 16, 32, 32))
        want = scatter4_band_pallas(*prep, band=16, tw=32)
    else:
        want = P._scatter4(*prep)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    kernels.reset_launches()
    got = FP.scatter4(torch.from_numpy(flow),
                      torch.from_numpy(depth) if weighted else None).numpy()
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    tol = 1e-5 if weighted else 1e-6      # a weight sum; a count
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=tol, atol=tol)
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-5, atol=1e-5)


# K1: (flow generator, N, C, H, W, JAX path): "slab" reaches
# filter_bandmm_pallas at 16-row bands a frame wide
WARP_CASES = {
    "edge flows": (geo.warp_edge_flow, 2, 3, 48, 64, "slab"),
    "N=6": (lambda r, n, h, w: geo.smooth_flow(r, n, h, w, 6.0),
            6, 3, 32, 64, "slab"),
    "ragged 37x75 C=3": (lambda r, n, h, w: geo.smooth_flow(r, n, h, w, 8.0),
                         2, 3, 37, 75, "block"),
    "ragged 37x76 C=1": (lambda r, n, h, w: geo.smooth_flow(r, n, h, w, 8.0),
                         2, 1, 37, 76, "block"),
    "ragged 37x76 C=8": (lambda r, n, h, w: geo.smooth_flow(r, n, h, w, 8.0),
                         1, 8, 37, 76, "block"),
}


@pytest.mark.parametrize("kind", list(WARP_CASES))
def test_warp_plain_matches_jax(kind):
    make, n, c, h, w, path = WARP_CASES[kind]
    rng = np.random.RandomState(17)
    image, flow, filt = geo.k7_inputs(rng, n, c, h, w, make(rng, n, h, w))
    kernels.reset_launches()
    got = filter_interpolate(*(torch.from_numpy(a) for a in (image, flow, filt)))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    if path == "slab":
        want = _filter_interpolate_slab(nhwc(image), nhwc(flow), nhwc(filt),
                                        4, 16, w)
    else:
        want = jax_filter_interpolate(nhwc(image), nhwc(flow), nhwc(filt),
                                      impl="block")
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    if kind == "edge flows":
        # |fx| == W/2 and |fy| == H/2 copy the source; W/2 - 0.5 does not
        assert torch.equal(got[0, :, 2, :w // 2 - 1],
                           torch.from_numpy(image[0, :, 2, :w // 2 - 1]))
        assert torch.equal(got[0, :, 4], torch.from_numpy(image[0, :, 4]))
        assert not torch.equal(got[0, :, 3, :w // 2 - 1],
                               torch.from_numpy(image[0, :, 3, :w // 2 - 1]))


# K6: K2's inputs and the paths' move at N = 6; "band" as for K2, every
# pixel's cells (an invalid one's clamped) within scatter4_bwd_pallas's slab
GATHER_CASES = {**SCATTER_CASES, "N=6": (
    lambda r, n, h, w: geo.smooth_flow(r, n, h, w, 0.5, (5.3, -3.1)),
    6, 32, 64, "band")}
BAND = (16, 32, 32)               # band, tw, rh of scatter4_bwd_pallas


def _gather_case(kind):
    """flow, depth (NCHW, (N,H,W)), the (N,3,H,W) cotangent and the JAX
    path of K6's case ``kind``."""
    make, n, h, w, path = GATHER_CASES[kind]
    rng = np.random.RandomState(19)
    flow = make(rng, n, h, w)
    depth = geo.depth_weight(rng, n, h, w)
    return flow, depth, rng.randn(n, 3, h, w).astype(np.float32), path


def _in_slab(prep):
    """Every pixel's top-left cell within scatter4_bwd_pallas's slab, as
    JAX's _scatter4_bwd requires before it takes the kernel."""
    iy_t, ix_l = np.asarray(prep[0]), np.asarray(prep[2])
    _, h, w = iy_t.shape
    rv, _ = _bounds(*BAND)
    return bool((np.abs(iy_t - np.arange(h)[:, None]) <= rv - 1).all()
                and (np.abs(ix_l - np.arange(w)) <= BAND[2] - 1).all())


@functools.lru_cache(maxsize=None)
def _jax_gather(kind, channels):
    """JAX's VJP of K6's case ``kind``, under its (N,3,H,W) cotangent
    (``channels`` = 2: of ``_scatter4`` at the (-fx, -fy, 1) values, the
    flow gradient; 3: of the depth projection, the flow and depth
    gradients), NHWC numpy arrays.  On the band cases through its Pallas
    gather in interpret mode: ``_band_scatter_params`` set to 16x32 bands,
    as on a TPU, for the backward alone."""
    flow, depth, g, path = _gather_case(kind)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    if channels == 2:
        prep = jax.jit(jax.vmap(P._scatter_prep))(nhwc(flow))
        res, cot = prep[:4], nhwc(g)
        bwd = lambda r, c: P._scatter4_bwd(r, c)[4]  # noqa: E731
    else:
        prep = jax.jit(jax.vmap(P._depth_prep))(nhwc(flow), jnp.asarray(depth))
        _, res = jax.jit(P._dfp_fwd, static_argnums=2)(
            nhwc(flow), jnp.asarray(depth), False)
        cot = nhwc(g[:, :2])
        bwd = lambda r, c: P._dfp_bwd(False, r, c)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        if path == "band":
            assert _in_slab(prep)
            mp.setattr(P, "_band_scatter_params", lambda h, w, c: BAND)
        got = jax.jit(bwd)(res, cot)
    if channels == 2:
        # the dvals of (-fx·valid, -fy·valid, valid): the flow gradient
        return (-np.asarray(got)[..., :2] * np.asarray(prep[4])[..., 2:],)
    return tuple(np.asarray(a) for a in got)


@pytest.mark.parametrize("grad", ["C=2", "C=3", "C=3 no depth grad"])
@pytest.mark.parametrize("kind", list(GATHER_CASES))
def test_gather_plain_matches_jax(kind, grad):
    """K6's plain versions through the port's autograd on the CPU, against
    JAX's VJP of the same projection (``_jax_gather``)."""
    flow, depth, g, _ = _gather_case(kind)
    need_depth = grad == "C=3"
    f = torch.from_numpy(flow).requires_grad_()
    d = torch.from_numpy(depth).requires_grad_(need_depth)
    kernels.reset_launches()
    if grad == "C=2":
        FP.scatter4(f).backward(torch.from_numpy(g))
    else:
        FP.depth_flow_project(f, d).backward(torch.from_numpy(g[:, :2]))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert (d.grad is not None) == need_depth
    want = _jax_gather(kind, 2 if grad == "C=2" else 3)
    np.testing.assert_allclose(f.grad.numpy().transpose(0, 2, 3, 1), want[0],
                               rtol=1e-5, atol=1e-5)
    if need_depth:
        np.testing.assert_allclose(d.grad.numpy(), want[1], rtol=1e-5,
                                   atol=1e-5)
