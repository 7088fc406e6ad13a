"""The port's row sharding (vfidkr_torch.parallel.spatial) and its sharded
ops against the JAX package's (vfidkr_tpu.parallel.spatial on the 8 forced
CPU devices of tests/conftest.py), and against the port unsharded, on the
same inputs made with numpy from a seed.

On the CPU the port's shards are threads of this process, each running the
plain versions of the kernels with the block's place in the frame.

Tolerances are those of tests/test_parallel.py and
tests/test_parallel_dain.py: 1e-6 for the halo exchange (a 3x3 mean), rtol
1e-4 / atol 1e-5 for projected flows and rtol 1e-4 / atol 1e-4 for warped
frames; the per-shard plain scatter at 1e-5 absolute and 1e-6 relative
(float32 sums of up to ~150 in another order), its count channel exactly,
the fill at 1e-6 and the warp as the chains.  The full
sharded DAIN forward is held to JAX's sharded forward (the same tiling) by
tests/test_torch_dain.py's tolerances for DAIN (rtol 1e-3, atol 2e-4).
"""
import io
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import vfidkr_tpu.ops.flow_projection as JFP  # noqa: E402
from vfidkr_tpu.models import DAIN as JaxDAIN  # noqa: E402
from vfidkr_tpu.ops import depth_flow_project as jax_depth_flow_project  # noqa: E402
from vfidkr_tpu.ops import filter_interpolate as jax_filter_interpolate  # noqa: E402
from vfidkr_tpu.ops import flow_project as jax_flow_project  # noqa: E402
from vfidkr_tpu.parallel import spatial as JS  # noqa: E402
from vfidkr_tpu.utils.padding import pad_to_multiple as jax_pad_to_multiple  # noqa: E402

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.apps import interpolate_video as video  # noqa: E402
from vfidkr_torch.convert import load_jax_variables  # noqa: E402
from vfidkr_torch.models import DAIN  # noqa: E402
from vfidkr_torch.ops import filter_interpolation as FI  # noqa: E402
from vfidkr_torch.ops import flow_projection as FP  # noqa: E402
from vfidkr_torch.parallel import spatial as S  # noqa: E402

N_SHARDS, HALO = 8, 16
B, H, W = 1, 128, 64


def nchw(a):
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _mesh(n=N_SHARDS):
    devs = jax.devices()
    assert len(devs) >= n, "tests/conftest.py forces 8 CPU devices"
    return Mesh(np.array(devs[:n]), ("spatial",))


def _jax_sharded(fn, *arrays, n=N_SHARDS, halo=HALO, edge_mode="edge"):
    return jax.tree_util.tree_map(np.asarray, jax.jit(JS.spatial_shard_fn(
        fn, _mesh(n), halo, edge_mode=edge_mode))(
            *(jnp.asarray(a) for a in arrays)))


def _torch_sharded(fn, *arrays, n=N_SHARDS, halo=HALO, edge_mode="edge"):
    return S.spatial_shard_fn(fn, ["cpu"] * n, halo, edge_mode)(
        *(nchw(a) for a in arrays))


# ---------------------------------------------------------------------------
# the halo exchange
# ---------------------------------------------------------------------------

def test_halo_exchange_exact_for_a_3x3_mean(rng):
    """A 3x3 mean (reach 1 row) with halo 1 and zero edges over 4 shards is
    the unsharded mean, as tests/test_parallel.py holds JAX's."""
    x = rng.rand(2, 32, 16, 3).astype(np.float32)

    def mean3(t):
        k = torch.full((t.shape[1], 1, 3, 3), 1.0 / 9.0)
        return torch.nn.functional.conv2d(t, k, padding=1,
                                          groups=t.shape[1])

    want = mean3(nchw(x))
    got = _torch_sharded(mean3, x, n=4, halo=1, edge_mode="zero")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_halo_exchange_replicates_the_edges(rng):
    """A shift by one row over 2 shards with halo 1: row 3 sees row 4 across
    the shard edge, and the last row reads the replicated edge row; the
    whole result equals JAX's."""
    x = rng.rand(1, 8, 4, 1).astype(np.float32)
    got = _torch_sharded(lambda t: torch.roll(t, -1, dims=2), x, n=2,
                         halo=1).numpy()
    want = _jax_sharded(lambda t: jnp.roll(t, -1, axis=1), x, n=2, halo=1)
    np.testing.assert_array_equal(nhwc(torch.from_numpy(got)), want)
    np.testing.assert_array_equal(got[0, 0, 3], x[0, 4, :, 0])
    np.testing.assert_array_equal(got[0, 0, 7], x[0, 7, :, 0])


def test_frame_helpers_outside_and_inside_a_frame():
    assert S.current_spatial_frame() is None
    assert S.global_row_frame(64) is None
    assert S.row_frame(40) == (0, 40)
    seen = []

    def probe(t):
        seen.append(S.row_frame(t.shape[2]))
        with pytest.raises(RuntimeError, match="no gradient"):
            S.no_grad_in_frame("probe", t.clone().requires_grad_())
        return t

    S.spatial_shard_fn(probe, ["cpu"] * 4, 3)(torch.zeros(1, 1, 16, 2))
    assert sorted(seen) == [(-3, 16), (1, 16), (5, 16), (9, 16)]


def test_a_failing_shard_raises_its_own_error():
    def fn(t):
        axis, _ = S.current_spatial_frame()
        if axis.index == 2:
            raise KeyError("shard 2")
        return axis.all_gather(t)[0]

    with pytest.raises(KeyError, match="shard 2"):
        S.spatial_shard_fn(fn, ["cpu"] * 4, 2)(torch.zeros(1, 1, 16, 2))


def test_shard_model_rows_needs_a_device_a_shard():
    """JAX's ``--spatial-shards 2 > 1 devices`` error: by default the shards
    take the first n CUDA devices, and this machine has fewer."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("the machine has two CUDA devices")
    with pytest.raises(ValueError, match="--spatial-shards 2 > "):
        S.shard_model_rows(lambda a, b: a, 2)
    with pytest.raises(ValueError, match="2 shards need 2 devices"):
        S.shard_model_rows(lambda a, b: a, 2, devices=["cpu"])


def test_sharded_grad_raises():
    flow = torch.zeros(1, 2, 32, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        S.spatial_shard_fn(lambda f: FP.flow_project(f), ["cpu"] * 2, 4)(flow)


# ---------------------------------------------------------------------------
# the op chains, sharded 8-way against JAX's sharded chains and the port
# unsharded
# ---------------------------------------------------------------------------

def _island_flow(rng, base, island):
    flow = (np.asarray(base, np.float32)
            + (rng.rand(B, H, W, 2).astype(np.float32) - 0.5) * 2.0)
    (r0, r1), (c0, c1) = island
    flow[:, r0:r1, c0:c1] = 0.0          # a zero-motion island
    return flow


def _chain_inputs(rng, case):
    image = rng.rand(B, H, W, 196 if case == "ctx" else 3).astype(np.float32)
    filt = rng.rand(B, H, W, 16).astype(np.float32)
    if case == "no fill":
        flow = (rng.rand(B, H, W, 2).astype(np.float32) - 0.5) * 2 * 8.0
    elif case == "depth":
        flow = _island_flow(rng, (4.0, -6.0), ((30, 70), (5, 25)))
    else:
        flow = _island_flow(rng, (5.0, -7.0), ((40, 80), (10, 30)))
    depth = rng.rand(B, H, W, 1).astype(np.float32) + 0.1
    return image, flow, filt, depth


def _chains(case):
    """(JAX chain on NHWC, port chain on NCHW) -> (offsets, frame)."""
    fill = case != "no fill"
    if case in ("depth", "ctx"):
        def jchain(image, flow, filt, depth):
            offs = jax_depth_flow_project(flow, depth[..., 0], hole_fill=True)
            return offs, jax_filter_interpolate(image, offs, filt,
                                                impl="block")

        def tchain(image, flow, filt, depth):
            offs = FP.depth_flow_project(flow, depth, hole_fill=True)
            return offs, FI.filter_interpolate(image, offs, filt)
        return jchain, tchain

    def jchain(image, flow, filt, depth):
        offs = jax_flow_project(flow, hole_fill=fill)
        return offs, jax_filter_interpolate(image, offs, filt, impl="block")

    def tchain(image, flow, filt, depth):
        offs = FP.flow_project(flow, hole_fill=fill)
        return offs, FI.filter_interpolate(image, offs, filt)
    return jchain, tchain


@pytest.mark.parametrize("case", ["no fill", "fill", "depth", "ctx"])
def test_sharded_op_chain_matches_jax_and_unsharded(rng, case):
    """flow_project (or depth_flow_project) then filter_interpolate, 128x64
    in 8 shards of 16 rows with halo 16: with |flow| + the window's reach
    inside the halo, every row is the frame's (JAX's contract,
    tests/test_parallel_dain.py); the fill's holes cross the shard edges."""
    image, flow, filt, depth = _chain_inputs(rng, case)
    jchain, tchain = _chains(case)
    want_offs, want_out = _jax_sharded(jchain, image, flow, filt, depth)
    kernels.reset_launches()
    with torch.no_grad():
        offs, out = _torch_sharded(tchain, image, flow, filt, depth)
        ref_offs, ref_out = tchain(*(nchw(a) for a in (image, flow, filt,
                                                         depth)))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    np.testing.assert_allclose(nhwc(offs), want_offs, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nhwc(out), want_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(offs.numpy(), ref_offs.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the plain kernels on each shard's block, halo rows included, against JAX's
# ops under its spatial frame (shard 0 has row0 < 0; shard 7 is the last)
# ---------------------------------------------------------------------------

SPEC = P(None, "spatial", None, None)


def _jax_blocks(local, *arrays):
    """``local`` on each shard's halo-extended block inside JAX's spatial
    frame; its outputs uncropped, split into one block a shard."""
    def body(*xs):
        padded = [JS.halo_exchange_rows(x, HALO, "spatial") for x in xs]
        with JS.spatial_frame("spatial", HALO):
            return (*padded, *local(*padded))

    outs = jax.jit(jax.shard_map(
        body, mesh=_mesh(), in_specs=(SPEC,) * len(arrays), out_specs=SPEC))(
            *(jnp.asarray(a) for a in arrays))
    return [np.split(np.asarray(o), N_SHARDS, axis=1) for o in outs]


def test_sharded_plain_kernels_match_jax_on_every_block(rng):
    image, flow, filt, _ = _chain_inputs(rng, "fill")
    hs = H // N_SHARDS

    def local(flow, image, filt):
        iy_t, iy_b, ix_l, ix_r, vals = jax.vmap(JFP._scatter_prep)(flow)
        acc = jax.vmap(JFP._scatter4_onehot)(iy_t, iy_b, ix_l, ix_r, vals)
        offs = JFP._finalize_batched(acc[..., :2], acc[..., 2], True,
                                      flow.dtype)
        return acc, offs, jax_filter_interpolate(image, offs, filt,
                                                 impl="block")

    flows, images, filts, accs, fills, warps = _jax_blocks(
        local, flow, image, filt)
    port_accs = []
    for i in range(N_SHARDS):
        row0 = i * hs - HALO
        acc = FP.scatter4_plain(nchw(flows[i]), None, row0, H)
        np.testing.assert_array_equal(nhwc(acc)[..., 2], accs[i][..., 2])
        np.testing.assert_allclose(nhwc(acc), accs[i], rtol=1e-6, atol=1e-5,
                                   err_msg=f"K2 shard {i}")
        port_accs.append(acc)
    interior = (HALO, hs + HALO)
    summaries = torch.stack([FP.fill_summary(a, *interior)
                             for a in port_accs])
    for i in range(N_SHARDS):
        up, down = FP.fill_carries(summaries, i)
        offs = FP.finalize_plain(port_accs[i], interior, up, down)
        np.testing.assert_allclose(nhwc(offs), fills[i], rtol=1e-6,
                                   atol=1e-6, err_msg=f"K3 shard {i}")
        out = FI.filter_interpolate_plain(nchw(images[i]), offs,
                                          nchw(filts[i]), i * hs - HALO, H)
        np.testing.assert_allclose(nhwc(out), warps[i], rtol=1e-4,
                                   atol=1e-4, err_msg=f"K1 shard {i}")


def test_first_and_last_shard_mask_phantom_rows(rng):
    """On the first shard (row0 = -halo) the top halo rows, and on the last
    the bottom ones, are edge copies of rows outside the frame: as scatter
    sources they add nothing, and no landing counts past the frame."""
    hs = H // N_SHARDS
    block = torch.from_numpy(
        (rng.rand(1, 2, hs + 2 * HALO, W).astype(np.float32) - 0.5) * 8)
    first = FP.scatter4_plain(block, None, -HALO, H)
    last = FP.scatter4_plain(block, None, H - hs - HALO, H)
    _, vals = FP.scatter4_targets(block, None, -HALO, H)
    src_rows = vals[2].reshape(hs + 2 * HALO, W).sum(1)
    assert src_rows[:HALO].sum() == 0 and src_rows[HALO:].sum() > 0
    # landings stop at the frame's first and last rows
    assert first[0, 2, :HALO].sum() == 0
    assert last[0, 2, hs + HALO:].sum() == 0
    # the warp copies the source where the landing leaves the frame
    image = torch.rand(1, 3, hs + 2 * HALO, W)
    filt = torch.rand(1, 16, hs + 2 * HALO, W)
    up = torch.zeros_like(block)
    up[:, 1] = -(HALO + 1.0)             # every landing of row HALO: row -1
    out = FI.filter_interpolate_plain(image, up, filt, -HALO, H)
    torch.testing.assert_close(out[:, :, HALO], image[:, :, HALO],
                               rtol=0, atol=0)


def test_whole_frame_arguments_change_nothing(rng):
    """row0 = 0, hg = h (and the whole frame's rows searched, no carries)
    give the unsharded results bit for bit."""
    import torch_geometry as geo
    flow = torch.from_numpy(geo.border_landing_flow(rng, 2, 37, 75))
    weight = torch.from_numpy(geo.depth_weight(rng, 2, 37, 75))
    image = torch.rand(2, 3, 37, 75)
    filt = torch.randn(2, 16, 37, 75)
    for wt in (None, weight):
        torch.testing.assert_close(FP.scatter4_plain(flow, wt, 0, 37),
                                   FP.scatter4_plain(flow, wt),
                                   rtol=0, atol=0)
    acc = FP.scatter4_plain(torch.from_numpy(
        geo.edge_band_flow(2, 37, 75)))
    none = torch.zeros(2, 3, 75)
    torch.testing.assert_close(FP.finalize_plain(acc, (0, 37), none, none),
                               FP.finalize_plain(acc), rtol=0, atol=0)
    torch.testing.assert_close(
        FI.filter_interpolate_plain(image, flow, filt, 0, 37),
        FI.filter_interpolate_plain(image, flow, filt), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the full DAIN forward, sharded, and the video driver's pad rule
# ---------------------------------------------------------------------------

def _smooth_frames():
    h, w = 256, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([np.sin(yy / 37.0) * 0.5 + 0.5,
                     np.cos(xx / 53.0) * 0.5 + 0.5,
                     (xx + yy) / (h + w)], axis=-1)
    return base[None], np.roll(base, (3, 5), axis=(0, 1))[None]


def _tame(tree, rng, name=""):
    """All weights x0.5; biases jittered so the flows are non-trivial (as
    tests/test_torch_dain.py tames them)."""
    if isinstance(tree, dict):
        return {k: _tame(v, rng, k) for k, v in tree.items()}
    v = np.asarray(tree, np.float32) * 0.5
    if name == "bias":
        v = v + ((rng.rand(*v.shape) - 0.5) * 0.02).astype(np.float32)
    return v


def test_sharded_dain_matches_jax_sharded_dain():
    """DAIN at 256x64 in 8 shards with halo 16 (32 + 2x16 = 64 local rows,
    PWC-Net's /64): the port's sharded forward against JAX's sharded
    forward, the same tiling, on JAX's tamed weights
    (tests/test_parallel_dain.py's frames)."""
    i0, i2 = _smooth_frames()
    model_j = JaxDAIN(init_unused=False)
    variables = _tame(jax.device_get(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jnp.asarray(i0[:, :64]),
        jnp.asarray(i2[:, :64]))), np.random.RandomState(0))
    want = _jax_sharded(
        lambda a, b: model_j.apply(variables, a, b)["outputs"][1], i0, i2)
    port = DAIN().eval()
    load_jax_variables(port, variables)
    with torch.inference_mode():
        got = _torch_sharded(lambda a, b: port(a, b)["outputs"][1], i0, i2)
    assert got.shape == (1, 3, 256, 64)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_video_pad_rule_matches_jax(shards):
    """The driver pads to a multiple of max(128, 64 n) (128 unsharded), at
    least half of it a side when sharded (32 unsharded), as
    apps/interpolate_video.py:138-144; the padded frames equal JAX's
    pad_to_multiple at that rule."""
    multiple = 128 if shards == 1 else max(128, 64 * shards)
    min_pad = 32 if shards == 1 else multiple // 2
    assert video.pad_rule(shards) == (multiple, min_pad)
    frame = (np.arange(720 * 80 * 3) % 251).astype(np.uint8).reshape(
        720, 80, 3)
    got, pads = video.to_input(frame, torch.device("cpu"), shards)
    want, jpads = jax_pad_to_multiple(jnp.asarray(frame[None] / 255.0),
                                      multiple=multiple, min_pad=min_pad)
    assert tuple(pads) == tuple(jpads)
    assert got.shape[2] % multiple == 0 and got.shape[3] % multiple == 0
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-7)


def test_video_driver_runs_sharded(tmp_path):
    """``--spatial-shards 2 --device cpu``: two 64x64 PNG frames padded by
    the sharded rule (to 128x128: 2 shards of 64 + 2 x 64 rows), each
    synthesised frame the sharded forward's of the same weights, rounded to
    the 8-bit grid (as the driver rounds the unsharded one)."""
    from vfidkr_torch.training import CheckpointManager
    from vfidkr_torch.utils import unpad
    from vfidkr_torch.utils.image_io import read_rgb, write_png
    rng = np.random.RandomState(3)
    frames = [(rng.rand(64, 64, 3) * 255).astype(np.uint8) for _ in range(2)]
    (tmp_path / "in").mkdir()
    for k, f in enumerate(frames):
        write_png(tmp_path / "in" / f"{k:05d}.png", f)
    model = DAIN(generator=torch.Generator().manual_seed(1)).eval()
    CheckpointManager(str(tmp_path)).save_best({"model": model.state_dict()})
    summary = video.main([
        "--frames-dir", str(tmp_path / "in"), "--out-dir",
        str(tmp_path / "out"), "--device", "cpu", "--spatial-shards", "2",
        "--torch-checkpoint", str(tmp_path / "best.pth")])
    assert summary["interpolated_frames"] == 1
    (a, pads), (b, _) = (video.to_input(f, torch.device("cpu"), 2)
                         for f in frames)
    assert tuple(a.shape[2:]) == (128, 128)
    with torch.inference_mode():
        want = S.shard_model_rows(lambda x, y: model(x, y)["outputs"][1], 2,
                                  64, ["cpu"] * 2)(a, b)
    want = torch.round(unpad(want, pads).clamp(0, 1) * 255)[0]
    np.testing.assert_array_equal(read_rgb(tmp_path / "out" / "00001001.png"),
                                  want.permute(1, 2, 0).to(torch.uint8).numpy())


# ---------------------------------------------------------------------------
# data-parallel training: two gloo ranks on the CPU against one process
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parents[1]
# parameters after one Adamax step: the first step moves each weight by
# lr * g / (|g| + 1e-8), so where |g| is near Adamax's eps (dead units of
# the random-init filter nets) a gradient summed in another order (the two
# ranks' halves, ~1e-10 apart) moves the update by up to lr * 1e-10 / 1e-8;
# 3.4e-5 measured, held to 1e-4 (5 % of lr = 2e-3)
DP_ATOL = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(out, argv, world=2):
    """The trainer as ``world`` gloo ranks (tests/torch_dp_worker.py);
    returns each rank's standard output and its saves and final model."""
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="2",
               PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_dp_worker.py"),
         str(out), *argv], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return logs, [torch.load(out / f"rank{r}.pt", weights_only=True)
                  for r in range(world)]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """One train step at global batch 2 on 64x64 synthetic triplets, in one
    process and as two ranks, then a resume of the two ranks to epoch 2."""
    from vfidkr_torch.apps import train as train_app
    from vfidkr_torch.data import synthetic
    root = tmp_path_factory.mktemp("dp")
    data = root / "vimeo"
    synthetic.main(["--out", str(data), "--n", "6", "--height", "64",
                    "--width", "64", "--test-frac", "0.34"])
    argv = lambda save, epochs: [
        "--device", "cpu", "--dataset-path", str(data), "--save-path",
        str(save), "--batch-size", "2", "--num-epochs", str(epochs),
        "--seed", "3", "--steps-per-epoch", "1", "--val-batches", "1"]
    train_app.main(argv(root / "single", 1))
    (root / "first").mkdir()
    logs, ranks = _ranks(root / "first", argv(root / "dp", 1))
    first = {f.name: f.read_bytes() for f in (root / "dp").iterdir()
             if f.is_file()}
    (root / "resumed").mkdir()
    resumed_logs, resumed = _ranks(root / "resumed",
                                   [*argv(root / "dp", 2), "--resume"])
    return root, logs, ranks, first, resumed_logs, resumed


def test_data_parallel_step_equals_one_process_step(dp_runs):
    """Parameters after the Adamax step: the two ranks' (each on its half
    of the batch, the gradients averaged) against one process's on the
    whole batch; and the two ranks hold the same weights."""
    root, _, ranks, _, _, _ = dp_runs
    from vfidkr_torch.training import CheckpointManager
    single = CheckpointManager(str(root / "single")).load("epoch0")["model"]
    dp = ranks[0]["model"]
    assert single.keys() == dp.keys()
    for k, want in single.items():
        torch.testing.assert_close(dp[k], want, rtol=0, atol=DP_ATOL, msg=k)
        assert torch.equal(dp[k], ranks[1]["model"][k]), k


def test_data_parallel_rank0_alone_writes(dp_runs):
    root, logs, ranks, first, _, _ = dp_runs
    assert ranks[0]["saved"] and set(ranks[0]["saved"]) == {"best", "epoch0"}
    assert ranks[1]["saved"] == []
    assert {"args.txt", "best.pth", "epoch0.pth", "log.txt"} <= set(first)
    log = np.loadtxt(io.StringIO(first["log.txt"].decode()), delimiter=",",
                     ndmin=2)
    single = np.loadtxt(root / "single" / "log.txt", delimiter=",",
                        ndmin=2)
    assert log.shape == single.shape == (1, 5)
    # the losses are the global batch's: averaged across the ranks
    np.testing.assert_allclose(log, single, rtol=1e-5, atol=1e-6)
    # the losses printed by rank 0 are the one process's
    line = next(ln for ln in logs[0].splitlines() if ln.startswith("Ep ["))
    assert f"Total {single[0, 2]:.5f}" in line
    assert "Finish Training" in logs[0] and "Finish Training" not in logs[1]


def test_data_parallel_resume_restores_every_rank(dp_runs):
    root, _, _, _, logs, ranks = dp_runs
    for r, log in enumerate(logs):
        assert f"rank {r}: resumed from epoch0" in log, log
    assert ranks[0]["saved"] == ["epoch1"] or set(ranks[0]["saved"]) == {
        "best", "epoch1"}
    assert ranks[1]["saved"] == []
    for k, v in ranks[0]["model"].items():
        assert torch.equal(v, ranks[1]["model"][k]), k
    assert np.loadtxt(root / "dp" / "log.txt", delimiter=",",
                      ndmin=2).shape == (2, 5)


@pytest.mark.parametrize("world", [2, 4])
def test_rank_shards_are_the_global_batch(tmp_path, world):
    """The ranks' batches (each decoding its own share) stacked are the
    one-process batch, augmentations included: each share's samples go
    through the C++ augment, and the others' draws are still made."""
    from vfidkr_torch.data import synthetic
    from vfidkr_torch.data.vimeo90k import Vimeo90KDataset, vimeo90k_splits
    from vfidkr_torch.parallel.mesh import Mesh, shard_range
    synthetic.main(["--out", str(tmp_path), "--n", "8", "--height", "40",
                    "--width", "48", "--test-frac", "0.25"])
    train, _ = vimeo90k_splits(str(tmp_path))
    crop = (32, 40)         # random crops: the draws depend on the size
    whole = Vimeo90KDataset(str(tmp_path), train, 4, seed=5, crop_hw=crop)
    parts = [Vimeo90KDataset(str(tmp_path), train, 4, seed=5, crop_hw=crop,
                             shard=shard_range(4, Mesh(r, world)))
             for r in range(world)]
    for want, *got in zip(whole.batches(3), *(p.batches(3) for p in parts)):
        for k in ("x0", "x1", "y"):
            np.testing.assert_array_equal(
                np.concatenate([g[k] for g in got]), want[k])
    with pytest.raises(ValueError, match="does not divide"):
        shard_range(3, Mesh(0, 2))
