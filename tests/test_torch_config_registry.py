"""The port's model registry, factories, config bundle and profiling helpers
against the JAX package's: ``models.build_model`` / ``MODEL_REGISTRY`` and
``ModelConfig.build`` (the same model for the same generator),
``multiple_basic_block_4`` and ``s2df_3dense`` on JAX's parameters (through
the weight converter; the tolerances of tests/test_torch_models.py and
tests/test_torch_slowmotion_parts.py), ``DataConfig`` / ``EvalConfig`` /
``Config`` field by field and as the source of the defaults the loader, the
trainer and the eval apps use, and ``trace``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import vfidkr_tpu.config as JC  # noqa: E402
import vfidkr_tpu.models as JM  # noqa: E402

import vfidkr_torch.config as C  # noqa: E402
import vfidkr_torch.models as M  # noqa: E402
from vfidkr_torch.convert import load_jax_variables  # noqa: E402
from vfidkr_torch.utils import trace  # noqa: E402

H = W = 32


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _holder(name, child):
    """A container that puts ``child`` under its DAIN state_dict name, so
    the converter's key map applies unchanged."""
    m = torch.nn.Module()
    m.add_module(name, child)
    return m.eval()


def test_registry_has_jax_names():
    # the JAX package's two networks, and SepConv, SoftSplat and AdaCoFPlus,
    # which only the port runs
    assert set(M.MODEL_REGISTRY) == set(JM.MODEL_REGISTRY) | {
        "SepConv", "SoftSplat", "AdaCoFPlus"}
    assert M.MODEL_REGISTRY["DAIN"] is M.DAIN
    assert M.MODEL_REGISTRY["DAIN_slowmotion"] is M.DAINSlowMotion
    assert M.MODEL_REGISTRY["SepConv"] is M.SepConv
    assert M.MODEL_REGISTRY["SoftSplat"] is M.SoftSplat
    assert M.MODEL_REGISTRY["AdaCoFPlus"] is M.AdaCoFPlus
    assert C.NET_NAMES == tuple(M.MODEL_REGISTRY)
    with pytest.raises(ValueError, match="net_name must be one of"):
        M.build_model("SuperSloMo")


@pytest.mark.parametrize("name,kwargs,cfg", [
    ("DAIN", {}, C.ModelConfig("DAIN")),
    ("DAIN_slowmotion", {"timestep": 0.25},
     C.ModelConfig("DAIN_slowmotion", 0.25)),
    ("DAIN", {"compute_dtype": "bfloat16"},
     C.ModelConfig("DAIN", compute_dtype="bfloat16")),
])
def test_build_model_equals_model_config_build(name, kwargs, cfg):
    """The same generator gives the same weights by either route."""
    a = M.build_model(name, generator=torch.Generator().manual_seed(4),
                      **kwargs)
    b = cfg.build(torch.Generator().manual_seed(4))
    assert type(a) is type(b) is M.MODEL_REGISTRY[name]
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a.compute_dtype == b.compute_dtype
    if name == "DAIN_slowmotion":
        assert a.num_frames == b.num_frames == 3


def test_multiple_basic_block_4_matches_jax():
    x = np.random.RandomState(0).rand(1, H, W, 45).astype(np.float32)
    model_j = JM.multiple_basic_block_4()
    params = jax.device_get(model_j.init(jax.random.PRNGKey(1),
                                         jnp.asarray(x)))
    want = np.asarray(model_j.apply(params, jnp.asarray(x)))
    port = M.multiple_basic_block_4()
    assert isinstance(port, M.MultipleBasicBlock)
    loaded = load_jax_variables(_holder("rectifyNet", port),
                                {"params": {"rectify_net": params["params"]}})
    assert len(loaded) == len(port.state_dict()) == 2 + 6 + 2
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_s2df_3dense_matches_jax():
    x = np.random.RandomState(1).rand(1, H, W, 3).astype(np.float32)
    model_j = JM.s2df_3dense()
    params = jax.device_get(model_j.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    want = np.asarray(model_j.apply(params, jnp.asarray(x)))
    port = M.s2df_3dense()
    assert isinstance(port, M.S2DF)
    loaded = load_jax_variables(_holder("ctxNet", port),
                                {"params": {"ctx_net": params["params"]}})
    assert len(loaded) == len(port.state_dict()) == 5
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    assert got.shape == want.shape == (1, H, W, 195)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["DataConfig", "EvalConfig"])
def test_data_and_eval_config_defaults_equal_jax(name):
    ours, theirs = getattr(C, name)(), getattr(JC, name)()
    ours_d, theirs_d = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    if name == "EvalConfig":
        # the port's -1 (the last output) picks JAX's 1 of DAIN's two
        # outputs (blend, rectified), and is SepConv's only one
        assert ours_d.pop("save_which") == -1
        assert ["blend", "rectified"][-1] == \
            ["blend", "rectified"][theirs_d.pop("save_which")]
    assert ours_d == theirs_d
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]


def test_config_bundles_the_port_configs():
    cfg = C.Config()
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(JC.Config())]
    assert cfg.model == C.ModelConfig() and cfg.data == C.DataConfig()
    assert cfg.eval == C.EvalConfig()
    from vfidkr_torch.training import TrainConfig
    assert cfg.train == TrainConfig()
    # the port's TrainConfig carries JAX's defaults for the fields it has
    jax_train = dataclasses.asdict(JC.TrainConfig())
    assert all(jax_train[k] == v
               for k, v in dataclasses.asdict(cfg.train).items())
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.data.batch_size = 4


def test_trainer_builds_its_config_from_its_flags():
    from vfidkr_torch.apps import train
    from vfidkr_torch.training import TrainConfig
    args = train.parse_args(["--dataset-path", "d", "--save-path", "s"])
    assert train.make_config(args) == C.Config(data=C.DataConfig(
        dataset_path="d"))
    args = train.parse_args([
        "--dataset-path", "d", "--save-path", "s", "--net-name",
        "DAIN_slowmotion", "--batch-size", "6", "--seed", "3", "--lr",
        "1e-3", "--alpha", "0.5", "0.5", "--patience", "2"])
    assert train.make_config(args) == C.Config(
        model=C.ModelConfig("DAIN_slowmotion"),
        data=C.DataConfig(dataset_path="d", batch_size=6, seed=3),
        train=TrainConfig(lr=1e-3, alpha=(0.5, 0.5), patience=2))


def test_defaults_in_use_are_the_configs():
    """The loader's crop and augmentation, the dataset lookup, the frames'
    padding and the eval apps' --save-which read DataConfig and
    EvalConfig."""
    import inspect
    from vfidkr_torch.apps import demo_middlebury, eval_vimeo
    from vfidkr_torch.apps import interpolate_video
    from vfidkr_torch.data import vimeo90k
    from vfidkr_torch.utils.padding import pad_to_multiple
    data, ev = C.DataConfig(), C.EvalConfig()
    assert vimeo90k.CROP_HW == data.crop_hw
    assert data.dataset_name in vimeo90k.DATASETS
    batches = inspect.signature(vimeo90k.train_batches).parameters
    assert batches["crop_hw"].default == data.crop_hw
    assert batches["augment"].default is data.augment_train
    pads = inspect.signature(pad_to_multiple).parameters
    assert (pads["multiple"].default, pads["min_pad"].default) == \
        (ev.pad_multiple, ev.min_pad) == interpolate_video.pad_rule(1)
    x, p = pad_to_multiple(torch.zeros(1, 3, 256, 200))
    assert tuple(x.shape[2:]) == (320, 256) and p == (28, 28, 32, 32)
    need = ["--dataset-path", "d"]
    for args in (demo_middlebury.parse_args(["--root", "r"]),
                 eval_vimeo.parse_args(need),
                 interpolate_video.build_parser().parse_args(
                     ["--frames-dir", "f", "--out-dir", "o"])):
        assert args.save_which == ev.save_which


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.nn.functional.conv2d(torch.ones(1, 2, 8, 8),
                                   torch.ones(3, 2, 3, 3)).sum()
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert prof.key_averages() is not None
