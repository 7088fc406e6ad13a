"""The port's DAIN eval forward against the JAX package's, and the port's
boundaries: no JAX import, no kernel launch on the CPU, no build without
nvcc.

The full-graph comparison runs at 64x64, B=1 (the smallest frame PWC-Net
takes), with the JAX weights tamed as tests/test_full_graph_parity.py tames
the reference's (all x0.5, biases jittered) and carried over by
``load_jax_variables``; tolerances are that test's (rtol 1e-3, atol 1e-4 for
the offsets, 2e-4 for the frames).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfidkr_tpu.models import DAIN as JaxDAIN  # noqa: E402

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.convert import load_jax_variables  # noqa: E402
from vfidkr_torch.kernels import build  # noqa: E402
from vfidkr_torch.models import DAIN  # noqa: E402

H = W = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nchw(a):
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _tame(tree, rng, name=""):
    """All weights x0.5; biases jittered so the flows are non-trivial."""
    if isinstance(tree, dict):
        return {k: _tame(v, rng, k) for k, v in tree.items()}
    v = np.asarray(tree, np.float32) * 0.5
    if name == "bias":
        v = v + ((rng.rand(*v.shape) - 0.5) * 0.02).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def dain_pair():
    rng = np.random.RandomState(0)
    i0 = rng.rand(1, H, W, 3).astype(np.float32)
    i2 = rng.rand(1, H, W, 3).astype(np.float32)
    model_j = JaxDAIN(init_unused=False)
    variables = _tame(jax.device_get(model_j.init(
        jax.random.PRNGKey(0), jnp.asarray(i0), jnp.asarray(i2))), rng)
    want = jax.device_get(model_j.apply(variables, jnp.asarray(i0),
                                        jnp.asarray(i2)))

    port = DAIN().eval()
    loaded = load_jax_variables(port, variables)
    kernels.reset_launches()
    with torch.inference_mode():
        got = port(nchw(i0), nchw(i2))
    launches = dict(kernels.LAUNCHES)
    return want, got, loaded, launches


def test_dain_loads_every_weight(dain_pair):
    _, _, loaded, _ = dain_pair
    assert len(loaded) == len(DAIN(init_unused=False).state_dict()) == 168


@pytest.mark.parametrize("k", [0, 1])
def test_dain_offsets_match_jax(dain_pair, k):
    want, got, _, _ = dain_pair
    off = nhwc(got["offsets"][k])
    assert np.abs(off).max() > 0.1            # the flows are not trivial
    np.testing.assert_allclose(off, want["offsets"][k], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("k", [0, 1])
def test_dain_filters_match_jax(dain_pair, k):
    want, got, _, _ = dain_pair
    np.testing.assert_allclose(nhwc(got["filters"][k]), want["filters"][k],
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("k,name", [(0, "cur_output"), (1, "rectified")])
def test_dain_outputs_match_jax(dain_pair, k, name):
    want, got, _, _ = dain_pair
    out = nhwc(got["outputs"][k])
    assert out.shape == (1, H, W, 3) and np.all(np.isfinite(out)), name
    np.testing.assert_allclose(out, want["outputs"][k], rtol=1e-3, atol=2e-4,
                               err_msg=name)


def test_cpu_forward_launches_no_kernel(dain_pair):
    """On CPU tensors every op takes its plain version."""
    _, _, _, launches = dain_pair
    assert set(launches) == set(kernels.KERNELS + kernels.UNRECORDED)
    assert all(n == 0 for n in launches.values()), launches


def test_port_imports_no_jax():
    """Neither JAX nor any module of the JAX package: not when the port's
    modules are imported, and not in any import statement of its sources or
    of chip_smoke.py (an import inside a function runs only when called)."""
    code = ("import sys, vfidkr_torch, vfidkr_torch.models, "
            "vfidkr_torch.models.megadepth, vfidkr_torch.models.s2df, "
            "vfidkr_torch.convert, vfidkr_torch.ops, vfidkr_torch.kernels, "
            "vfidkr_torch.training, vfidkr_torch.data.vimeo90k, "
            "vfidkr_torch.apps.train, vfidkr_torch.apps.demo_middlebury, "
            "vfidkr_torch.apps.eval_vimeo, vfidkr_torch.config, "
            "vfidkr_torch.utils, vfidkr_torch.ops.rectify, "
            "vfidkr_torch.utils.image_io, vfidkr_torch.utils.depth_eval, "
            "vfidkr_torch.data.synthetic, vfidkr_torch.apps.depth_eval, "
            "vfidkr_torch.apps.interpolate_video, vfidkr_torch.parallel, "
            "vfidkr_torch.parallel.spatial, vfidkr_torch.parallel.mesh, "
            "vfidkr_torch.data.native, vfidkr_torch.utils.profiling; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'jaxlib', 'vfidkr_tpu')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

    pattern = re.compile(
        r"^\s*(import|from)\s+(vfidkr_tpu|jax|flax|jaxlib)\b", re.M)
    sources = sorted(Path(REPO, "vfidkr_torch").rglob("*.py"))
    sources.append(Path(REPO, "chip_smoke.py"))
    assert len(sources) > 20
    bad = [f"{src.relative_to(REPO)}: {m.group(0).strip()}"
           for src in sources for m in pattern.finditer(src.read_text())]
    assert not bad, bad


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library()
    assert not (tmp_path / "build").exists()


def test_cuda_wrappers_reject_bad_tensors():
    """The kernel path checks its inputs before any build or launch."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.check_inputs("filter_interpolate_fwd", torch.zeros(1, 2, 4, 4))
    meta = torch.zeros(1, 2, 4, 4, device="meta")
    from vfidkr_torch.ops.flow_projection import scatter4
    with pytest.raises(ValueError, match="CUDA tensor"):
        scatter4(meta)
