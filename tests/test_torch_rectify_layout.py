"""The host side of K4 (``fused_resblocks``), on the CPU: the weight packing
the kernel's ring reads, and the plain version's memory formats.

The kernel reads one conv's weights as (9, 128, 128) [dy*3+dx][co][ci] and
the activations channels-last; these tests hold the packing to an index
formula written out here, and the plain version to the same bits for NCHW
and channels-last inputs (it computes in NCHW).  Small shapes: they run in
well under a second.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.ops import rectify  # noqa: E402


def _w6(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(6, 128, 128, 3, 3, generator=g) * 0.05).bfloat16()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pack_trunk_weights_index_formula(dtype):
    """packed.flat[((k * 9 + dy * 3 + dx) * 128 + co) * 128 + ci] is
    w6[k, co, ci, dy, dx], for every element; the dtype is kept."""
    w6 = _w6(0).to(dtype)
    packed = rectify.pack_trunk_weights(w6)
    assert packed.shape == (6, 9, 128, 128) and packed.is_contiguous()
    assert packed.dtype == dtype
    k, co, ci, dy, dx = np.meshgrid(*(np.arange(s) for s in w6.shape),
                                    indexing="ij")
    flat = ((k * 9 + dy * 3 + dx) * 128 + co) * 128 + ci
    src = w6.float().numpy()
    got = packed.float().numpy().reshape(-1)[flat]
    np.testing.assert_array_equal(got, src)
    # every element placed once: the index formula is a bijection
    assert np.unique(flat).size == flat.size == packed.numel()


@pytest.mark.parametrize("shape", [(1, 128, 5, 9), (2, 128, 6, 7)])
def test_fused_resblocks_plain_memory_formats(shape):
    """The plain version gives the same bits for an NCHW and a channels-last
    input, and returns NCHW; the CPU wrapper runs it and launches nothing."""
    g = torch.Generator().manual_seed(1)
    x = torch.relu(torch.randn(*shape, generator=g)).bfloat16()
    w6 = _w6(2)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    assert not x_cl.is_contiguous()
    want = rectify.fused_resblocks_plain(x, w6)
    got = rectify.fused_resblocks_plain(x_cl, w6)
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(rectify.fused_resblocks(x_cl, w6), want)
    assert kernels.LAUNCHES == before


def test_check_inputs_memory_format():
    """check_inputs takes the memory format to check, and still refuses a
    CPU tensor first."""
    x = torch.zeros(1, 128, 4, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.check_inputs("fused_resblocks", x, dtype=torch.bfloat16,
                             memory_format=torch.channels_last)
