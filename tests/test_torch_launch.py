"""``vfidkr_torch.kernels.launch``, the one caller of the kernel library, on
the CPU.

The library, the current device and the stream are stood in for, so that
what the launcher passes on, counts and records shows without a card; the
kernels themselves run in ``tests/test_torch_cuda.py``.
"""
import ctypes
import types

import pytest
import torch

from vfidkr_torch import kernels

STREAM = 77


def _args(name, tensor, value=7):
    """Arguments in ``name``'s C order: ``tensor`` at each pointer, ``value``
    at each size."""
    return tuple(tensor if t is ctypes.c_void_p else value
                 for t in kernels.build.SIGNATURES[f"vfidkr_{name}"][:-1])


@pytest.fixture
def lib(monkeypatch):
    """A stand-in library whose every entry point records its call and
    returns ``lib.err``; the launch counts start at 0 and are restored."""
    lib = types.SimpleNamespace(calls=[], lookups=[], err=0)

    class Library:
        def __getattr__(self, name):
            lib.lookups.append(name)

            def entry(*args):
                lib.calls.append((name, args))
                return lib.err
            return entry

    monkeypatch.setattr(kernels.build, "load_library", Library)
    monkeypatch.setattr(kernels, "_ENTRY", {})
    monkeypatch.setattr(kernels, "LAUNCHES",
                        dict.fromkeys(kernels.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=STREAM))
    # a CPU tensor's device index: the tensors are on the current device
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    return lib


def test_launch_passes_pointers_ints_and_the_stream(lib):
    """Tensors become their data pointers, ints (a pointer into a tensor
    among them) and ``None`` pass unchanged, and the stream comes last."""
    x, w, out = torch.zeros(4), torch.zeros(2, 3), torch.zeros(5)
    sizes = (1, 13, 32, 8, 16, 8, 2)
    kernels.launch("dense_conv", x.data_ptr() + 8, 5, w, None,
                   out.data_ptr(), 6, *sizes)
    assert lib.calls == [("vfidkr_dense_conv",
                          (x.data_ptr() + 8, 5, w.data_ptr(), None,
                           out.data_ptr(), 6, *sizes, STREAM))]
    kernels.launch("filter_interpolate_bwd", x, x, w, w, None, out, out,
                   1, 3, 8, 8)
    p = (x.data_ptr(), w.data_ptr(), out.data_ptr())
    assert lib.calls[1] == ("vfidkr_filter_interpolate_bwd",
                            (p[0], p[0], p[1], p[1], None, p[2], p[2],
                             1, 3, 8, 8, STREAM))


@pytest.mark.parametrize("name", kernels.KERNELS + kernels.UNRECORDED)
def test_launch_counts_every_kernel_and_records_kernels_only(lib, name):
    """Every kernel's launch counts in ``LAUNCHES``; ``record_launches``
    keeps the launches of ``KERNELS`` alone, with their arguments."""
    x = torch.zeros(3)
    first, second = _args(name, x, 1), _args(name, x, 2)
    with kernels.record_launches() as records:
        kernels.launch(name, *first)
        kernels.launch(name, *second)
    assert kernels.LAUNCHES == {k: 2 * (k == name) for k in kernels.LAUNCHES}
    want = ([(name, first), (name, second)] if name in kernels.KERNELS
            else [])
    assert records == want
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())


def test_launch_looks_each_entry_point_up_once(lib):
    x = torch.zeros(3)
    for name in ("rectify_head", "rectify_head", "sepconv_pair",
                 "rectify_head"):
        kernels.launch(name, *_args(name, x))
    assert lib.lookups == ["vfidkr_rectify_head", "vfidkr_sepconv_pair"]
    assert len(lib.calls) == 4


def test_launch_raises_on_a_failed_launch_and_counts_nothing(lib):
    lib.err = 700
    with kernels.record_launches() as records:
        for name in ("rectify_head", "fused_resblocks"):
            with pytest.raises(RuntimeError, match=f"{name}: .* error 700"):
                kernels.launch(name, *_args(name, torch.zeros(3)))
    assert records == [] and not any(kernels.LAUNCHES.values())
