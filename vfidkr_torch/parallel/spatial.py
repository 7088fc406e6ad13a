"""Row sharding of a frame over devices, with halo exchange: counterpart of
``vfidkr_tpu/parallel/spatial.py``.

A frame too large for one card runs with its rows split over n shards.  Each
shard holds ``H/n + 2*halo`` rows (NCHW: rows on dim 2): its own rows and
``halo`` rows of each neighbour, exchanged at the start.  The network runs on
each block, and the halo rows are cropped from each shard's output.

JAX runs the shards as one program over a mesh axis (``shard_map``).  Here
one process runs one thread a shard: each thread sets its device and works on
a CUDA stream of its own, and the threads meet at a ``ShardAxis``, the
rendezvous whose ``all_gather`` the hole fill calls in the middle of the
forward.  Threads rather than processes: the fill needs a cross-shard exchange
inside the forward, NCCL cannot hold two ranks on one card, and n threads let
the shards share one card (or run on the CPU, where the tests run 8 of them).
The caller's grad and inference modes, which PyTorch keeps per thread, are
carried into the shards' threads.

Exactness, as in JAX: inside ``spatial_frame`` the ops evaluate their
validity bounds in global frame coordinates (``global_row_frame``), mask the
phantom (edge-replicated) scatter sources of the first and last shard, and
run the hole fill's vertical search on interior rows with carries gathered
across shards (``vfidkr_torch/ops/flow_projection.py``).  An op chain whose
reach (|flow| plus the window) fits in ``halo`` rows is then exact on every
row; a full DAIN forward, whose pyramids and flows reach further, is the
standard tiled approximation.  The kernels take no gradient inside a frame:
no JAX driver trains row-sharded.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

_LOCAL = threading.local()


def _frames() -> list:
    if not hasattr(_LOCAL, "frames"):
        _LOCAL.frames = []
    return _LOCAL.frames


class _Rendezvous:
    """Where the n threads of one sharded call meet: a barrier and a slot a
    shard.  ``abort`` breaks the barrier, so that a shard that fails does
    not leave the others waiting."""

    def __init__(self, n: int):
        self.size = n
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n)

    def abort(self) -> None:
        self.barrier.abort()


class ShardAxis:
    """One shard's end of a row axis: its ``index`` among ``size`` shards,
    and the collectives that the ops call inside a ``spatial_frame``."""

    def __init__(self, rendezvous: _Rendezvous, index: int):
        self._rv = rendezvous
        self.index = index
        self.size = rendezvous.size

    def _exchange(self, value, take):
        """Post ``value``; once every shard has posted, return ``take`` of
        all posted values, computed before any shard may post again."""
        rv = self._rv
        rv.slots[self.index] = value
        rv.barrier.wait()
        result = take(list(rv.slots))
        rv.barrier.wait()
        return result

    def exchange_tensors(self, t: torch.Tensor, take):
        """``_exchange`` for tensors on a device of this shard's: each
        shard's stream has finished ``t`` before another reads it, and this
        shard's copies are done before its peers go on (and may free or
        reuse theirs)."""
        _sync(t.device)

        def copied(posted):
            out = take(posted)
            _sync(t.device)
            return out

        return self._exchange(t, copied)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every shard's ``t``, in shard order, on this
        shard's device."""
        return self.exchange_tensors(
            t, lambda posted: torch.stack([p.to(t.device) for p in posted]))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@contextlib.contextmanager
def spatial_frame(axis: ShardAxis, halo: int):
    """The ops inside run on the halo-extended block of shard
    ``axis.index`` (this thread's stack of frames)."""
    _frames().append((axis, halo))
    try:
        yield
    finally:
        _frames().pop()


def current_spatial_frame() -> Optional[Tuple[ShardAxis, int]]:
    frames = _frames()
    return frames[-1] if frames else None


def global_row_frame(h_ext: int) -> Optional[Tuple[int, int, ShardAxis, int]]:
    """Inside a spatial_frame: (row0, h_global, axis, halo), where ``row0``
    is the global row of local (halo-extended) row 0 -- negative on the first
    shard, whose top halo rows are phantom rows above the frame.  None
    outside a spatial_frame."""
    ctx = current_spatial_frame()
    if ctx is None:
        return None
    axis, halo = ctx
    hs = h_ext - 2 * halo
    return axis.index * hs - halo, axis.size * hs, axis, halo


def row_frame(h: int) -> Tuple[int, int]:
    """(row0, hg) of the current spatial frame's block of ``h`` rows: the
    global row of local row 0 and the frame's height; (0, h) outside a
    frame.  The kernels of the sharded ops take these two arguments."""
    frame = global_row_frame(h)
    return (0, h) if frame is None else frame[:2]


def no_grad_in_frame(name: str, *tensors) -> None:
    """Raise where ``tensors`` need a gradient inside a spatial frame: the
    sharded ops have no backward (no driver trains row-sharded)."""
    if current_spatial_frame() is not None and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} takes no gradient inside a row-sharded "
                           f"spatial frame")


def halo_exchange_rows(x: torch.Tensor, halo: int, axis: ShardAxis,
                       edge_mode: str = "edge") -> torch.Tensor:
    """Append ``halo`` rows from the shards above and below.

    x: (N, C, H_shard, W) local block -> (N, C, H_shard + 2*halo, W).  At the
    frame's top and bottom, ``edge_mode`` picks replication ("edge", the
    eval path's border handling) or zeros ("zero", as zero-padded convs)."""
    if edge_mode not in ("edge", "zero"):
        raise ValueError(f"edge_mode must be 'edge' or 'zero', got "
                         f"{edge_mode!r}")
    if halo > x.shape[2]:
        raise ValueError(f"halo {halo} exceeds the shard's {x.shape[2]} rows")
    idx, n = axis.index, axis.size
    edges = torch.stack([x[:, :, :halo], x[:, :, -halo:]])

    def neighbours(posted):
        # copies, made before the peers may free theirs
        above = (posted[idx - 1][1].to(x.device, copy=True) if idx > 0
                 else None)
        below = (posted[idx + 1][0].to(x.device, copy=True) if idx < n - 1
                 else None)
        return above, below

    above, below = axis.exchange_tensors(edges, neighbours)
    if edge_mode == "edge":
        edge_top = x[:, :, :1].expand(-1, -1, halo, -1)
        edge_bot = x[:, :, -1:].expand(-1, -1, halo, -1)
    else:
        edge_top = edge_bot = torch.zeros_like(x[:, :, :halo])
    top = edge_top if above is None else above
    bot = edge_bot if below is None else below
    return torch.cat([top, x, bot], dim=2)


def _map(fn, tree):
    """``fn`` on each tensor of a tree of lists, tuples and dicts."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip_map(fn, trees):
    """``fn`` on the list of each tensor's counterparts in ``trees``."""
    first = trees[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    return fn(trees)


def _on_device(device: torch.device, stack: contextlib.ExitStack) -> None:
    if device.type == "cuda":
        stack.enter_context(torch.cuda.device(device))
        stack.enter_context(torch.cuda.stream(torch.cuda.Stream(device)))


def spatial_shard_fn(fn: Callable, devices: Sequence, halo: int,
                     edge_mode: str = "edge") -> Callable:
    """Wrap ``fn(*tensors) -> tensor or tree of tensors`` (all NCHW, of one
    H) so that it runs row-sharded over ``devices``, one shard a device
    entry (an entry may repeat: n shards on one card), with halo exchange.

    The wrapper takes and returns whole-frame tensors, its result on the
    first input's device; H must divide by the number of shards, and ``fn``
    must keep H (stride 1 overall).  For DAIN (PWC-Net /64, the U-Nets /32)
    pick ``halo`` so that H/n + 2*halo keeps that divisibility, and halo >=
    the largest expected motion plus the ops' reach."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def wrapper(*arrays):
        h = arrays[0].shape[2]
        if h % n:
            raise ValueError(f"H = {h} does not divide into {n} shards")
        hs = h // n
        out_device = arrays[0].device
        for d in {a.device for a in arrays}:
            _sync(d)
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        rendezvous = _Rendezvous(n)
        results: list = [None] * n
        errors: list = [None] * n

        def run(i):
            try:
                with contextlib.ExitStack() as stack:
                    _on_device(devices[i], stack)
                    stack.enter_context(torch.inference_mode(inference))
                    stack.enter_context(torch.set_grad_enabled(grad))
                    axis = ShardAxis(rendezvous, i)
                    blocks = [a[:, :, i * hs:(i + 1) * hs].to(devices[i])
                              for a in arrays]
                    padded = [halo_exchange_rows(b, halo, axis, edge_mode)
                              for b in blocks]
                    with spatial_frame(axis, halo):
                        out = fn(*padded)
                    results[i] = _map(
                        lambda o: o[:, :, halo:o.shape[2] - halo], out)
                    _sync(devices[i])
            except BaseException as e:  # noqa: BLE001 - raised by the caller
                errors[i] = e
                rendezvous.abort()

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            # a shard's own error before the others' broken barriers
            raise next((e for e in failed
                        if not isinstance(e, threading.BrokenBarrierError)),
                       failed[0])
        out = _zip_map(lambda parts: torch.cat(
            [p.to(out_device) for p in parts], dim=2), results)
        # done before the shards' tensors return to their streams' pools
        _sync(out_device)
        return out

    return wrapper


def cuda_devices(n_shards: int) -> list:
    """The first ``n_shards`` CUDA devices; raises, as JAX's driver does,
    when there are fewer."""
    count = torch.cuda.device_count()
    if count < n_shards:
        raise ValueError(f"--spatial-shards {n_shards} > {count} devices")
    return [torch.device("cuda", i) for i in range(n_shards)]


def shard_model_rows(apply_fn: Callable, n_shards: int, halo: int = 64,
                     devices: Optional[Sequence] = None) -> Callable:
    """For the drivers: row-shard a model forward ``apply_fn(i0, i2) ->
    tree`` of NCHW tensors over ``devices``, by default the first
    ``n_shards`` CUDA devices (``cuda_devices``).  Frames n_shards x taller
    run at about the per-card footprint of one."""
    devices = cuda_devices(n_shards) if devices is None else list(devices)
    if len(devices) != n_shards:
        raise ValueError(f"{n_shards} shards need {n_shards} devices, got "
                         f"{len(devices)}")
    return spatial_shard_fn(apply_fn, devices, halo)
