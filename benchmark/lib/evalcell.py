"""An evaluation cell: one caller interpolating a clip pair by pair, in a
closed loop, through the video driver's per-pair path.

Each pair goes through ``vfidkr_torch.apps.interpolate_video``: the new
frame to ``to_input`` (to the card, /255, replication-padded; pair k's
second frame is pair k+1's first, padded once, as the driver's ``main``
does), ``frames_between(model, a, b, pads, save_which)`` (the forward under
``inference_mode``, unpadded, clamped, rounded to uint8 on the card) and
the copy to the host.  A pair's latency runs from handing its new frame to
``to_input`` to its frames being on the host; the window's rate is every
synthesised frame over the whole window.

For the check, a sample of the window's pairs is drawn from the seed
(reservoir sampling over all pairs the window finished); for each, the
model's float32 output (a forward hook on the model) and the uint8 frames
the path delivered are kept, and compared after the window with the
reference run on the same two frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import check, trace as tr
from benchmark.lib.cell import build_model, lane_of
from benchmark.lib.traffic import clip_index, make_clip
from benchmark.lib.weights import make_state
from benchmark.lib.work import launch_work

_SAMPLE_STREAM = 4
PAD_MULTIPLE, MIN_PAD = 128, 32       # the driver's padding of one card


def reference_pad(x: torch.Tensor):
    """The benchmark's copy of the driver's padding: a dim not divisible
    by 128 is replication-padded up to the next multiple (the smaller half
    left or top), a divisible one by 32 each side."""
    def pads(dim):
        if dim % PAD_MULTIPLE:
            total = PAD_MULTIPLE - dim % PAD_MULTIPLE
            return total // 2, total - total // 2
        return MIN_PAD, MIN_PAD
    top, bottom = pads(x.shape[2])
    left, right = pads(x.shape[3])
    return (torch.nn.functional.pad(x, (left, right, top, bottom),
                                    mode="replicate"),
            (left, right, top, bottom))


def reference_outputs(cell, P, lane, a: np.ndarray, b: np.ndarray, device):
    """The cell's reference's float32 outputs (one per synthesised frame,
    padded) and uint8 frames (K, H, W, 3) for the frame pair (a, b)."""
    to = lambda f: torch.from_numpy(f).to(device).permute(2, 0, 1)[None] \
        .float() / 255.0
    (xa, pads), (xb, _) = reference_pad(to(a)), reference_pad(to(b))
    with torch.no_grad():
        outs = cell["reference"].forward(P, xa, xb, lane, cell["config"])[
            cell["workload"]["save_which"]]
    left, right, top, bottom = pads
    frames = torch.cat([o[:, :, top:o.shape[2] - bottom,
                          left:o.shape[3] - right] for o in outs])
    u8 = torch.round(frames.clamp(0, 1) * 255).to(torch.uint8).permute(
        0, 2, 3, 1).cpu().numpy()
    return [o.float().cpu() for o in outs], u8


class EvalRun:
    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.wl = cell["workload"]
        self.readers: dict = {}       # metric name -> reader module

    # -- set-up --------------------------------------------------------
    def setup(self, mark=lambda phase: None) -> None:
        """``mark(phase)`` is called at the end of each phase of set-up."""
        from vfidkr_torch import kernels
        self.kernels = kernels
        mark("program imports")
        if self.device.type == "cuda":
            kernels.build.load_library()
            mark("kernels")
        self.clip = make_clip(self.cell["mix"], self.seed, self.device)
        mark("traffic")
        self.model, self.shapes = build_model(self.cell, self.device,
                                              self.seed)
        self.model.eval()
        self._capture = None
        self.model.register_forward_hook(self._keep)
        self.k = 0                       # pairs of the clip played so far
        self.b_in = None
        self._sync()
        mark("model")
        for i in range(self.wl["warmup_pairs"]):
            self.pair()
            mark(f"warm-up {i + 1}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _keep(self, module, args, out):
        if self._capture is not None:
            outs = out["outputs"][self.wl["save_which"]]
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            self._capture.extend(o.detach().float().clone() for o in outs)

    def frames_of(self, k: int):
        n = len(self.clip)
        return self.clip[clip_index(k, n)], self.clip[clip_index(k + 1, n)]

    def pair(self, capture: bool = False):
        """One pair through the driver's path; returns (latency s, frames
        (K, H, W, 3) uint8 on the host, captured float32 outputs)."""
        from vfidkr_torch.apps.interpolate_video import to_input
        a, b = self.frames_of(self.k)
        self._capture = [] if capture else None
        t = time.perf_counter()
        a_in, pads = (to_input(a, self.device) if self.b_in is None
                      else self.b_in)
        self.b_in = to_input(b, self.device)
        outs = frames_between(self.model, a_in, self.b_in[0], pads,
                              self.wl["save_which"])
        outs = outs.cpu().numpy()
        dt = time.perf_counter() - t
        kept = [o.cpu() for o in self._capture] if capture else None
        self._capture = None
        self.k += 1
        return dt, outs, kept

    # -- the window ----------------------------------------------------
    def window(self, seconds: float, trace: bool) -> dict:
        wl = self.wl
        rng = np.random.default_rng([int(self.seed), _SAMPLE_STREAM])
        keep_n = wl["check_pairs"]
        sample: dict = {}                 # reservoir slot -> (k, frames, f32)
        lat, produced, traced = [], 0, None
        per_unit = None
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        i = 0
        while True:
            j = i if i < keep_n else int(rng.integers(0, i + 1))
            capture = j < keep_n
            if trace and traced is None and i == wl["trace_start"]:
                traced = self._traced(wl["trace_units"])
                i += traced.units
                continue
            if trace and i == 0:
                with self.kernels.record_launches() as records:
                    dt, outs, kept = self.pair(capture)
                per_unit = launch_work(records)
            else:
                dt, outs, kept = self.pair(capture)
            if capture:
                sample[j] = (self.k - 1, outs, kept)
            lat.append(dt)
            produced += len(outs)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        return {"elapsed": elapsed, "latencies": lat, "produced": produced,
                "pairs": i, "sample": sample,
                "peak": peak, "trace": traced, "launches": per_unit}

    def _traced(self, units: int):
        specs = {}
        for m in self.cell["per_layer"]:
            specs.update(getattr(self.readers[m["name"]], "RANGES", {}))
        return tr.traced_units(self.model, specs, self.pair, units,
                               self._sync)

    # -- the check -----------------------------------------------------
    def reference_state(self) -> dict:
        return make_state(self.shapes, self.cell["config"], self.seed,
                          self.device)

    def check(self, win: dict) -> dict:
        """The check's numbers for the sampled pairs: the program's kept
        outputs against the reference in the configuration's lane."""
        P = self.reference_state()
        ref_lane = lane_of(self.cell)
        got, want = [], []
        for k, frames, f32 in win["sample"].values():
            a, b = self.frames_of(k)
            r32, r8 = reference_outputs(self.cell, P, ref_lane, a, b,
                                        self.device)
            got.append((f32, frames))
            want.append((r32, r8))
        return check.eval_numbers(got, want)

    def control(self, win: dict, children=None) -> dict:
        """The control: the reference in the precision below the lane's, in
        the program's place, on the same sampled pairs; with ``children``,
        only those children take the lower precision."""
        P = self.reference_state()
        ref_lane = lane_of(self.cell)
        low = self.cell["config"]["control"]
        ctl_lane = {k: low[v] if children is None or k in children else v
                    for k, v in ref_lane.items()}
        got, want = [], []
        for k, _, _ in win["sample"].values():
            a, b = self.frames_of(k)
            got.append(reference_outputs(self.cell, P, ctl_lane, a, b,
                                         self.device))
            want.append(reference_outputs(self.cell, P, ref_lane, a, b,
                                          self.device))
        return check.eval_numbers(got, want)

    def flops_call(self, win: dict):
        """One reference pair at the cell's shapes, for the FLOP count."""
        P = self.reference_state()
        k = next(iter(win["sample"].values()))[0] if win["sample"] else 0
        a, b = self.frames_of(k)
        return lambda: reference_outputs(self.cell, P, lane_of(self.cell), a,
                                         b, self.device)

    def free(self) -> None:
        del self.model
        self.b_in = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def frames_between(model, a, b, pads, save_which):
    """The driver's ``frames_between``: looked up at call time, so a test
    can put a broken path in its place."""
    from vfidkr_torch.apps.interpolate_video import frames_between as fb
    return fb(model, a, b, pads, save_which)
