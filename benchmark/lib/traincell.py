"""A training cell: the trainer's step over batches that the trainer's own
host augment makes on a prefetch thread.

Set-up builds one object, the model with its Adamax state
(``make_optimizer(model, TrainConfig())``), and drives it through its
first three steps by the window's own call (``train_step``) and feed; their
losses, the first gradient as the optimizer got it (from its state after
one step) and the parameters after the third step are kept for the check.
The same object then runs the window: steps until the window's seconds
are up, each loss read back as the trainer reads it, and a synchronise at
the end; ``train_step_ms`` is the window over the steps it finished.

The feed: each batch's pool indices and augment records come from the seed
(``traffic.batch_plan``); ``vfidkr_torch.data.native.augment_triplets``
makes the (B,3,H,W) float32 batch on the host on a prefetch thread
(``vfidkr_torch.data.vimeo90k.prefetch``), and the main thread copies it
to the card as the trainer does (``non_blocking=True``).
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark.lib import check, trace as tr
from benchmark.lib.cell import build_model, lane_of
from benchmark.lib.traffic import (augment_plain, batch_plan, batch_plans,
                                   make_triplets)
from benchmark.lib.weights import make_state
from benchmark.lib.work import launch_work
from benchmark.reference import ops as ref_ops, train as ref_train

CHECK_STEPS = 3
BETA1 = 0.9          # Adamax's: the first gradient is exp_avg / (1 - beta1)


def train_step(model, opt, batch, config):
    """The trainer's ``train_step``: looked up at call time, so a test can
    put a broken step in its place."""
    from vfidkr_torch.training.train_state import train_step as step
    return step(model, opt, batch, config)


class TrainRun:
    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.wl, self.mix = cell["workload"], cell["mix"]
        self.readers: dict = {}

    # -- set-up --------------------------------------------------------
    def setup(self, mark=lambda phase: None) -> None:
        """``mark(phase)`` is called at the end of each phase of set-up."""
        from vfidkr_torch import kernels
        from vfidkr_torch.data import native
        from vfidkr_torch.data.vimeo90k import prefetch
        from vfidkr_torch.training.train_state import (TrainConfig,
                                                       make_optimizer)
        self.kernels = kernels
        mark("program imports")
        native.load_library()
        if self.device.type == "cuda":
            kernels.build.load_library()
        mark("kernels")
        self.config = TrainConfig()
        self.pool = make_triplets(self.mix, self.seed, self.device)
        mark("traffic")
        self.model, self.shapes = build_model(self.cell, self.device,
                                              self.seed)
        self.model.train()
        self.opt = make_optimizer(self.model, self.config)
        self._sync()
        mark("model")
        self.names = {id(p): n for n, p in self.model.named_parameters()}
        self.augment_s: list = []
        crop = (self.mix["height"], self.mix["width"])

        def feed():
            for idx, records in batch_plans(self.mix, self.seed):
                t = time.perf_counter()
                b = native.augment_triplets([self.pool[i] for i in idx],
                                            records, crop)
                self.augment_s.append(time.perf_counter() - t)
                yield b

        self.feed = prefetch(feed(), 2)
        self.losses = []
        for step in range(1, CHECK_STEPS + 1):
            self.losses.append(self.step())
            if step == 1:
                self.grad1 = {self.names[id(p)]: (s["exp_avg"] / (1 - BETA1))
                              .cpu() for p, s in self.opt.state.items()}
            mark(f"step {step}")
        self.after = {self.names[id(p)]: p.detach().to("cpu", copy=True)
                      for g in self.opt.param_groups for p in g["params"]}
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> float:
        batch = {k: v.to(self.device, non_blocking=True)
                 for k, v in next(self.feed).items()}
        m = train_step(self.model, self.opt, batch, self.config)
        return float(m["total"])

    # -- the window ----------------------------------------------------
    def window(self, seconds: float, trace: bool) -> dict:
        wl = self.wl
        traced, per_unit = None, None
        n_aug = len(self.augment_s)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        steps = 0
        while True:
            if trace and traced is None and steps == wl["trace_start"]:
                traced = self._traced(wl["trace_units"])
                steps += traced.units
            elif trace and steps == 0:
                with self.kernels.record_launches() as records:
                    self.step()
                per_unit = launch_work(records)
                steps += 1
            else:
                self.step()
                steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        if traced is not None:
            traced.extra["augment_s"] = self.augment_s[n_aug:]
        return {"elapsed": elapsed, "steps": steps, "peak": peak,
                "trace": traced, "launches": per_unit}

    def _traced(self, units: int):
        specs = {}
        for m in self.cell["per_layer"]:
            specs.update(getattr(self.readers[m["name"]], "RANGES", {}))
        return tr.traced_units(self.model, specs, self.step, units,
                               self._sync, self.opt)

    # -- the check -----------------------------------------------------
    def reference_batches(self) -> list:
        out = []
        for idx, records in batch_plan(self.mix, self.seed, CHECK_STEPS):
            samples = [augment_plain(self.pool[i], r)
                       for i, r in zip(idx, records)]
            out.append({k: torch.stack([s[k] for s in samples]).to(
                self.device) for k in ("x0", "x1", "y")})
        return out

    def reference(self, lane: dict) -> dict:
        P = make_state(self.shapes, self.cell["config"], self.seed,
                       self.device)
        ctx = (ref_ops.tf32_on(self.device) if "tf32" in lane.values()
               else contextlib.nullcontext())
        with ctx:
            return ref_train.train_steps(self.cell["reference"],
                                         self.cell["config"], P,
                                         self.reference_batches(), lane)

    def program_readings(self) -> dict:
        P0 = make_state(self.shapes, self.cell["config"], self.seed,
                        self.device)
        change = {k: v - P0[k].cpu() for k, v in self.after.items()}
        return {"losses": self.losses, "grad1": self.grad1,
                "change": change}

    def check(self, win: dict | None = None) -> dict:
        got = self.program_readings()
        return compare(got, self.reference(lane_of(self.cell)))

    def control(self, win: dict | None = None) -> dict:
        low = self.cell["config"]["control"]
        lane = {k: low[v] for k, v in lane_of(self.cell).items()}
        return compare(self.reference(lane),
                       self.reference(lane_of(self.cell)))

    def flops_call(self, win: dict):
        """One reference step at the cell's shapes, for the FLOP count."""
        P = make_state(self.shapes, self.cell["config"], self.seed,
                       self.device)
        batch = self.reference_batches()[0]
        reference = self.cell["reference"]
        leaves = list(ref_train.trained(P, reference.groups))
        return lambda: ref_train.loss_and_grads(
            reference, self.cell["config"], P, batch, lane_of(self.cell),
            leaves)

    def free(self) -> None:
        del self.model, self.opt
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def compare(got: dict, want: dict) -> dict:
    cpu = lambda d: {k: v.detach().float().cpu() for k, v in d.items()}
    return check.train_numbers(got["losses"], want["losses"],
                               cpu(got["grad1"]), cpu(want["grad1"]),
                               cpu(got["change"]), cpu(want["change"]))
