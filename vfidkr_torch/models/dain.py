"""DAIN and DAIN_slowmotion forwards, NCHW float32.

Counterpart of ``DAIN.__call__`` in ``vfidkr_tpu/models/dain.py:119-176``
(reference ``networks/DAIN.py:101-294``), at t = 0.5.  ``model.train()``
is JAX's ``train=True`` and ``model.eval()`` its ``train=False``; the mode
selects only the flow projection's hole fill (``hole_fill = not train``,
as ``FlowProjectionLayer.py:23`` fills only when no gradient is wanted):

1. MonoNet5 and two branch heads on ``cat([i0, i2])``: the 4x4 kernels;
2. PWC-Net flows in both directions, pyramid shared, directions batched;
3. ``upsample_bilinear(flows * (20 * 0.5), 4)``;
4. flow projection: holes filled in eval, left at 0 in training;
5. one filter interpolation of both frames, batched as 2B;
6. ``cur = ref0 / 2 + ref2 / 2``;
7. the 45-channel rectifier, added to ``cur``.

Batching both directions means each CUDA kernel launches once per forward
(the hole fill's only in eval) and once per backward.  The forward runs in
the profiler span ``vfidkr/forward``, each of its ops in one stage span,
``vfidkr/<stage>`` for depth, context, kernel_unet, flow, upsample,
projection, filter_warp and rectifier (``utils.profiling.span``; the
per-step stages once a step), and the backward of each trained stage in
``vfidkr/<stage>/backward``.  The children carry the reference checkpoint's
names (``initScaleNets_filter``,
``initScaleNets_filter1/2``, ``flownets``, ``rectifyNet``; DAIN_slowmotion
adds ``ctxNet`` and ``depthNet``).

``DAIN(init_unused=True)``, the default as in the JAX package
(``dain.py:52,106-117``), also builds the reference's vestigial children
``initOcclusion`` (OccNet), ``initDeconv_field`` (DeconvField) and
``ctxNet`` (S2DF), which its forward never calls (``DAIN.py:44-50``): every
reference DAIN checkpoint holds them, so one loads with ``strict=True``.
They are built after every other child, so at a given generator the other
weights, and the outputs, are those of ``init_unused=False`` bit for bit.
No optimizer group trains them (``training.train_state.FROZEN``), and a
checkpoint without them still loads (``convert.load_jax_variables``,
``training.checkpoint.restore_full_state``).

``compute_dtype="bfloat16"`` selects the fast-eval lane of the JAX package
(``dain.py:57-65, 134-170, 190-194, 248-263, 322-324``): MonoNet5 and the
heads, the rectifier (its residual trunk through the kernel
``fused_resblocks``) and, in DAIN_slowmotion, S2DF run in bf16; their
outputs are cast to float32 (the rectifier's before ``+ cur_output``).
PWC-Net, MegaDepth and the projection and warp ops stay float32.  The lane
is evaluation only (JAX's trainer passes no ``compute_dtype``): a bf16 model
is built in eval mode and ``train()`` raises.  ``"float32"``, the default,
is the reference's arithmetic.
"""

from __future__ import annotations

import torch
from torch import nn

from vfidkr_torch.models.layers import lane_dtype, upsample_bilinear
from vfidkr_torch.models.megadepth import (MegaDepthHourglass,
                                           depth_inv_from_log_depth)
from vfidkr_torch.models.mononet import (BranchHead, DeconvField, MonoNet5,
                                         OccNet)
from vfidkr_torch.models.pwcnet import PWCDCNet
from vfidkr_torch.models.resblock import MultipleBasicBlock
from vfidkr_torch.models.s2df import S2DF
from vfidkr_torch.ops import (depth_flow_project, filter_interpolate,
                              flow_project)
from vfidkr_torch.utils.profiling import span

DIV_FLOW = 20.0
TIMESTEP = 0.5


def _eval_only(model: nn.Module, mode: bool, why: str) -> nn.Module:
    if mode:
        raise NotImplementedError(f"{type(model).__name__} is evaluation "
                                  f"only in vfidkr_torch: {why}")
    return nn.Module.train(model, False)


_BF16_WHY = ("the bf16 lane's rectifier trunk (the kernel fused_resblocks) "
             "has no backward, and no training app runs the lane")


# DAIN's children that its forward never calls (see the module docstring)
VESTIGIAL = ("initOcclusion", "initDeconv_field", "ctxNet")


class DAIN(nn.Module):
    # the only time step it interpolates at (``ModelConfig`` checks it)
    TIME_STEP = TIMESTEP

    def __init__(self, generator: torch.Generator | None = None,
                 compute_dtype: str = "float32", init_unused: bool = True):
        super().__init__()
        g, dt = generator, lane_dtype(compute_dtype)
        self.compute_dtype = dt
        self.initScaleNets_filter = MonoNet5(generator=g, compute_dtype=dt)
        self.initScaleNets_filter1 = BranchHead(generator=g, compute_dtype=dt)
        self.initScaleNets_filter2 = BranchHead(generator=g, compute_dtype=dt)
        self.flownets = PWCDCNet(generator=g)
        self.rectifyNet = MultipleBasicBlock(45, 128, generator=g,
                                             compute_dtype=dt)
        # the children a checkpoint may lack (training.checkpoint)
        self.vestigial = VESTIGIAL if init_unused else ()
        if init_unused:
            self.initOcclusion = OccNet(generator=g)
            self.initDeconv_field = DeconvField(32, generator=g)
            self.ctxNet = S2DF(generator=g)
        if dt != torch.float32:
            self.train(False)

    def train(self, mode: bool = True) -> "DAIN":
        if self.compute_dtype != torch.float32:
            return _eval_only(self, mode, _BF16_WHY)
        return super().train(mode)

    def forward(self, i0: torch.Tensor, i2: torch.Tensor) -> dict:
        """i0, i2: (B,3,H,W) frames, H and W multiples of 64.

        Returns ``{"outputs": [cur_output, rectified], "offsets": [off0,
        off1], "filters": [filt0, filt1]}``."""
        b = i0.shape[0]
        with span("vfidkr/forward"):
            with span("vfidkr/kernel_unet") as s:
                trunk = self.initScaleNets_filter(torch.cat([i0, i2], 1))
                filt0 = self.initScaleNets_filter1(trunk).float()
                filt1 = self.initScaleNets_filter2(trunk).float()
                s.outputs(filt0, filt1)
            with span("vfidkr/flow") as s:
                raw_fwd, raw_bwd = self.flownets.bidirectional(i0, i2)
                s.outputs(raw_fwd, raw_bwd)
            with span("vfidkr/upsample") as s:
                flows = upsample_bilinear(torch.cat(
                    [raw_fwd, raw_bwd], 0) * (DIV_FLOW * TIMESTEP), 4)
                s.outputs(flows)
            with span("vfidkr/projection") as s:
                offs = flow_project(flows, hole_fill=not self.training)
                off0, off1 = offs[:b], offs[b:]
                s.outputs(offs, off0, off1)
            with span("vfidkr/filter_warp") as s:
                refs = filter_interpolate(torch.cat([i0, i2], 0), offs,
                                          torch.cat([filt0, filt1], 0))
                ref0, ref2 = refs[:b], refs[b:]
                cur_output = ref0 / 2.0 + ref2 / 2.0
                s.outputs(ref0, ref2, cur_output)
            with span("vfidkr/rectifier") as s:
                rectify_input = torch.cat(
                    [cur_output, ref0, ref2, off0, off1, filt0, filt1], 1)
                rectified = self.rectifyNet(rectify_input).float() + cur_output
                s.outputs(rectified)
        return {"outputs": [cur_output, rectified],
                "offsets": [off0, off1],
                "filters": [filt0, filt1]}


class DAINSlowMotion(nn.Module):
    """DAIN_slowmotion: ``1 / timestep - 1`` frames between i0 and i2, at
    t = timestep, 2 timestep, ...

    Counterpart of ``DAINSlowMotion.__call__`` in
    ``vfidkr_tpu/models/dain.py:179-357`` (reference
    ``networks/DAIN_slowmotion.py``), with its unrolled step loop:

    1. MegaDepth on ``cat([i0, i2])``: log-depth, then
       ``depth_inv = 1e-6 + exp(-log_depth)``;
    2. the contexts ``cat([S2DF(i), log_depth])``, 196 channels, the
       log-depth detached;
    3. MonoNet5 and two branch heads: the 4x4 kernels; PWC-Net flows in
       both directions;
    4. per step t: the flows scaled by ``20 t`` (forward) and ``20 (1 - t)``
       (backward; Python floats) and upsampled x4; the depth-weighted
       projection, with the hole fill in eval and without it in training;
       the warp of the context pair (flow and kernels detached) and of the
       frame pair; ``out = ref0 (1-t) + ref2 t``; the 437-channel rectifier,
       added to ``out``.

    Both directions are batched, so each step launches the projection's
    kernels, the context warp and the frame warp once each.  ``train()`` is
    JAX's ``train=True`` in float32: MegaDepth stays in eval mode whatever
    the mode (its BN on running statistics, JAX's ``train_bn=False``), and
    the projection's backward is the reference's
    (``vfidkr_torch.ops.flow_projection``).  The trainer freezes ``ctxNet``
    and ``depthNet`` (``vfidkr_torch.training.train_state.FROZEN``).
    """

    def __init__(self, timestep: float = 0.5,
                 generator: torch.Generator | None = None,
                 compute_dtype: str = "float32"):
        super().__init__()
        g, dt = generator, lane_dtype(compute_dtype)
        self.compute_dtype = dt
        self.vestigial = ()             # its ctxNet is live
        self.timestep = timestep
        self.num_frames = int(round(1.0 / timestep)) - 1
        self.initScaleNets_filter = MonoNet5(generator=g, compute_dtype=dt)
        self.initScaleNets_filter1 = BranchHead(generator=g, compute_dtype=dt)
        self.initScaleNets_filter2 = BranchHead(generator=g, compute_dtype=dt)
        self.ctxNet = S2DF(generator=g, compute_dtype=dt)
        self.depthNet = MegaDepthHourglass(generator=g)
        # 3*3 + 2*2 + 2*16 + 2*196 = 437 input channels
        self.rectifyNet = MultipleBasicBlock(437, 128, generator=g,
                                             compute_dtype=dt)
        self.flownets = PWCDCNet(generator=g)
        self.train(False)

    def train(self, mode: bool = True) -> "DAINSlowMotion":
        if self.compute_dtype != torch.float32:
            return _eval_only(self, mode, _BF16_WHY)
        super().train(mode)
        self.depthNet.train(False)
        return self

    def forward(self, i0: torch.Tensor, i2: torch.Tensor) -> dict:
        """i0, i2: (B,3,H,W) frames, H and W multiples of 64.

        Returns ``{"outputs": [outputs, rectified_outputs], "offsets":
        [off0, off1], "filters": [filt0, filt1]}``: a list of one frame per
        step each, and the last step's offsets."""
        b = i0.shape[0]
        with span("vfidkr/forward"):
            with span("vfidkr/depth"):
                frames = torch.cat([i0, i2], 0)
                log_depth = self.depthNet(frames)
                depth_inv = depth_inv_from_log_depth(log_depth)
            with span("vfidkr/context"):
                ctx = torch.cat([self.ctxNet(frames), log_depth.detach()], 1)
            with span("vfidkr/kernel_unet") as s:
                trunk = self.initScaleNets_filter(torch.cat([i0, i2], 1))
                filt0 = self.initScaleNets_filter1(trunk).float()
                filt1 = self.initScaleNets_filter2(trunk).float()
                filt = torch.cat([filt0, filt1], 0)
                s.outputs(filt0, filt1, filt)
            with span("vfidkr/flow") as s:
                raw_fwd, raw_bwd = self.flownets.bidirectional(i0, i2)
                s.outputs(raw_fwd, raw_bwd)

            steps = [k * self.timestep for k in range(1, 1 + self.num_frames)]
            outputs, rectified = [], []
            for t, t_rev in zip(steps, steps[::-1]):
                with span("vfidkr/upsample") as s:
                    flows = upsample_bilinear(torch.cat(
                        [raw_fwd * (DIV_FLOW * t),
                         raw_bwd * (DIV_FLOW * t_rev)], 0), 4)
                    s.outputs(flows)
                with span("vfidkr/projection") as s:
                    offs = depth_flow_project(flows, depth_inv,
                                              hole_fill=not self.training)
                    off0, off1 = offs[:b], offs[b:]
                    s.outputs(offs, off0, off1)
                with span("vfidkr/filter_warp") as s:
                    ctx_w = filter_interpolate(ctx, offs.detach(),
                                               filt.detach())
                    refs = filter_interpolate(frames, offs, filt)
                    ref0, ref2 = refs[:b], refs[b:]
                    out = ref0 * (1.0 - t) + ref2 * t
                    s.outputs(ref0, ref2, out)
                with span("vfidkr/rectifier") as s:
                    rectify_input = torch.cat(
                        [out, ref0, ref2, off0, off1, filt0, filt1, ctx_w[:b],
                         ctx_w[b:]], 1)
                    outputs.append(out)
                    rectified.append(
                        self.rectifyNet(rectify_input).float() + out)
                    s.outputs(rectified[-1])
        return {"outputs": [outputs, rectified],
                "offsets": [off0, off1],
                "filters": [filt0, filt1]}
