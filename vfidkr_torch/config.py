"""Model construction from the command-line flags of the port's apps.

Counterpart of ``ModelConfig`` and ``add_model_flags`` in
``vfidkr_tpu/config.py:22-106``, carrying what means something in the port:
the network, its time step and the compute dtype (``"bfloat16"`` is the
fast-eval lane).  The JAX package's implementation selectors
(``filter_impl``, ``depth_impl``, ``steps_impl``, ``pwc_batch_chunk``,
``dense_impl``) are TPU workarounds that the port leaves behind.

Every app of the port runs on the card unless asked for the CPU:
``--device`` defaults to ``cuda`` (``add_device_flag``).
"""

from __future__ import annotations

import dataclasses
import sys

import torch

NET_NAMES = ("DAIN", "DAIN_slowmotion")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """netName / time_step (``my_args.py:14-38``) and the compute dtype."""
    net_name: str = "DAIN"
    time_step: float = 0.5
    compute_dtype: str = "float32"

    def build(self, generator: torch.Generator | None = None
              ) -> torch.nn.Module:
        """The model, with seeded random weights (``generator``)."""
        from vfidkr_torch.models import DAIN, DAINSlowMotion
        if self.net_name == "DAIN":
            if self.time_step != 0.5:
                raise ValueError("DAIN interpolates at t = 0.5 only")
            return DAIN(generator=generator, compute_dtype=self.compute_dtype)
        if self.net_name == "DAIN_slowmotion":
            return DAINSlowMotion(self.time_step, generator=generator,
                                  compute_dtype=self.compute_dtype)
        raise ValueError(f"net_name must be one of {NET_NAMES}, got "
                         f"{self.net_name!r}")

    @classmethod
    def from_args(cls, args, **overrides) -> "ModelConfig":
        """From an argparse namespace of a parser that went through
        ``add_model_flags``; ``overrides`` win over flags."""
        fields = {f.name for f in dataclasses.fields(cls)}
        picked = {k: v for k, v in vars(args).items() if k in fields}
        picked.update(overrides)
        return cls(**picked)


def add_model_flags(ap, net_name: str | None = None,
                    time_step: float | None = None) -> None:
    """Register the model flags on an argparse parser; ``--net-name`` and
    ``--time-step`` only where a default is given (apps that pin the model
    leave them out)."""
    if net_name is not None:
        ap.add_argument("--net-name", dest="net_name", default=net_name,
                        choices=NET_NAMES)
    if time_step is not None:
        ap.add_argument("--time-step", dest="time_step", type=float,
                        default=time_step)
    ap.add_argument("--compute-dtype", dest="compute_dtype",
                    default="float32", choices=["float32", "bfloat16"],
                    help="convolution dtype; bfloat16 is the fast-eval lane "
                         "(MonoNet5, the rectifier and S2DF in bf16; PWC-Net, "
                         "MegaDepth and the warp and projection stay float32; "
                         "evaluation only)")


def build_eval_model(args) -> torch.nn.Module:
    """An eval app's DAIN (the JAX package's eval apps pin it) from the flags,
    random weights from seed 0 (their ``PRNGKey(0)``), then
    ``args.torch_checkpoint`` where given (a reference ``.pth`` or a
    checkpoint of the port's trainer); on ``args.device``, in eval mode."""
    model = ModelConfig.from_args(args, net_name="DAIN").build(
        torch.Generator().manual_seed(0))
    if args.torch_checkpoint:
        from vfidkr_torch.training import load_weights
        loaded, skipped = load_weights(model, args.torch_checkpoint)
        print(f"loaded {len(loaded)} tensors ({len(skipped)} skipped)",
              file=sys.stderr)
    return model.to(torch.device(args.device)).eval()


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
