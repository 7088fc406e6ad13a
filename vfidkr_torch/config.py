"""Configuration as plain data, and model construction from the flags of
the port's apps.

Counterpart of ``vfidkr_tpu/config.py``: ``ModelConfig`` and
``add_model_flags`` carry what means something in the port: the network,
its time step and the compute dtype (``"bfloat16"`` is the fast-eval lane).
The JAX package's implementation selectors (``filter_impl``,
``depth_impl``, ``steps_impl``, ``pwc_batch_chunk``, ``dense_impl``) are TPU
workarounds that the port leaves behind.  ``DataConfig``, ``EvalConfig``
and ``Config`` keep JAX's fields and defaults (but ``save_which``, -1 where
JAX's is 1: the same one of DAIN's two outputs, and SepConv's only one),
with the port's ``TrainConfig``, and are where the defaults in use live:
the loader's crop and augmentation (``data/vimeo90k.py``), the trainer's
flags (it builds a ``Config`` from them, ``apps/train.make_config``), the
apps' ``--save-which`` and the frames' padding (``utils/padding.py``).

Every app of the port runs on the card unless asked for the CPU:
``--device`` defaults to ``cuda`` (``add_device_flag``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import TYPE_CHECKING, Tuple

import torch

if TYPE_CHECKING:
    from vfidkr_torch.training.train_state import TrainConfig

NET_NAMES = ("DAIN", "DAIN_slowmotion", "SepConv")
# the networks the trainer trains (SepConv is evaluation only)
TRAIN_NET_NAMES = ("DAIN", "DAIN_slowmotion")


def _fixed_time_step(net_name: str) -> float | None:
    """The one time step the network interpolates at (its class's
    ``TIME_STEP``), or None where it takes any (or is not registered)."""
    from vfidkr_torch.models import MODEL_REGISTRY
    return getattr(MODEL_REGISTRY.get(net_name), "TIME_STEP", None)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """netName / time_step (``my_args.py:14-38``) and the compute dtype.  A
    network that interpolates at one time step only (DAIN, SepConv: t = 0.5)
    refuses any other."""
    net_name: str = "DAIN"
    time_step: float = 0.5
    compute_dtype: str = "float32"

    def __post_init__(self):
        fixed = _fixed_time_step(self.net_name)
        if fixed is not None and self.time_step != fixed:
            raise ValueError(f"{self.net_name} interpolates at t = {fixed} "
                             f"only (--time-step {fixed} only); "
                             f"DAIN_slowmotion takes other time steps")

    def build(self, generator: torch.Generator | None = None
              ) -> torch.nn.Module:
        """The model, with seeded random weights (``generator``), built by
        ``models.build_model``.  A network whose class sets
        ``CUDNN_BENCHMARK`` (SepConv) turns cuDNN's autotuner on for the
        process here, once, before any forward or shard thread runs."""
        from vfidkr_torch.models import build_model
        kwargs = dict(generator=generator, compute_dtype=self.compute_dtype)
        if _fixed_time_step(self.net_name) is None:
            kwargs["timestep"] = self.time_step
        model = build_model(self.net_name, **kwargs)
        if getattr(model, "CUDNN_BENCHMARK", False):
            torch.backends.cudnn.benchmark = True
        return model

    @classmethod
    def from_args(cls, args, **overrides) -> "ModelConfig":
        """From an argparse namespace of a parser that went through
        ``add_model_flags``; ``overrides`` win over flags."""
        fields = {f.name for f in dataclasses.fields(cls)}
        picked = {k: v for k, v in vars(args).items() if k in fields}
        picked.update(overrides)
        return cls(**picked)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """datasetName / datasetPath / batch_size (``my_args.py:18-31``)."""
    dataset_name: str = "Vimeo_90K_interp"
    dataset_path: str = ""
    batch_size: int = 3
    crop_hw: Tuple[int, int] = (256, 448)
    augment_train: bool = True
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """save_which and the padding policy (``my_args.py:40``;
    ``demo_MiddleBury.py:294``)."""
    # 0: blended, 1: rectified; -1, the last, is DAIN's rectified frame and
    # SepConv's one output
    save_which: int = -1
    pad_multiple: int = 128
    min_pad: int = 32


def _train_config() -> "TrainConfig":
    # imported at first use: the apps' flags need no training package
    from vfidkr_torch.training.train_state import TrainConfig
    return TrainConfig()


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = DataConfig()
    train: "TrainConfig" = dataclasses.field(default_factory=_train_config)
    eval: EvalConfig = EvalConfig()


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


def add_save_which_flag(ap) -> None:
    ap.add_argument("--save-which", type=int, default=EvalConfig.save_which,
                    help="0: blended output, 1: rectified; default -1, the "
                         "network's last output (DAIN's rectified frame, "
                         "SepConv's only one)")


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
