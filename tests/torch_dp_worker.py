"""One data-parallel rank of the port's trainer (tests/test_torch_parallel.py).

Run as ``python tests/torch_dp_worker.py <out_dir> <trainer args...>`` with
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set, as ``torchrun`` sets
them.  It runs ``vfidkr_torch.apps.train.main`` and then writes
``<out_dir>/rank<r>.pt``: the names of the checkpoints this rank saved and
its model's final state dict.  It imports no JAX.
"""
import os
import sys

import torch

from vfidkr_torch import training
from vfidkr_torch.apps import train as train_app
from vfidkr_torch.training import checkpoint


def main() -> None:
    out_dir, argv = sys.argv[1], sys.argv[2:]
    saved, models = [], []
    real_save = checkpoint.CheckpointManager._save
    real_step = training.train_step

    def save(self, name, state):
        saved.append(name)
        real_save(self, name, state)

    def step(model, *args, **kwargs):
        models.append(model)
        return real_step(model, *args, **kwargs)

    checkpoint.CheckpointManager._save = save
    training.train_step = step
    train_app.main(argv)
    torch.save({"saved": saved,
                "model": {k: v.clone() for k, v in
                          models[-1].state_dict().items()}},
               os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


if __name__ == "__main__":
    main()
