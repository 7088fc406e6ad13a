"""DAIN and DAIN_slowmotion trainer of the PyTorch port (counterpart of
``apps/train.py``; reference ``train.py``).

Vimeo-90K triplets with balanced sampling and the reference's augmentations,
Adamax in three learning-rate groups, the Charbonnier pixel loss (alpha-
weighted over the raw and rectified outputs), validation with PSNR after each
epoch, ReduceLROnPlateau on the validation loss, epoch checkpoints with the
previous epoch deleted, the best-on-validation checkpoint, and one row per
epoch in ``log.txt`` (epoch, lr scale, train loss, val loss, val PSNR).
``--net-name DAIN_slowmotion`` trains ``DAINSlowMotion(0.5)``, one frame a
triplet, as JAX's trainer does at its default time step; its context and
depth nets stay frozen.

Usage:
  python -m vfidkr_torch.apps.train \\
      --dataset-path /data/vimeo_triplet --save-path runs/x \\
      [--net-name DAIN|DAIN_slowmotion] [--batch-size 3] [--num-epochs 50] \\
      [--lr 2e-3] [--device cuda] ...

It trains on the card (``--device`` defaults to ``cuda``) unless asked for
the CPU (``--device cpu``); nothing falls back.

Data-parallel over ranks started by ``torchrun`` (``WORLD_SIZE`` > 1), as
JAX's trainer is over a mesh of every chip (``vfidkr_torch.parallel.mesh``):

  torchrun --nproc_per_node=N -m vfidkr_torch.apps.train \\
      --dataset-path /data/vimeo_triplet --save-path runs/x --batch-size 6

``--batch-size`` stays the global batch and must divide by N.  Each rank
(card ``LOCAL_RANK``, NCCL; gloo with ``--device cpu``) decodes only its
share of every batch, in its own decode pool, and the gradients are
averaged across ranks before Adamax, so a step equals the one-process step
on the whole batch.  The losses and the validation metrics are averaged
across ranks; rank 0 alone writes the checkpoints, ``log.txt`` and the
TensorBoard scalars; every rank restores on ``--resume``.  At world size 1
the trainer is the one-process trainer.  The PNG frames are decoded
without PIL (``vfidkr_torch.utils.image_io``) and augmented by the port's
C++ augment (``vfidkr_torch.data.native``, built with ``g++`` at first
use).  On the card they are decoded in up to 4 worker processes
(``vfidkr_torch.data.vimeo90k.decode_pool``): a batch of PIL-written frames
takes the decoder's diagonal walk, and on one thread it outlasts the step.
On the CPU, which trains on every core, they are decoded on the prefetch
thread.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    from vfidkr_torch.config import (TRAIN_NET_NAMES, DataConfig, ModelConfig,
                                     add_device_flag)
    from vfidkr_torch.training.train_state import TrainConfig
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(ap)
    ap.add_argument("--dataset-path", required=True)
    ap.add_argument("--save-path", required=True)
    ap.add_argument("--net-name", default=ModelConfig.net_name,
                    choices=TRAIN_NET_NAMES)
    ap.add_argument("--batch-size", type=int, default=DataConfig.batch_size)
    ap.add_argument("--num-epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=TrainConfig.lr)
    ap.add_argument("--rectify-lr", type=float,
                    default=TrainConfig.rectify_lr)
    ap.add_argument("--flow-lr-coe", type=float,
                    default=TrainConfig.flow_lr_coe)
    ap.add_argument("--filter-lr-coe", type=float,
                    default=TrainConfig.filter_lr_coe)
    ap.add_argument("--alpha", type=float, nargs=2,
                    default=list(TrainConfig.alpha))
    ap.add_argument("--epsilon", type=float, default=TrainConfig.epsilon)
    ap.add_argument("--factor", type=float, default=TrainConfig.factor)
    ap.add_argument("--patience", type=int, default=TrainConfig.patience)
    ap.add_argument("--seed", type=int, default=DataConfig.seed)
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="default: len(train) // batch size, as the "
                         "reference")
    ap.add_argument("--val-batches", type=int, default=None)
    ap.add_argument("--pretrained", default=None,
                    help="a reference .pth state dict (loaded by key "
                         "intersection) or a checkpoint this trainer wrote")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest epoch checkpoint in "
                         "--save-path: restores the model, the Adamax state, "
                         "the plateau schedule and the best validation loss, "
                         "and appends to log.txt")
    return ap.parse_args(argv)


def make_config(args):
    """The run's ``Config`` from its flags; what no flag sets (the crop, the
    augmentation, the dataset's name) keeps its default."""
    from vfidkr_torch.config import Config, DataConfig, ModelConfig
    from vfidkr_torch.training.train_state import TrainConfig
    return Config(
        model=ModelConfig(net_name=args.net_name),
        data=DataConfig(dataset_path=args.dataset_path,
                        batch_size=args.batch_size, seed=args.seed),
        train=TrainConfig(
            lr=args.lr, rectify_lr=args.rectify_lr,
            flow_lr_coe=args.flow_lr_coe, filter_lr_coe=args.filter_lr_coe,
            alpha=tuple(args.alpha), epsilon=args.epsilon,
            factor=args.factor, patience=args.patience))


def main(argv=None) -> None:
    args = parse_args(argv)
    from vfidkr_torch.data.vimeo90k import decode_pool
    # the host's cores shared among the ranks' pools
    world = int(os.environ.get("WORLD_SIZE", "1"))
    workers = (min(4, ((os.cpu_count() or 1) - 1) // world)
               if torch.device(args.device).type == "cuda" else 0)
    with decode_pool(workers) as pool:
        train(args, pool)


def train(args, pool=None) -> None:
    """The training run of ``args``, its frames decoded in ``pool``, as the
    rank that the ``torchrun`` environment names (the only one without
    it)."""
    from vfidkr_torch.data.vimeo90k import (DATASETS, train_batches,
                                            val_batches)
    from vfidkr_torch.parallel import mesh as M
    from vfidkr_torch.training import (CheckpointManager, eval_step,
                                       full_state, load_weights,
                                       make_optimizer, plateau_init,
                                       plateau_step, restore_full_state,
                                       train_step)

    cfg = make_config(args)
    data, config = cfg.data, cfg.train
    if data.dataset_name not in DATASETS:
        raise ValueError(f"dataset {data.dataset_name!r}: the trainer reads "
                         f"{sorted(DATASETS)}")
    mesh = M.create_mesh(args.device)
    share = M.shard_range(data.batch_size, mesh)
    device = mesh.device
    main_rank = mesh.is_main
    say = print if main_rank else (lambda *a, **k: None)
    os.makedirs(args.save_path, exist_ok=True)
    log_path = os.path.join(args.save_path, "log.txt")
    tb = None
    if main_rank:
        with open(os.path.join(args.save_path, "args.txt"), "w") as f:
            json.dump(vars(args), f, indent=2)
        if not args.resume:
            open(log_path, "w").close()
        # TensorBoard scalars with the reference's tensorboardX and tags
        # (train.py:209,274-275), where that package is installed
        try:
            from tensorboardX import SummaryWriter
            tb = SummaryWriter(os.path.join(args.save_path, "tb"))
        except ImportError:
            pass

    train_paths, test_paths = DATASETS[data.dataset_name](data.dataset_path)
    say(f"{len(train_paths) + len(test_paths)} samples found, "
          f"{len(train_paths)} train samples and {len(test_paths)} test "
          f"samples")

    model = cfg.model.build(torch.Generator().manual_seed(data.seed))
    if args.pretrained:
        loaded, _ = load_weights(model, args.pretrained)
        say(f"fine-tuning: loaded {len(loaded)} tensors from "
            f"{args.pretrained}")
    model = model.to(device)
    optimizer = make_optimizer(model, config)
    plateau = plateau_init()

    ckpt = CheckpointManager(args.save_path)
    best_val = float("inf")
    rows = []
    start_epoch = 0
    if args.resume:
        last = ckpt.latest_epoch()
        if last is None:
            say("--resume: no epoch checkpoint found, starting fresh")
        else:
            state = ckpt.load(f"epoch{last}")
            plateau = restore_full_state(state, model, optimizer)
            best_val = state["best_val"]
            start_epoch = last + 1
            if os.path.exists(log_path) and os.path.getsize(log_path) > 0:
                prior = np.loadtxt(log_path, delimiter=",", ndmin=2)
                rows = [list(r) for r in prior if int(r[0]) <= last]
            rank = f"rank {mesh.rank}: " if mesh.world > 1 else ""
            print(f"{rank}resumed from epoch{last} (next epoch "
                  f"{start_epoch}, best val {best_val:.5f}, lr scale "
                  f"{plateau.scale:.4f})")
    # every rank starts from rank 0's weights
    M.replicate(model, mesh)

    steps = args.steps_per_epoch or len(train_paths) // data.batch_size
    val_steps = args.val_batches or len(test_paths) // data.batch_size
    to_dev = lambda b: {k: v.to(device, non_blocking=True)
                        for k, v in b.items()}
    reduce_grads = (lambda m: M.average_gradients(m, mesh)) if mesh.joined \
        else None

    for epoch in range(start_epoch, args.num_epochs):
        t0 = time.time()
        train_losses = []
        for i, batch in enumerate(train_batches(
                data.dataset_path, train_paths, data.batch_size, steps,
                data.seed, epoch, pool, share, data.crop_hw,
                data.augment_train)):
            metrics = M.mean_across(train_step(
                model, optimizer, to_dev(batch), config, plateau.scale,
                reduce_grads), mesh)
            train_losses.append(float(metrics["total"]))
            if i % max(1, steps // 50) == 0:
                pix = [round(float(x), 5) for x in metrics["pixel"]]
                say(f"Ep [{epoch}/{i}] lr_scale {plateau.scale:.4f} "
                    f"Pix {pix} TV {float(metrics['tv']):.4f} "
                    f"Sym {float(metrics['sym']):.4f} "
                    f"Total {float(metrics['total']):.5f}")
        train_avg = float(np.mean(train_losses)) if train_losses else 0.0
        say(f"***** epoch {epoch} took {time.time() - t0:.3f}s *****")

        vals, psnrs = [], []
        for batch in val_batches(data.dataset_path, test_paths,
                                 data.batch_size, val_steps, pool, share,
                                 data.crop_hw):
            m = M.mean_across(eval_step(model, to_dev(batch), config), mesh)
            vals.append(float(m["total"]))
            psnrs.append(float(m["psnr"]))
        val_avg = float(np.mean(vals)) if vals else 0.0
        psnr_avg = float(np.mean(psnrs)) if psnrs else 0.0
        say(f"Epoch {epoch}\tAvg Train {train_avg:.5f}\tVal {val_avg:.5f}\t"
            f"PSNR {psnr_avg:.5f}")

        rows.append([epoch, plateau.scale, train_avg, val_avg, psnr_avg])
        if main_rank:
            np.savetxt(log_path, np.asarray(rows), fmt="%.8f", delimiter=",")
        if tb is not None:
            tb.add_scalar("Train/Loss", round(train_avg, 5), epoch)
            tb.add_scalar("Test/Loss", round(val_avg, 5), epoch)
            tb.add_scalar("Test/PSNR", round(psnr_avg, 5), epoch)
            tb.flush()

        if val_avg <= best_val:
            best_val = val_avg
            if main_rank:
                ckpt.save_best(full_state(model, optimizer, plateau, epoch,
                                          best_val))
            say("\t\tBest weights updated for decreased validation loss")

        plateau = plateau_step(plateau, val_avg, factor=config.factor,
                               patience=config.patience)
        # saved last, so a resume from epoch<k> finds epoch k's validation,
        # best-on-val and plateau step already done
        if main_rank:
            ckpt.save_epoch(epoch, full_state(model, optimizer, plateau,
                                              epoch, best_val))

    if tb is not None:
        tb.close()
    # no rank leaves (and no resume reads) before rank 0's last save
    M.barrier(mesh)
    say("*********Finish Training********")


if __name__ == "__main__":
    main()
