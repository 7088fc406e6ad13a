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
the CPU (``--device cpu``); nothing falls back.  Decoding the PNG frames
needs PIL.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    from vfidkr_torch.config import add_device_flag
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(ap)
    ap.add_argument("--dataset-path", required=True)
    ap.add_argument("--save-path", required=True)
    ap.add_argument("--net-name", default="DAIN",
                    choices=["DAIN", "DAIN_slowmotion"])
    ap.add_argument("--batch-size", type=int, default=3)
    ap.add_argument("--num-epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--rectify-lr", type=float, default=1e-3)
    ap.add_argument("--flow-lr-coe", type=float, default=0.01)
    ap.add_argument("--filter-lr-coe", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, nargs=2, default=[0.0, 1.0])
    ap.add_argument("--epsilon", type=float, default=1e-6)
    ap.add_argument("--factor", type=float, default=0.2)
    ap.add_argument("--patience", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
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


def main(argv=None) -> None:
    args = parse_args(argv)
    from vfidkr_torch.data.vimeo90k import (train_batches, val_batches,
                                            vimeo90k_splits)
    from vfidkr_torch.models import DAIN, DAINSlowMotion
    from vfidkr_torch.training import (CheckpointManager, TrainConfig,
                                       eval_step, full_state, load_weights,
                                       make_optimizer, plateau_init,
                                       plateau_step, restore_full_state,
                                       train_step)

    device = torch.device(args.device)
    os.makedirs(args.save_path, exist_ok=True)
    with open(os.path.join(args.save_path, "args.txt"), "w") as f:
        json.dump(vars(args), f, indent=2)
    log_path = os.path.join(args.save_path, "log.txt")
    if not args.resume:
        open(log_path, "w").close()

    # TensorBoard scalars with the reference's tensorboardX and tags
    # (train.py:209,274-275), where that package is installed
    try:
        from tensorboardX import SummaryWriter
        tb = SummaryWriter(os.path.join(args.save_path, "tb"))
    except ImportError:
        tb = None

    config = TrainConfig(
        lr=args.lr, rectify_lr=args.rectify_lr,
        flow_lr_coe=args.flow_lr_coe, filter_lr_coe=args.filter_lr_coe,
        alpha=tuple(args.alpha), epsilon=args.epsilon,
        factor=args.factor, patience=args.patience)

    train_paths, test_paths = vimeo90k_splits(args.dataset_path)
    print(f"{len(train_paths) + len(test_paths)} samples found, "
          f"{len(train_paths)} train samples and {len(test_paths)} test "
          f"samples")

    generator = torch.Generator().manual_seed(args.seed)
    model = (DAINSlowMotion(0.5, generator=generator)
             if args.net_name == "DAIN_slowmotion" else
             DAIN(generator=generator))
    if args.pretrained:
        loaded, _ = load_weights(model, args.pretrained)
        print(f"fine-tuning: loaded {len(loaded)} tensors from "
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
            print("--resume: no epoch checkpoint found, starting fresh")
        else:
            state = ckpt.load(f"epoch{last}")
            plateau = restore_full_state(state, model, optimizer)
            best_val = state["best_val"]
            start_epoch = last + 1
            if os.path.exists(log_path) and os.path.getsize(log_path) > 0:
                prior = np.loadtxt(log_path, delimiter=",", ndmin=2)
                rows = [list(r) for r in prior if int(r[0]) <= last]
            print(f"resumed from epoch{last} (next epoch {start_epoch}, "
                  f"best val {best_val:.5f}, lr scale {plateau.scale:.4f})")

    steps = args.steps_per_epoch or len(train_paths) // args.batch_size
    val_steps = args.val_batches or len(test_paths) // args.batch_size
    to_dev = lambda b: {k: v.to(device, non_blocking=True)
                        for k, v in b.items()}

    for epoch in range(start_epoch, args.num_epochs):
        t0 = time.time()
        train_losses = []
        for i, batch in enumerate(train_batches(
                args.dataset_path, train_paths, args.batch_size, steps,
                args.seed, epoch)):
            metrics = train_step(model, optimizer, to_dev(batch), config,
                                 plateau.scale)
            train_losses.append(float(metrics["total"]))
            if i % max(1, steps // 50) == 0:
                pix = [round(float(x), 5) for x in metrics["pixel"]]
                print(f"Ep [{epoch}/{i}] lr_scale {plateau.scale:.4f} "
                      f"Pix {pix} TV {float(metrics['tv']):.4f} "
                      f"Sym {float(metrics['sym']):.4f} "
                      f"Total {float(metrics['total']):.5f}")
        train_avg = float(np.mean(train_losses)) if train_losses else 0.0
        print(f"***** epoch {epoch} took {time.time() - t0:.1f}s *****")

        vals, psnrs = [], []
        for batch in val_batches(args.dataset_path, test_paths,
                                 args.batch_size, val_steps):
            m = eval_step(model, to_dev(batch), config)
            vals.append(float(m["total"]))
            psnrs.append(float(m["psnr"]))
        val_avg = float(np.mean(vals)) if vals else 0.0
        psnr_avg = float(np.mean(psnrs)) if psnrs else 0.0
        print(f"Epoch {epoch}\tAvg Train {train_avg:.5f}\tVal {val_avg:.5f}\t"
              f"PSNR {psnr_avg:.5f}")

        rows.append([epoch, plateau.scale, train_avg, val_avg, psnr_avg])
        np.savetxt(log_path, np.asarray(rows), fmt="%.8f", delimiter=",")
        if tb is not None:
            tb.add_scalar("Train/Loss", round(train_avg, 5), epoch)
            tb.add_scalar("Test/Loss", round(val_avg, 5), epoch)
            tb.add_scalar("Test/PSNR", round(psnr_avg, 5), epoch)
            tb.flush()

        if val_avg <= best_val:
            best_val = val_avg
            ckpt.save_best(full_state(model, optimizer, plateau, epoch,
                                      best_val))
            print("\t\tBest weights updated for decreased validation loss")

        plateau = plateau_step(plateau, val_avg, factor=config.factor,
                               patience=config.patience)
        # saved last, so a resume from epoch<k> finds epoch k's validation,
        # best-on-val and plateau step already done
        ckpt.save_epoch(epoch, full_state(model, optimizer, plateau, epoch,
                                          best_val))

    if tb is not None:
        tb.close()
    print("*********Finish Training********")


if __name__ == "__main__":
    main()
