#!/usr/bin/env python
"""The port's trainer held to the JAX package's over many steps, on the CPU.

Both packages train the same model from the same initial weights (JAX's
init, carried over by ``vfidkr_torch.convert.load_jax_variables``) on the
same batches, each from its own loader over one synthetic Vimeo-layout tree
(``vfidkr_torch.data.synthetic``): the port's ``train_batches``, through its
C++ augment, and JAX's ``Vimeo90KDataset`` seeded as the port seeds an
epoch; every batch is checked bit for bit.  Each takes Adamax steps with the
plateau schedule stepped on its own validation loss after every epoch, as
the trainers do.  Then both run the eval protocol on the held-out triplets
(``tools/trained_parity.py:34-40``: the rectified frame clipped and rounded
to uint8 against the uint8 ground truth, MSE PSNR).

Reported (one JSON line on stdout; progress on stderr): each step's total
loss from both and the gap, the plateau scales, the PSNR of each and
|delta|, and the PSNR of the port's forward on JAX's trained weights (a gap
there is the forward's; a gap only between the two trained models is where
their weights trained apart), for DAIN and for DAINSlowMotion(0.5) trained
and evaluated at t = 0.5.  Frame sides must be multiples of 64 (PWC-Net's
pyramid).  The target is |delta PSNR| <= 0.05 dB; the exit code is 0 when
every model meets it, 2 otherwise.

Runs on the CPU, where both packages run:
  JAX_PLATFORMS=cpu python tools/trained_parity_torch.py \\
      [--steps 100] [--height 128 --width 256] [--nets DAIN DAIN_slowmotion]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PSNR_TARGET_DB = 0.05


def psnr_uint8(out01: np.ndarray, gt01: np.ndarray) -> float:
    """The reference eval protocol (demo_test_ourdata.py:334-352), as
    tools/trained_parity.py computes it."""
    rec = np.round(np.clip(out01, 0.0, 1.0) * 255.0)
    gt = np.round(np.clip(gt01, 0.0, 1.0) * 255.0)
    mse = float(np.mean((rec - gt) ** 2))
    return 20.0 * math.log10(255.0 / math.sqrt(max(mse, 1e-12)))


def _rectified(outputs):
    """The rectified frame of a DAIN or a t = 0.5 DAINSlowMotion output."""
    rect = outputs[1]
    return rect[0] if isinstance(rect, (list, tuple)) else rect


def train_pair(net: str, root: str, steps: int, steps_per_epoch: int,
               batch_size: int = 1, seed: int = 0, lr: float = 2e-3,
               validate: bool = True, eval_pairs: int = 0,
               twin: bool = False, log=lambda msg: None) -> dict:
    """Train ``net`` in both packages for ``steps`` steps on ``root``; see
    the module's docstring.  Returns the per-step losses, the plateau
    scales and, for ``eval_pairs`` > 0, the eval-protocol PSNRs.  With
    ``twin``, also each step's loss of the port's forward on JAX's weights
    of that step (``loss_port_on_jax_weights``): it separates the port's
    forward from the weights the two optimizers reached."""
    import jax
    import jax.numpy as jnp
    import torch

    from vfidkr_tpu.config import ModelConfig as JaxModelConfig
    from vfidkr_tpu.data import Vimeo90KDataset as JaxVimeo90KDataset
    from vfidkr_tpu.training import TrainConfig as JaxTrainConfig
    from vfidkr_tpu.training import create_train_state
    from vfidkr_tpu.training import eval_step as jax_eval_step
    from vfidkr_tpu.training import plateau_step as jax_plateau_step
    from vfidkr_tpu.training import train_step as jax_train_step

    from vfidkr_torch.config import ModelConfig
    from vfidkr_torch.convert import load_jax_variables
    from vfidkr_torch.data.vimeo90k import (Vimeo90KDataset, epoch_seed,
                                            train_batches, val_batches,
                                            vimeo90k_splits)
    from vfidkr_torch.training import (TrainConfig, eval_step,
                                       make_optimizer, plateau_init,
                                       plateau_step, train_step)
    from vfidkr_torch.training.train_state import _model_losses

    torch.manual_seed(seed)
    train, test = vimeo90k_splits(root)
    config = TrainConfig(lr=lr)
    config_j = JaxTrainConfig(lr=lr, batch_size=batch_size)
    # JAX's trainer's model (apps/train.py:104)
    model_j = JaxModelConfig(net_name=net, pwc_batch_chunk=None,
                             dense_impl="split").build()
    sample = next(JaxVimeo90KDataset(root, train, batch_size, seed=seed)
                  .batches(1))
    state, tx = create_train_state(
        model_j, jax.random.PRNGKey(seed),
        {k: jnp.asarray(v) for k, v in sample.items()}, config_j)
    port = ModelConfig(net_name=net).build()
    load_jax_variables(port, jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    opt = make_optimizer(port, config)
    plateau = plateau_init()
    jit_train = jax.jit(lambda s, b: jax_train_step(model_j, tx, s, b,
                                                    config_j))
    jit_eval = jax.jit(lambda s, b: jax_eval_step(model_j, s, b, config_j))
    val_steps = len(test) // batch_size

    twin_model = ModelConfig(net_name=net).build().train() if twin else None
    losses, scales, twin_losses = [], [], []
    epoch, t0 = 0, time.time()
    while len(losses) < steps:
        n = min(steps_per_epoch, steps - len(losses))
        jax_ds = JaxVimeo90KDataset(root, train, batch_size, augment=True,
                                    seed=epoch_seed(seed, epoch))
        pairs = zip(train_batches(root, train, batch_size, n, seed, epoch),
                    jax_ds.batches(n))
        for batch, jbatch in pairs:
            for k in ("x0", "x1", "y"):
                if not np.array_equal(batch[k].numpy(),
                                      jbatch[k].transpose(0, 3, 1, 2)):
                    raise AssertionError(f"the loaders' batches differ ({k})")
            if twin:
                load_jax_variables(twin_model, jax.device_get(
                    {"params": state.params,
                     "batch_stats": state.batch_stats}))
                with torch.no_grad():
                    twin_losses.append(float(_model_losses(
                        twin_model, batch, config)[0]))
            state, mj = jit_train(state, {k: jnp.asarray(v)
                                          for k, v in jbatch.items()})
            mt = train_step(port, opt, batch, config, plateau.scale)
            losses.append((float(mj["total"]), float(mt["total"])))
            scales.append((float(state.plateau.scale), plateau.scale))
            log(f"{net} step {len(losses) - 1}: JAX {losses[-1][0]:.6f} "
                f"port {losses[-1][1]:.6f} ({time.time() - t0:.0f} s)")
        if validate:
            vj, vt = [], []
            jval = JaxVimeo90KDataset(root, test, batch_size, augment=False)
            for batch, jbatch in zip(
                    val_batches(root, test, batch_size, val_steps),
                    jval.batches(val_steps, sequential=True)):
                vj.append(float(jit_eval(state, {
                    k: jnp.asarray(v) for k, v in jbatch.items()})["total"]))
                vt.append(float(eval_step(port, batch, config)["total"]))
            state = state.replace(plateau=jax_plateau_step(
                state.plateau, float(np.mean(vj)), factor=config_j.factor,
                patience=config_j.patience))
            plateau = plateau_step(plateau, float(np.mean(vt)),
                                   factor=config.factor,
                                   patience=config.patience)
            log(f"{net} epoch {epoch}: val JAX {np.mean(vj):.6f} port "
                f"{np.mean(vt):.6f}")
        epoch += 1

    gaps = [abs(a - b) for a, b in losses]
    result = {"net": net, "steps": steps, "epochs": epoch,
              "train_seconds": round(time.time() - t0, 1),
              "loss_jax": [a for a, _ in losses],
              "loss_port": [b for _, b in losses],
              "loss_gap_max": max(gaps),
              "loss_rel_gap_max": max(g / abs(a)
                                      for g, (a, _) in zip(gaps, losses)),
              "lr_scale_jax": [a for a, _ in scales],
              "lr_scale_port": [b for _, b in scales]}
    if twin:
        result["loss_port_on_jax_weights"] = twin_losses
    if eval_pairs:
        variables = {"params": state.params}
        if state.batch_stats:
            variables["batch_stats"] = state.batch_stats
        apply = jax.jit(lambda v, x0, x1: _rectified(
            model_j.apply(v, x0, x1)["outputs"]))
        ds = Vimeo90KDataset(root, test, 1, augment=False)
        # the port's forward on JAX's trained weights: what separates a
        # forward that differs from weights that trained apart
        on_jax = ModelConfig(net_name=net).build()
        load_jax_variables(on_jax, jax.device_get(variables))
        ours, theirs, cross = [], [], []
        for i in range(min(eval_pairs, len(test))):
            b = ds._make_batch([i])
            x0, x1 = (np.ascontiguousarray(b[k].numpy().transpose(0, 2, 3, 1))
                      for k in ("x0", "x1"))
            gt = b["y"][0].numpy().transpose(1, 2, 0)
            theirs.append(psnr_uint8(np.asarray(apply(
                variables, jnp.asarray(x0), jnp.asarray(x1)))[0], gt))
            for model, psnrs in ((port, ours), (on_jax, cross)):
                with torch.no_grad():
                    out = _rectified(model.eval()(b["x0"], b["x1"])["outputs"])
                psnrs.append(psnr_uint8(out[0].numpy().transpose(1, 2, 0), gt))
        result.update({
            "psnr_jax": float(np.mean(theirs)),
            "psnr_port": float(np.mean(ours)),
            "delta_db": float(abs(np.mean(ours) - np.mean(theirs))),
            "psnr_port_on_jax_weights": float(np.mean(cross)),
            "delta_db_on_jax_weights": float(abs(np.mean(cross)
                                                 - np.mean(theirs))),
            "per_pair_jax": theirs, "per_pair_port": ours})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work-dir",
                    default=os.path.join(REPO, "build", "trained_parity"))
    ap.add_argument("--nets", nargs="+", default=["DAIN", "DAIN_slowmotion"],
                    choices=["DAIN", "DAIN_slowmotion"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--steps-per-epoch", type=int, default=25)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--n", type=int, default=32,
                    help="triplets written (a quarter held out)")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-pairs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from vfidkr_torch.data import synthetic
    root = os.path.join(args.work_dir,
                        f"vimeo_{args.height}x{args.width}_n{args.n}")
    if not os.path.exists(os.path.join(root, "tri_trainlist.txt")):
        synthetic.main(["--out", root, "--n", str(args.n), "--height",
                        str(args.height), "--width", str(args.width),
                        "--test-frac", "0.25", "--seed", str(args.seed)])
    say = lambda msg: print(msg, file=sys.stderr, flush=True)
    t0 = time.time()
    results = [train_pair(net, root, args.steps, args.steps_per_epoch,
                          args.batch_size, args.seed, args.lr,
                          eval_pairs=args.eval_pairs, log=say)
               for net in args.nets]
    for r in results:
        say(f"{r['net']}: PSNR JAX {r['psnr_jax']:.4f} port "
            f"{r['psnr_port']:.4f} dB (|delta| {r['delta_db']:.4f}; the "
            f"port on JAX's weights {r['psnr_port_on_jax_weights']:.4f}, "
            f"|delta| {r['delta_db_on_jax_weights']:.4f}); loss gap max "
            f"{r['loss_gap_max']:.3e} ({r['loss_rel_gap_max']:.3e} "
            f"relative)")
    print(json.dumps({"size": [args.height, args.width], "n": args.n,
                      "batch_size": args.batch_size, "lr": args.lr,
                      "seconds": round(time.time() - t0, 1),
                      "models": results}))
    return 0 if all(r["delta_db"] <= PSNR_TARGET_DB for r in results) else 2


if __name__ == "__main__":
    sys.exit(main())
