"""Train a ``TileScreen`` on a tiled detection dataset (counterpart of
``tools/train_screen.py``). A tile's label is free: it is positive when
it carries any ground truth (``targets["gt_mask"].any(axis=1)``), so any
dataset the detector trains on trains the screen. The config's
``dataset.train`` entry is used as written.

    python -m rs_detection_tpu_torch.tools.train_screen \\
        --config-file CFG [--iters 2000] [--lr 1e-3] \\
        [--out work_dirs/screen.pkl] [--log-interval 50] [--cpu]

The optimizer is ``torch.optim.AdamW`` with optax's ``adamw`` defaults
(weight decay 1e-4, eps 1e-8; torch's default decay is 1e-2). The
checkpoint is ``{"model": {"params": ...}}`` of numpy arrays in flax's
nesting, which ``SceneDataset(screen=dict(checkpoint=...))`` reads in
the port and in the JAX package alike. Training runs on the CUDA card
(an error where there is none) unless ``--cpu`` is passed.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ..models.networks.tile_screen import TileScreen, screen_loss
from ..utils.jax_weights import module_to_jax_params


def make_optimizer(model: TileScreen, lr: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4,
                             eps=1e-8)


def screen_step(model: TileScreen, optimizer, images, gt_mask: np.ndarray):
    """One AdamW step on a batch (``images`` normalized NHWC, numpy or a
    tensor; ``gt_mask`` [B, G]); returns the loss and accuracy as
    detached tensors."""
    device = next(model.parameters()).device
    x = torch.as_tensor(images, device=device)
    labels = torch.as_tensor(np.asarray(gt_mask).any(axis=1),
                             device=device)
    loss, metrics = screen_loss(model(x), labels)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def train(dataset, iters: int, lr: float, device,
          log_interval: int = 50) -> TileScreen:
    """A ``TileScreen`` trained for ``iters`` steps over
    ``dataset.batches(seed=it)`` passes (``it`` the step count at the
    start of a pass)."""
    model = TileScreen().to(device).train()
    optimizer = make_optimizer(model, lr)
    it = 0
    while it < iters:
        for images, targets, _ in dataset.batches(seed=it):
            metrics = screen_step(model, optimizer, images,
                                  targets["gt_mask"])
            it += 1
            if it % log_interval == 0:
                print(f"iter {it}: loss {float(metrics['screen_loss']):.4f} "
                      f"acc {float(metrics['screen_acc']):.3f}", flush=True)
            if it >= iters:
                break
    return model.eval()


def save_screen(model: TileScreen, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(dict(model={"params": module_to_jax_params(model)}), f)
    return path


def main(argv=None):
    """Train and save; returns the trained screen."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="work_dirs/screen.pkl")
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU")
    args = ap.parse_args(argv)

    from ..config import get_cfg, init_cfg
    from ..data import dota as _dota  # noqa: F401  (registers the datasets)
    from ..flagship import resolve_device
    from ..utils.registry import DATASETS, build_from_cfg

    init_cfg(args.config_file)
    dataset = build_from_cfg(get_cfg().dataset.train, DATASETS)
    model = train(dataset, args.iters, args.lr,
                  resolve_device("cpu" if args.cpu else None),
                  args.log_interval)
    save_screen(model, args.out)
    print(f"saved screen checkpoint to {args.out}")
    return model


if __name__ == "__main__":
    main()
