"""Time the port's ``box_iou_rotated`` at the shapes its training paths
give it, on one CUDA GPU, through the module found under ``--root``
(default: the checkout that holds this file), so that two trees can be
timed in one call.

Run from anywhere: ``python3 rs_detection_tpu_torch/tools/
rotated_iou_designs.py [--root DIR]``. Prints the card's name and power
limit, then one JSON line: for each shape the mean CUDA-event ms of a
call over 3 calls after one warm-up, and the peak memory the call adds
above its inputs. The shapes are the rotated-IoU assignments of the
train tasks in ``chip_smoke.py``, each against 512 ground-truth slots
of which 42 hold boxes (the rest zeros, as the loader pads them):
OrientedHead's 2000 proposals and 512 ground truths at batch 8 (phase
24) and at batch 2 (phase 26), the cascade's stage 2 over 512 decoded
rois and the ground truths at batch 2 (phase 33), and S2ANet's target
round over 2 x 87,296 anchors (phase 36), whole where the module blocks
its pairs, and as its first 2048 anchors a tile (one block of 2^21
pairs) on any tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TILE = 1024.0
SLOTS, BOXES = 512, 42
# name: (batch, candidates a tile)
SHAPES = {"phase 24 OrientedHead [8, 2512] x [8, 512]": (8, 2512),
          "phase 26 OrientedHead [2, 2512] x [2, 512]": (2, 2512),
          "phase 33 cascade stage 2 [2, 1024] x [2, 512]": (2, 1024),
          "phase 36 one block [2, 2048] x [2, 512]": (2, 2048),
          "phase 36 target round [2, 87296] x [2, 512]": (2, 87296)}


def obbs(torch, shape, g, dev):
    """Boxes anywhere on the tile, 4-300 px a side, any angle."""
    u = torch.rand(*shape, 5, generator=g, device=dev)
    return torch.stack([u[..., 0] * TILE, u[..., 1] * TILE,
                        4.0 + u[..., 2] * 296.0, 4.0 + u[..., 3] * 296.0,
                        (u[..., 4] - 0.5) * 3.14159], -1)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=ROOT)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("rotated_iou_designs: needs a CUDA GPU")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from rs_detection_tpu_torch.ops import rotated_iou

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{root}: {card}", flush=True)
    blocked = hasattr(rotated_iou, "PAIR_BLOCK")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    out = {"root": root, "card": card, "blocked": blocked}
    for name, (b, n) in SHAPES.items():
        if n * b * SLOTS > 2 ** 26 and not blocked:
            out[name] = None
            continue
        cand = obbs(torch, (b, n), g, dev)
        gts = obbs(torch, (b, SLOTS), g, dev)
        gts[:, BOXES:] = 0.0

        def run():
            return rotated_iou.box_iou_rotated(cand, gts)

        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            run()
        end.record()
        torch.cuda.synchronize()
        out[name] = {"ms": start.elapsed_time(end) / 3,
                     "peak_gib": (torch.cuda.max_memory_allocated() - base)
                     / 2 ** 30}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
