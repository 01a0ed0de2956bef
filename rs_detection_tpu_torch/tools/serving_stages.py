"""Time the stages of one serving request of VAN-b3 Oriented R-CNN
(batch 8, 1024^2 uint8 tiles, bf16, seeded random weights) in its four
serving modes on one CUDA GPU: default, ``fused``, ``int8`` and both.

Run from the repository root:
``python3 -m rs_detection_tpu_torch.tools.serving_stages``. It builds
the kernels, prints the card's name and power limit, then one line per
mode with CUDA-event times in ms (the median of ``REPEATS`` requests
after a warm-up) of: copy + normalize + backbone, the neck, the RPN
forward, ``get_proposals`` and the RoI head's ``predict``. The stages
are the statements of ``OrientedRCNN.predict``, with an event between
them; ``get_proposals`` synchronizes with the host, so its time
includes that wait.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

from ..flagship import build_flagship, normalize

BATCH, TILE, REPEATS = 8, 1024, 5
STAGES = ("normalize+backbone", "neck", "rpn forward", "get_proposals",
          "roi head")


@torch.inference_mode()
def request_ms(model, tiles_u8, dev):
    """CUDA-event times of the stages of one request."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    marks[0].record()
    images = normalize(tiles_u8.to(dev, non_blocking=True))
    feats = model.backbone(images.to(model.compute_dtype))
    marks[1].record()
    pyramid = model.neck(feats)
    marks[2].record()
    rpn_out = model.rpn(pyramid)
    marks[3].record()
    proposals, _, valid = model.rpn.get_proposals(*rpn_out)
    marks[4].record()
    model.bbox_head.predict(pyramid, proposals, valid,
                            torch.ones(BATCH, device=dev))
    marks[5].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("serving_stages: needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rng = torch.Generator().manual_seed(6)
    tiles = [torch.randint(0, 256, (BATCH, TILE, TILE, 3), generator=rng,
                           dtype=torch.uint8) for _ in range(REPEATS + 1)]
    for fused, int8 in ((False, False), (True, False), (False, True),
                        (True, True)):
        model = build_flagship(device=dev, dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(0),
                               fused=fused, int8=int8)
        request_ms(model, tiles[0], dev)      # warm-up
        runs = [request_ms(model, t, dev) for t in tiles[1:]]
        med = [statistics.median(r[i] for r in runs)
               for i in range(len(STAGES))]
        print(f"fused={fused} int8={int8}: " + ", ".join(
            f"{name} {ms:.2f}" for name, ms in zip(STAGES, med))
            + f", sum {sum(med):.2f} ms", flush=True)
        del model


if __name__ == "__main__":
    main()
