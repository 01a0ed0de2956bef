"""Time K3 (the rotated pyramid RoIAlign backward) and K5 (the depthwise
forward) at the shapes of the main path on one CUDA GPU, through the
wrappers of the port found under ``--root`` (default: the checkout that
holds this file), so that two trees can be timed in one call.

Run from anywhere: ``python3 rs_detection_tpu_torch/tools/k3k5_designs.py
[--root DIR] [--ptxas]``. Prints the card's name and power limit, with
``--ptxas`` what ptxas says of each K3 / K5 source under DIR (registers,
spills), then one JSON line of CUDA-event times in ms: K3 at 4096
uniform rois (``uniform_rois``) and at 4096 rois like a training step's
(``step_rois``), bf16, C = 256, over the flagship pyramid (batch 8,
1024^2 tiles); K5 per launch at (k, d) = (5, 1) and (7, 3) on the four
attention shapes of VAN-b3 (batch 8, bf16), with the ``[C, k*k]`` taps
and the bias of the fused half-block, and their sum per fused forward
(each shape weighed by its block count): 20 launches captured in one
CUDA graph (device time), and beside it the plain loop of 20 calls,
which the host's time per call bounds where the kernel is short (the
yardstick of ``chip_smoke.py``'s ``ms``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAGES = [(256, 64, 3), (128, 128, 5), (64, 320, 27), (32, 512, 3)]
BATCH = 8
TILE = 1024
SOURCES = ("roi_align_rotated.cu", "roi_align_rotated_bwd.cu",
           "dw_conv_fwd.cu", "dw_conv_fwd_stream.cu")


def uniform_rois(torch, n, r, img, dev, seed):
    """Rois over every level (sqrt-area 8..900 px), any rotation, centres
    up to 20% past each border: [r, 6] (b, cx, cy, w, h, theta)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi):
        return torch.rand(r, generator=g, device=dev) * (hi - lo) + lo

    scale = torch.exp(u(2.08, 6.8))
    aspect = torch.exp(u(-1.5, 1.5))
    b = torch.randint(0, n, (r,), generator=g, device=dev).float()
    return torch.stack([b, u(-0.2, 1.2) * img, u(-0.2, 1.2) * img,
                        scale * aspect, scale / aspect, u(-3.2, 3.2)], 1)


def step_rois(torch, make_targets, box_iou_rotated, n, img, dev, seed,
              max_gt=42, pos=128, neg=384):
    """Rois like those a training step samples, ``pos + neg`` per tile:
    ``make_targets``' ``max_gt`` ground truths, each added as a proposal
    and the other positives jittered around them (centre up to 8% of the
    sides, sides up to 10%, angle up to 0.08 rad; a jittered box with an
    IoU of 0.5 or less against its ground truth is replaced by the ground
    truth), and ``neg`` negatives with centres in the tile, sides 12-400
    px and any angle. w is inflated by 1.2 and h by 1.4 as the RoI
    extractor does (``extend_factor`` [1.4, 1.2]). Returns the rois [n *
    (pos + neg), 6] and the share of jittered positives replaced."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gts = make_targets(n, img, max_gt, g)["rboxes"]            # [n, max_gt, 5]
    which = torch.arange(pos, device=dev) % max_gt
    base = gts[:, which]                                        # [n, pos, 5]

    def u(*shape, lim):
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * lim

    jit = base.clone()
    jit[..., 0] += u(n, pos, lim=0.08) * base[..., 2]
    jit[..., 1] += u(n, pos, lim=0.08) * base[..., 3]
    jit[..., 2:4] *= torch.exp(u(n, pos, 2, lim=0.1))
    jit[..., 4] += u(n, pos, lim=0.08)
    jit[:, :max_gt] = base[:, :max_gt]
    iou = torch.stack([box_iou_rotated(jit[i], base[i]).diagonal()
                       for i in range(n)])
    bad = iou <= 0.5
    jit = torch.where(bad[..., None], base, jit)
    replaced = bad[:, max_gt:].float().mean().item()

    side = torch.exp(torch.rand(n, neg, 2, generator=g, device=dev)
                     * (math.log(400.0) - math.log(12.0)) + math.log(12.0))
    negs = torch.cat([torch.rand(n, neg, 2, generator=g, device=dev) * img,
                      side, (torch.rand(n, neg, 1, generator=g, device=dev)
                             * 2 - 1) * math.pi], -1)
    boxes = torch.cat([jit, negs], 1)                           # [n, 512, 5]
    boxes[..., 2] *= 1.2
    boxes[..., 3] *= 1.4
    b = torch.arange(n, device=dev, dtype=torch.float32)[:, None, None] \
        .expand(n, pos + neg, 1)
    return torch.cat([b, boxes], -1).reshape(-1, 6).contiguous(), replaced


def cuda_ms(torch, fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches captured in one
    CUDA graph: the host's time per call (checks, planning, ctypes) stays
    out of it where it exceeds the kernel's."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=ROOT)
    parser.add_argument("--ptxas", action="store_true")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3k5_designs: needs a CUDA GPU")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from rs_detection_tpu_torch.flagship import make_targets
    from rs_detection_tpu_torch.ops import _build
    from rs_detection_tpu_torch.ops import dwconv as dw
    from rs_detection_tpu_torch.ops import roi_align as ra
    from rs_detection_tpu_torch.ops.rotated_iou import box_iou_rotated

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{root}: {card}", flush=True)
    if args.ptxas:
        from rs_detection_tpu_torch.tools.fused_block_stages import \
            ptxas_report
        for src in SOURCES:
            if (_build.CSRC / src).exists():
                ptxas_report(src)
    _build.kernel_library()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)
    feats = [torch.randn(BATCH, TILE // s, TILE // s, 256, generator=g,
                         device=dev).to(bf16) for s in (4, 8, 16, 32)]
    out = {"root": root, "card": card, "K3": {}, "K5": {},
           "K5 host-bound loop": {}}
    rois = {"uniform": uniform_rois(torch, BATCH, BATCH * 512, TILE, dev, 8),
            "step": step_rois(torch, make_targets, box_iou_rotated, BATCH,
                              TILE, dev, 20)[0]}
    for name, r in rois.items():
        grad = torch.randn(r.shape[0], 7, 7, 256, generator=g,
                           device=dev).to(bf16)
        out["K3"][name] = cuda_ms(torch, lambda: ra
                                  .roi_align_rotated_pyramid_bwd_cuda(
                                      feats, r, grad), 10)
    del feats
    per_forward = loop_per_forward = 0.0
    for k, d in ((5, 1), (7, 3)):
        for h, c, blocks in STAGES:
            x = torch.randn(BATCH, h, h, c, generator=g, device=dev).to(bf16)
            w = (torch.randn(c, k * k, generator=g, device=dev) / k).to(bf16)
            b = (torch.randn(c, generator=g, device=dev) * 0.1).to(bf16)
            def run():
                return dw.depthwise_conv2d_cuda(x, w, k, d, bias=b,
                                                taps_last=True)
            ms = graph_ms(torch, run, 20)
            loop = cuda_ms(torch, run, 20)
            out["K5"][f"k{k}d{d} [{BATCH},{h},{h},{c}]"] = ms
            out["K5 host-bound loop"][f"k{k}d{d} [{BATCH},{h},{h},{c}]"] = loop
            per_forward += blocks * ms
            loop_per_forward += blocks * loop
    out["K5"]["per fused forward"] = per_forward
    out["K5 host-bound loop"]["per fused forward"] = loop_per_forward
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
