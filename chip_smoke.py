#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rs_detection_tpu_torch``) on one
NVIDIA GPU. Run from the repository root: ``python3 chip_smoke.py``.

Phases, each of which raises (exit code 1) on failure:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off
  2. build: compiles ``rs_detection_tpu_torch/csrc/*.cu`` (nvcc, sm_90a)
  3. K2, the fused VAN MLP kernel, against its plain version at the four
     VAN-b3 stage shapes (batch 8, bf16; the wgmma design), one small
     ragged bf16 shape and one small f32 shape (the FMA kernel); prints
     the first design's time beside each
  4. K1, the rotated pyramid RoIAlign kernel (the row design), against
     its plain version over the flagship pyramid (bf16) on 16000 seeded
     uniform rois, 4096 rois like a training step's and the features and
     rois of one flagship serving request (captured at the RoI
     extractor's call), two launches bit for bit, the roi order kernel
     against its plain buckets, each set's time beside the first
     design's; small rois at C = 40 bf16 (five 16-byte vectors),
     C = 36 bf16 (one channel per lane: the first design) and C = 32 f32
  5. the tiny config's ``predict`` on CUDA (kernels) against the CPU
     (plain versions), f32, same seed
  6. the serving path: VAN-b3 Oriented R-CNN in bf16 with seeded random
     weights serves 10 batches of 8 uint8 1024^2 tiles (normalize on the
     device, ``predict``); checks shapes, finiteness and that every
     forward went through K2 38 times and K1 once
  7. K3, the RoIAlign backward (the destination-ordered design), against
     autograd of the plain forward over the flagship pyramid (bf16) on
     4096 uniform seeded rois and on 4096 rois like a step's (per tile 42
     ground truths, 128 positives around them, 384 negatives), two
     launches bit for bit, small f32 (a 16-byte vector and one channel per
     lane), and K1/K3 adjointness in f32 at the flagship shapes; prints
     the first (atomic) design's times beside it, timed here and before
  8. K6, the depthwise weight gradient, against the plain tap loop at
     the twelve VAN-b3 depthwise shapes of a batch-8 step (bf16, the
     model's layouts: the NHWC and the NCHW design) and one small f32
     shape; prints the first design's time beside each; also times the
     ``dx`` conv in both layouts
  9. the tiny config's training step on CUDA (kernels) against the CPU
     (plain versions), f32, samplers that take every candidate
 10. the training path: one warm-up and 5 timed steps of ``train_step``
     (``OrientedRCNN.loss`` -> backward -> AdamW) on VAN-b3 Oriented
     R-CNN, batch 8, 1024^2, bf16 compute, f32 master weights, seeded
     targets; checks finite losses, nonzero bbox losses, finite nonzero
     gradients and K1 1 / K3 1 / K6 114 launches per step
 11. K5, the depthwise forward kernel, against ``F.conv2d`` at (5,1) and
     (7,3) on the four attention shapes and (3,1) on the four MLP hidden
     shapes (batch 8, bf16, NHWC), its ``[N, H, C, W]`` form (K7's
     layout) at [8, 256, 64, 256], one small odd f32 shape, and ``dx`` /
     ``dw`` of ``depthwise_conv2d`` against autograd of the plain
     version; ragged bf16 shapes at C = 320 and 72 with and without
     bias; times ``F.conv2d`` in NCHW and channels_last and, at the
     attention shapes (the streaming design), the first design beside it,
     each in a loop of calls and in a CUDA graph; K7's form (the
     row-streaming design) beside its first design, the plain version and
     ``F.conv2d`` NCHW, and at ragged bf16 shapes (W = 200, W = 264, C =
     72, H = 37) at (3,1), (5,1), (7,3), (5,2). Then
     the prototype's own path: ``dw_chw`` at (5,1) and (7,3) held
     against the NHWC kernel, transposed
 12. K2r, the residual form of the MLP kernel, against its plain version
     at the four stage shapes (bf16) and one small f32 shape
 13. K4, the fused attention half-block, against its plain version at
     the four stage shapes (bf16; the wgmma design of ``proj1`` and
     ``tail``), small bf16 shapes whose pixel count is no multiple of a
     block's and small f32 shapes (the first design); prints the first
     design's time beside each stage
 14. the tiny config's fused ``predict`` on CUDA (kernels) against the
     CPU (plain versions), and fused against non-fused on CUDA, f32
 15. the fused serving path: as phase 6 with ``build_flagship(fused=
     True)``; every forward must go through K4 38 times, K2r 38 times,
     K5's kernel 76 times (inside K4), K1 once and K2 never
 16. K2q, the int8 form of the MLP kernel, and its residual form against
     their plain version (the kernel's tile group of activation scales)
     at the four stage shapes (bf16; the wgmma design), small ragged
     bf16 shapes and one small odd f32 shape (the first design); prints
     the first design's time beside each and the quantization error
     against the float MLP; the weight-preparation kernel against
     ``qweight`` bit for bit
 17. the integer products of the int8 mode outside the kernel
     (``int_matmul``, ``int_conv2d``) on the card against the CPU, bit
     for bit in their s32 sums, at a stage-3 mix and the FPN 3x3 conv
 18. the tiny config served int8 on CUDA (kernels) against the CPU (plain
     versions, same scale groups), non-fused and fused: the first block
     on one input, the backbone per pyramid level, ``predict``; and the
     int8 backbone against the float one on CUDA
 19. the int8 serving path: as phase 6 with ``build_flagship(int8=
     True)``; every forward must go through K2q 38 times, K1 once and
     K2, K2r, K4 never
 20. the fused int8 serving path (3 requests): K4 38, the residual form
     of K2q 38, K5's kernel 76, K1 once, K2, K2r and K2q's plain form
     never
 21. the runner on the tiny config: a config file (the tiny model as
     ``type=`` dicts, an ``ImageDataset`` over 2 seeded 256^2 tiles,
     ``flip_test``) served by ``Runner(device="cuda").test()`` and
     ``Runner(device="cpu").test()`` from one seed; dense outputs CUDA
     against CPU within phase 5's tolerances, and the CUDA pickle merged
     a second time into identical after-NMS files
 22. the test task at full width: ``run_net --task test`` (its ``main``,
     in this process) on a config that builds on
     ``configs/orcnn_van3_fair1m_1_5.py`` (VAN-b3 in bf16, seeded random
     weights, flip-TTA) over 8 seeded uint8 1024^2 PNG tiles of 2 scenes
     x 4 offsets: checks the results pickle (32 entries, finite), the
     after-NMS files and the FAIR1M-1.5 CSV (rows, fewer than went in)
     and that the 32 forwards launched K2 38 times and K1 once each;
     prints tiles/s of inference, the merge's seconds and the detections
     in and out, then where they go (host data against ``predict`` per
     tile, the merge's stages)
 23. the runner's training on the tiny config: a config file (the tiny
     model, samplers that take every candidate, a ``DOTADataset`` over 4
     seeded 128^2 tiles with a ``labels.pkl``, ``RotatedRandomFlip`` and
     ``RandomRotateAug``, batch 2, the SWA switch after epoch 0: 4 steps)
     run by ``Runner(device="cuda").run()`` and ``Runner(device="cpu")
     .run()`` from one seed: the same rates, losses within phase 9's
     tolerance, parameters within the AdamW bound; and on CUDA 2 steps,
     a save, a resume and 2 more steps against the unbroken run
 24. the train task at full width: ``run_net --task train`` (its
     ``main``, in this process) on ``configs/orcnn_van3_fair1m_1_5.py``
     (VAN-b3, bf16 compute, f32 master weights) over 24 seeded uint8
     1024^2 PNG tiles with a ``labels.pkl`` of 42 boxes each, the
     config's own transforms, batch 8, 8 loader threads, 2 epochs of 3
     steps with the SWA switch after the first and a checkpoint each;
     checks finite losses, nonzero bbox losses, the SWA optimizer's 3
     steps from its schedule's step-0 rate, f32 master weights and K1 1
     / K3 1 / K6 114 / K2 0 launches per step; then ``get_swa_model``
     over epochs 1-2 and ``run_net --task val`` from the average on 8 of
     the tiles (K2 38 and K1 1 in its one forward, 10 class APs and the
     mean, finite); prints the runner's median ms/step beside phase
     10's, the loader's wait and the peak memory
 25. the tiny ResNet config (``tests/test_runner.py:_tiny_cfg``'s
     Resnet18 Oriented R-CNN with the zoo's ``frozen_stages=1``,
     ``norm_eval=True``, samplers that take every candidate): ``predict``
     and two SGD steps on CUDA (K1, K3) against the CPU, f32; checks the
     frozen conv weights decayed and no running statistic moved
 26. the ResNet path at full width: ``run_net --task train`` on
     ``projects/oriented_rcnn/configs/orcnn_r50_fpn_1x_dota.py``
     (ResNet-50, f32 as written, SGD, batch 2) over 12 seeded 1024^2
     tiles with 42 boxes each (6 steps), then ``--task test`` with the
     DOTA merge from its checkpoint over 8 scene tiles; checks losses,
     results and K1 1 / K3 1 launches a step, K1 1 a test forward;
     prints ms/step, peak memory, tiles/s; times K1 on the 4,000 rois of
     one test forward and K3 on the 1,024 of one step (captured at the
     RoI extractor's call) against their plain versions and bounds
 27. EQLv2 at full width: ``run_net --task train`` on
     ``orcnn_r101_fpn_ms_flip_rotate_bc_le90_eqlv2.py`` (ResNet-101,
     ``OrientedEQLv2Head``) for 2 steps at batch 2 (the config's 8, cut:
     printed), then a new ``Runner`` resumes the checkpoint: the EQLv2
     state moved and came back bit for bit
 28. the overfit test on the card (``tests/test_torch_overfit_map.py``):
     200 epochs of the tiny ResNet config on 4 rendered tiles, per-class
     APs at least 0.3, float and int8 (within 0.05), merged detections
     on the scene's ground truth; the trained runner is kept for phase 31
 29. dataset preparation: 2 rendered FAIR scenes of 2872^2 (8-bit RGB
     TIFF, labelXml of 40 rotated objects with FAIR1M-2.0 class names)
     and 1 test scene through ``rs_detection_tpu_torch.tools.preprocess``
     (its ``main``, in this process) on
     ``configs/preprocess/fair1m_1_5_ms.py`` (FAIR -> DOTA, 1024 / 200
     tiles at rates 0.5 / 1.0 / 1.5, the FAIR1M mapping, ``labels.pkl``),
     the resize on the card and then with ``--cpu``: the same tile names,
     byte-equal labelTxt files, equal ``labels.pkl``, pixels equal at
     rate 1.0 and within 1 LSB elsewhere (the share that differs
     printed); 2 steps of ``run_net --task train`` on the tiny config
     read the card's ``labels.pkl`` (finite losses); prints the seconds a
     scene on the card and on the CPU and where they go
 30. raw-scene serving at full width: ``run_net --task test`` on
     ``configs/orcnn_van3_fair1m_1_5.py`` (VAN-b3, bf16, seeded random
     weights) with ``dataset.test`` a ``SceneDataset`` over phase 29's 2
     scenes at rates 0.5 / 1.0 / 1.5, batch 8, no flip: 90 tiles in 12
     forwards, K2 38 and K1 1 launches a forward, the pickle and the
     FAIR1M-1.5 CSV; every tile against the CPU port's tile of the same
     name (f32, 1e-4); prints scene tiles/s beside phase 22's tile-file
     tiles/s, the merge and the peak memory; then the same scenes
     screened by a random-init ``TileScreen`` at ``budget=4``: 24 tiles
     in 3 forwards, ``screen_stats``
 31. the screened scene with phase 28's detector
     (``tests/test_torch_scene.py:check_screened_scene``, the torch form
     of ``tests/test_map_pipeline.py:
     test_screened_scene_serving_end_to_end_map``): a ``TileScreen``
     trained by ``train_screen.train`` on the sparse 384^2 scene's 9
     tiles separates them; ``thresh=0.5`` keeps exactly the 4 occupied
     tiles, gives them the dense run's detections and reproduces the
     dense merged detections above the background tiles' scores;
     ``budget=1`` loses ground-truth matches
Then prints one JSON line of per-kernel results (time, plain time, the
card's bound for the same work, the library call's time where PyTorch
has one; K1's and K3's time on the step-like rois, K1's on a serving
request's, K5's in a CUDA graph; K1's and K2's launches in phase 22's
test task, K1's, K3's and K6's in phase 24's train task, K1's and K2's in
its val task and in phase 30's scene task, ``scene_task_launches``;
K1's and K3's launches in phase 26's tasks and their
times, plain times and bounds at its shapes, ``resnet_*``), the
card's name and power limit, and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
STAGES = [  # (H = W, C, Ch, blocks) of VAN-b3 at 1024^2 tiles
    (256, 64, 512, 3), (128, 128, 1024, 5), (64, 320, 1280, 27),
    (32, 512, 2048, 3)]
BATCH = 8
TILE = 1024
REQUESTS = 10
TRAIN_STEPS = 5
MAX_GT = 42
TRAIN_TASK_TILES = 24  # phase 24: 3 steps of batch 8 an epoch, 2 epochs
RESNET_TILES = 12  # phase 26: 6 steps of batch 2
# kernel vs plain, as max|diff| / max|plain|: bf16 rounds the hidden
# tensor at other points in the two versions (1-2 bf16 ulps, 2^-8 each,
# of the output's largest values); f32 differs only in summation order
REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# K3: f32 sums in another order than the plain backward (the sorted order,
# or atomics in the first design), one rounding to the output dtype on both
# sides (1 bf16 ulp of the largest)
K3_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
# K6: f32 sums over up to 5e5 products, in another order
K6_TOL = {"bfloat16": 2e-3, "float32": 1e-4}
# (k, dilation, H = W, C, blocks, channels_last) of every depthwise conv
# of a VAN-b3 step at 1024^2: dw3 on the MLP hidden tensor, dw5 and the
# dilated 7x7 in the attention (the latter in NCHW, ops/van_attn.py)
# K5 against F.conv2d: both sum the taps in f32 and round once, in another
# order (one bf16 ulp, 2^-8, of the largest values)
K5_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
# K4 against the plain chain, bf16: both round g, d5, d7 and the gated
# product at the same points, but the plain chain also rounds c1, p2, the
# inner shortcut and the layer-scale product, and sums in another order
K4_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# K2q against its plain version: the same scale groups and the same
# arithmetic; the s32 sums are exact and the dequantization is written to be
# bit-equal, so what differs is f32 rounding in the depthwise sum and the
# erf, ~1e-7 relative. A quantizer is a step function: a value that close to
# a rounding boundary lands one int8 step apart on the two sides (about 1e-5
# of the GELU outputs). One step moves an output by at most sg * max|w2|
# (sg = max|g| / 127 of the chunk), some 1e-3 of the largest output. In f32
# that is the whole difference (5e-3 leaves room for a few steps in one
# output). In bf16 it carries an output across a rounding boundary now and
# then: one bf16 ulp of the largest value, at most 2^-7 of it. An output
# sums Ch quantized values, so about Ch * 1e-5 of the outputs see a step at
# all (2% at Ch = 2048): at most INT8_SHARE of the elements may differ by
# more than one bf16 ulp of themselves (in f32: by more than 1e-5 of the
# largest value, 100x the summation noise).
INT8_TOL = {"bfloat16": 1e-2, "float32": 5e-3}
INT8_SHARE = 0.03
# published peaks of one H100 SXM: HBM bytes/s, dense bf16 tensor-core
# FLOP/s, dense int8 tensor-core OP/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_BF16, PEAK_INT8, PEAK_F32 = 3.35e12, 989e12, 1979e12, 67e12
INT8_REQUESTS_FUSED = 3  # timed requests of the fused int8 serving path
# phase 22: 2 scenes of 4 tiles each, at the offsets of a 1024 / 200-overlap
# split of a 1848^2 scene (name__rate__x___y, as the devkits' split writes)
SCENE_OFFSETS = [(0, 0), (824, 0), (0, 824), (824, 824)]
FLIPS = 4  # flip-TTA: none, H, V, HV
# phases 29-30: rendered FAIR scenes, the FAIR1M-1.5 recipe's rates
SCENE_SIDE = 2872
SCENE_OBJECTS = 40
SCENE_RATES = [0.5, 1.0, 1.5]
DW_SHAPES = [(3, 1, h, ch, n, True) for h, _, ch, n in STAGES] \
    + [(5, 1, h, c, n, True) for h, c, _, n in STAGES] \
    + [(7, 3, h, c, n, False) for h, c, _, n in STAGES]
# ms per launch of the kernels' first designs at the same shapes, in the
# order of STAGES and DW_SHAPES: this script on the tree before the
# redesign of K2 / K2r (WMMA, 32-channel chunks) and K6 (one channel per
# lane, scalar staging), and on the tree before that of K2q (WMMA s8) and
# K4's proj1 and tail (WMMA, 64 pixels per block; the four launches of a
# half-block together); K3 (scalar atomics; uniform, step-like rois) and K5
# (a haloed tile per block; (5, 1) then (7, 3) at STAGES, as K4 calls it,
# a loop of calls): rs_detection_tpu_torch/tools/k3k5_designs.py on the
# tree before their redesign. NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
# section 6)
FIRST_DESIGN_MS = {
    "K2": [2.559, 1.779, 1.185, 0.641],
    "K2r": [2.572, 1.769, 1.190, 0.653],
    "K2q": [2.825, 1.868, 1.141, 0.648],
    "K2q residual": [2.847, 1.801, 1.191, 0.621],
    "K4": [1.044, 0.593, 0.587, 0.373],
    "K6": [2.667, 1.357, 0.433, 0.179, 0.565, 0.311, 0.202, 0.077,
           1.331, 0.692, 0.414, 0.137],
    "K3": [7.555, 12.874],
    "K5": [0.140, 0.076, 0.050, 0.037, 0.283, 0.149, 0.104, 0.076],
    # K1 (one block per roi; uniform, step-like, serving rois) and K7's form
    # (the haloed tile; dw5, dw7d3 at [8, 256, 64, 256]):
    # rs_detection_tpu_torch/tools/k1k7_designs.py on the tree before their
    # redesign (serving rois: the same first design, unchanged, through
    # roi_align_rotated_pyramid_first_design)
    "K1": [0.656, 0.252, 0.856],
    "K7": [0.273, 0.737]}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

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


def bound(nbytes, tc_flops=0.0, f32_flops=0.0, int8_ops=0.0):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and each kind of
    operation over its peak rate."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(tc_flops / PEAK_BF16, f32_flops / PEAK_F32,
                int8_ops / PEAK_INT8)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def add_bounds(parts):
    """Bound of work done one part after the other: the times add, and
    the kind is the one that holds the larger share."""
    ms = sum(p[0] for p in parts)
    by_bytes = sum(p[0] for p in parts if p[1] == "bytes")
    return ms, "bytes" if by_bytes >= ms - by_bytes else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, kernel, plain, dtype_name, rel_tol=REL_TOL):
    """Max abs error of ``kernel`` against ``plain`` (tensors or equal
    lists of them); raises past the stated relative tolerance."""
    if isinstance(kernel, (list, tuple)):
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(kernel, plain))
        scale = max(b.float().abs().max().item() for b in plain)
    else:
        err = (kernel.float() - plain.float()).abs().max().item()
        scale = plain.float().abs().max().item()
    tol = rel_tol[dtype_name] * max(scale, 1e-6)
    ok = err <= tol
    log(f"  {name}: max_abs_err {err:.3e}, max|plain| {scale:.3e}, "
        f"tolerance {tol:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def mlp_inputs(torch, g, n, h, w, c, ch, dt):
    """Seeded VAN MLP operands on the generator's device."""
    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=g.device) * scale).to(dt)
    return (r(n, h, w, c), r(ch, c, scale=c ** -0.5), r(ch, scale=0.1),
            r(ch, 9, scale=1 / 3), r(ch, scale=0.1),
            r(c, ch, scale=ch ** -0.5), r(c, scale=0.1))


def phase_k2(torch, van_mlp_cuda, van_mlp_reference, dev, name="K2"):
    """The MLP kernel (``name`` K2) or its residual form (K2r) against
    its plain version; returns (max error, kernel ms, plain ms, bound)
    per forward, each shape weighed by its block count."""
    g = torch.Generator(device=dev).manual_seed(1)

    def inputs(n, h, c, ch, dt):
        return mlp_inputs(torch, g, n, h, h, c, ch, dt)

    err_max, ms, plain_ms, bounds = 0.0, 0.0, 0.0, []
    for (h, c, ch, blocks), first in zip(STAGES, FIRST_DESIGN_MS[name]):
        args = inputs(BATCH, h, c, ch, torch.bfloat16)
        err = compare(f"{name} [{BATCH},{h},{h},{c}] Ch={ch} bf16",
                      van_mlp_cuda(*args), van_mlp_reference(*args),
                      "bfloat16")
        t_plain = cuda_ms(lambda: van_mlp_reference(*args), 5)
        t_kernel = cuda_ms(lambda: van_mlp_cuda(*args), 5)
        pixels = BATCH * h * h
        # x and the weights read, y written; two 1x1 convs on the tensor
        # cores, the 3x3 taps in f32
        b = bound(nbytes(*args) + nbytes(args[0]), 4.0 * pixels * c * ch,
                  18.0 * pixels * ch)
        log(f"    kernel {t_kernel:.3f} ms (first design {first:.3f}), plain "
            f"{t_plain:.3f} ms, bound {b[0]:.3f} ms by {b[1]} (x{blocks} "
            f"blocks per forward)")
        err_max = max(err_max, err)
        ms += blocks * t_kernel
        plain_ms += blocks * t_plain
        bounds += [b] * blocks
        del args
    # H and W no multiples of the tile, a partial last hidden chunk
    args = mlp_inputs(torch, g, 2, 21, 19, 320, 200, torch.bfloat16)
    compare(f"{name} [2,21,19,320] Ch=200 bf16", van_mlp_cuda(*args),
            van_mlp_reference(*args), "bfloat16")
    args = inputs(2, 21, 32, 96, torch.float32)
    compare(f"{name} [2,21,21,32] Ch=96 f32", van_mlp_cuda(*args),
            van_mlp_reference(*args), "float32")
    b = add_bounds(bounds)
    first = sum(s[3] * t for s, t in zip(STAGES, FIRST_DESIGN_MS[name]))
    log(f"  {name} per forward: kernel {ms:.3f} ms (first design "
        f"{first:.3f}), plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms by "
        f"{b[1]}")
    return err_max, ms, plain_ms, b


def compare_int8(torch, name, kernel, plain, fp, dtype_name):
    """K2q against its plain version, by INT8_TOL and INT8_SHARE; also
    prints its distance from the float MLP ``fp``, the quantization
    error itself. Returns the max abs error against the plain version."""
    k, p = kernel.float(), plain.float()
    diff = (k - p).abs()
    scale = p.abs().max().item()
    err = diff.max().item()
    if dtype_name == "bfloat16":  # |v| = m * 2^e, m in [0.5, 1): ulp 2^(e-8)
        ulp = torch.ldexp(torch.ones_like(p), torch.frexp(
            p.abs().clamp(min=1e-3 * scale)).exponent - 8)
    else:
        ulp = torch.full_like(p, 1e-5 * scale)
    share = (diff > ulp).float().mean().item()
    qerr = (k - fp.float()).abs().max().item() / fp.float().abs().max().item()
    tol = INT8_TOL[dtype_name] * max(scale, 1e-6)
    ok = err <= tol and share <= INT8_SHARE and math.isfinite(err)
    log(f"  {name}: max_abs_err {err:.3e}, max|plain| {scale:.3e}, tolerance "
        f"{tol:.3e}; {100 * share:.3f}% of the elements differ by more than "
        f"one ulp (limit {100 * INT8_SHARE:.0f}%); {100 * qerr:.2f}% of the "
        f"largest value from the float MLP -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    if not 1e-3 < qerr < 5e-2:
        raise AssertionError(f"{name}: {qerr:.3e} from the float MLP is not "
                             f"an int8 quantization error")
    return err


def phase_k2q(torch, vm, dev, residual):
    """K2q (or, with ``residual``, its residual form) against the plain
    version with the kernel's scale groups; returns (max error, kernel
    ms, plain ms, bound) per forward, each shape weighed by its block
    count. The kernel's time includes its per-call weight preparation
    (quantize and pack, a kernel of its own)."""
    g = torch.Generator(device=dev).manual_seed(17)
    if residual:
        name, kernel = "K2q residual", vm.van_mlp_residual_int8_cuda
        plain, fp = (vm.van_mlp_residual_int8_reference,
                     vm.van_mlp_residual_reference)
    else:
        name, kernel = "K2q", vm.van_mlp_int8_cuda
        plain, fp = vm.van_mlp_int8_reference, vm.van_mlp_reference
    err_max, ms, plain_ms, bounds = 0.0, 0.0, 0.0, []
    for (h, c, ch, blocks), first in zip(STAGES, FIRST_DESIGN_MS[name]):
        args = mlp_inputs(torch, g, BATCH, h, h, c, ch, torch.bfloat16)
        if vm.kernel_plan(c, ch, torch.bfloat16, int8=True)["design"] \
                != "wgmma":
            raise AssertionError(f"{name}: C={c} does not pick the wgmma "
                                 f"design")
        err = compare_int8(torch, f"{name} [{BATCH},{h},{h},{c}] Ch={ch} bf16",
                           kernel(*args), plain(*args), fp(*args), "bfloat16")
        t_plain = cuda_ms(lambda: plain(*args), 3)
        t_kernel = cuda_ms(lambda: kernel(*args), 5)
        pixels = BATCH * h * h
        # x and the float weights read, y written; two 1x1 products in
        # int8 on the tensor cores, the 3x3 taps in f32
        b = bound(nbytes(*args) + nbytes(args[0]), 0.0, 18.0 * pixels * ch,
                  4.0 * pixels * c * ch)
        log(f"    kernel {t_kernel:.3f} ms (first design {first:.3f}), plain "
            f"{t_plain:.3f} ms, bound {b[0]:.3f} ms by {b[1]} (x{blocks} "
            f"blocks per forward)")
        err_max = max(err_max, err)
        ms += blocks * t_kernel
        plain_ms += blocks * t_plain
        bounds += [b] * blocks
        del args
    # H and W no multiples of the tile (border tiles, the zero padding) and
    # a partial last round of hidden channels, at widths the wgmma design
    # takes; then the first design in f32
    for c, ch in ((320, 200), (64, 100)):
        args = mlp_inputs(torch, g, 2, 21, 19, c, ch, torch.bfloat16)
        compare_int8(torch, f"{name} [2,21,19,{c}] Ch={ch} bf16",
                     kernel(*args), plain(*args), fp(*args), "bfloat16")
    args = mlp_inputs(torch, g, 2, 21, 19, 32, 96, torch.float32)
    compare_int8(torch, f"{name} [2,21,19,32] Ch=96 f32", kernel(*args),
                 plain(*args), fp(*args), "float32")
    b = add_bounds(bounds)
    first = sum(s[3] * t for s, t in zip(STAGES, FIRST_DESIGN_MS[name]))
    log(f"  {name} per forward: kernel {ms:.3f} ms (first design "
        f"{first:.3f}), plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms by "
        f"{b[1]}")
    return err_max, ms, plain_ms, b


def phase_k2q_pack(torch, vm, quant, lib, dev):
    """The weight preparation of K2q's wgmma design (quantize per output
    channel and pack into the kernel's shared-memory bytes, one kernel)
    against ``qweight``, bit for bit: its bytes equal the Python version's
    (``pack_int8_weights``), and unpacked they give ``qweight``'s s8
    values and scales back."""
    g = torch.Generator(device=dev).manual_seed(19)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = [(c, ch) for _, c, ch, _ in STAGES] + [(320, 200), (64, 100)]
    for c, ch in shapes:
        _, w1, b1, wdw, bdw, w2, _ = mlp_inputs(torch, g, 1, 8, 8, c, ch,
                                                torch.bfloat16)
        want = vm.pack_int8_weights(w1, b1, wdw, bdw, w2)
        got = torch.empty_like(want)
        err = lib.rs_van_mlp_int8_pack(
            w1.data_ptr(), b1.data_ptr(), wdw.data_ptr(), bdw.data_ptr(),
            w2.data_ptr(), got.data_ptr(), c, ch, 1, stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"K2q pack C={c} Ch={ch}: CUDA error {err}")
        w1q, sw1, w2q, sw2 = vm.unpack_int8_weights(got, c, ch)
        (q1, s1), (q2, s2) = quant.qweight(w1, 0), quant.qweight(w2, 0)
        same = torch.equal(got, want) and all(
            torch.equal(a, b) for a, b in ((w1q, q1), (sw1, s1), (w2q, q2),
                                           (sw2, s2)))
        log(f"  K2q weight preparation C={c} Ch={ch}: {got.numel()} packed "
            f"bytes, equal to the Python version and to qweight -> "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"K2q pack C={c} Ch={ch} differs from "
                                 f"qweight")


def phase_int_products(torch, quant, dev):
    """``int_matmul`` and ``int_conv2d`` on the card against the CPU: the
    s8 operands and the s32 sums bit for bit, at the mix of a stage-3
    attention ([8*64*64, 320] x [320, 320]) and the FPN 3x3 conv at 256
    channels on [4, 128, 128] (the flagship's is [8, 256, 256], cut to
    what the CPU sums in seconds); then the dequantized outputs."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(18)
    bf16 = torch.bfloat16

    def same(what, a, b):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{what}: CUDA and CPU differ")

    x = torch.randn(BATCH * 64 * 64, 320, generator=g).to(bf16)
    w = (torch.randn(320, 320, generator=g) * 320 ** -0.5).to(bf16)
    bias = (torch.randn(320, generator=g) * 0.1).to(bf16)
    (xq, sx), (wq, sw) = quant.qact(x), quant.qweight(w)
    (xq_d, sx_d), (wq_d, sw_d) = quant.qact(x.to(dev)), quant.qweight(
        w.to(dev))
    for what, a, b in (("qact values", xq, xq_d), ("qact scale", sx, sx_d),
                       ("qweight values", wq, wq_d),
                       ("qweight scales", sw, sw_d)):
        same(what, a, b)
    acc = quant.int_matmul(xq, wq.t())
    same("int_matmul s32 sums", acc, quant.int_matmul(xq_d, wq_d.t()))
    y = quant.int8_channel_matmul(x, w, bias)
    y_d = quant.int8_channel_matmul(x.to(dev), w.to(dev), bias.to(dev))
    err = (y.float() - y_d.cpu().float()).abs().max().item()
    log(f"  int8_channel_matmul {list(x.shape)} x [320, 320]: s8 operands "
        f"and s32 sums (|sum| up to {acc.abs().max().item()}) bit-equal on "
        f"CUDA and CPU; outputs differ by {err:.3e}")
    if err != 0.0:
        raise AssertionError("int8_channel_matmul: outputs differ")

    x = torch.randn(4, 256, 128, 128, generator=g).to(bf16) \
        .contiguous(memory_format=torch.channels_last)
    w = (torch.randn(256, 256, 3, 3, generator=g) / 48).to(bf16)
    bias = (torch.randn(256, generator=g) * 0.1).to(bf16)
    xq, wq = quant.qact(x.permute(0, 2, 3, 1))[0], quant.qweight(w)[0]
    for stride in (1, 2):
        acc = quant.int_conv2d(xq, wq, (stride, stride), (1, 1))
        same(f"int_conv2d stride {stride} s32 sums", acc, quant.int_conv2d(
            xq.to(dev), wq.to(dev), (stride, stride), (1, 1)))
        # the tap sum itself against the library's integer conv on the CPU
        ref = F.conv2d(xq[:1, :32, :32].permute(0, 3, 1, 2).int(), wq.int(),
                       None, stride, 1).permute(0, 2, 3, 1)
        same(f"int_conv2d stride {stride} against F.conv2d on int32",
             quant.int_conv2d(xq[:1, :32, :32].to(dev), wq.to(dev),
                              (stride, stride), (1, 1)), ref)
    y = quant.int8_conv(x, w, bias, (1, 1), (1, 1))
    y_d = quant.int8_conv(x.to(dev), w.to(dev), bias.to(dev), (1, 1), (1, 1))
    err = (y.float() - y_d.cpu().float()).abs().max().item()
    xd, wd, bd = x.to(dev), w.to(dev), bias.to(dev)
    t_int8 = cuda_ms(lambda: quant.int8_conv(xd, wd, bd, (1, 1), (1, 1)), 3)
    t_fp = cuda_ms(lambda: F.conv2d(xd, wd, bd, 1, 1), 3)
    log(f"  int8_conv 3x3 [4,128,128,256] -> 256, strides 1 and 2: s32 sums "
        f"(|sum| up to {acc.abs().max().item()}) bit-equal on CUDA and CPU "
        f"and equal to F.conv2d on int32; outputs differ by {err:.3e}; "
        f"int8_conv {t_int8:.3f} ms, F.conv2d bf16 {t_fp:.3f} ms")
    if err != 0.0:
        raise AssertionError("int8_conv: outputs differ")


def phase_k1(torch, ra, build_flagship, normalize, dev):
    """K1 against its plain version and its first design on the same
    inputs: 16000 uniform rois (the yardstick of the records), 4096 rois like
    a training step's and the features and rois of one serving request,
    bf16 over the flagship pyramid; two launches bit for bit; a ragged
    width, one channel per lane and small f32. Returns (max error, ms,
    plain ms, bound) on the uniform rois, and the ms on the other two
    sets."""
    from rs_detection_tpu_torch.flagship import make_targets
    from rs_detection_tpu_torch.ops import _build
    from rs_detection_tpu_torch.ops.rotated_iou import box_iou_rotated
    from rs_detection_tpu_torch.tools.k1k7_designs import serving_rois
    from rs_detection_tpu_torch.tools.k3k5_designs import (step_rois,
                                                           uniform_rois)

    g = torch.Generator(device=dev).manual_seed(2)
    sizes = [TILE // s for s in (4, 8, 16, 32)]
    feats = [torch.randn(BATCH, s, s, 256, generator=g, device=dev)
             .to(torch.bfloat16) for s in sizes]
    sets = {"uniform": (feats, uniform_rois(torch, BATCH, BATCH * 2000, TILE,
                                            dev, 3)),
            "step-like": (feats, step_rois(torch, make_targets,
                                           box_iou_rotated, BATCH, TILE, dev,
                                           20, max_gt=MAX_GT)[0]),
            "serving": serving_rois(torch, build_flagship, normalize, dev)}
    results = {}
    for (name, (fs, rois)), before in zip(sets.items(),
                                          FIRST_DESIGN_MS["K1"]):
        sizes = [f.shape[1:3] for f in fs]
        plan = ra.k1_plan(fs[0].shape[-1], fs[0].dtype, rois=rois.shape[0],
                          buckets=ra.k1_bucket_count(fs[0].shape[0], sizes))
        if plan["design"] != "rows":
            raise AssertionError(f"K1 {name}: the plan picks {plan}")
        if plan["sort"]:  # the order kernel against its plain buckets
            order = ra._k1_order(
                _build.kernel_library(), fs, fs[0].shape[0],
                [v for hw in sizes for v in hw], [4.0, 8.0, 16.0, 32.0],
                rois, 56.0, torch.cuda.current_stream().cuda_stream)
            bucket = ra.k1_buckets(fs, rois)[0]
            ok = torch.equal(order.sort().values, torch.arange(
                rois.shape[0], device=dev)) \
                and bool((bucket[order].diff() >= 0).all())
            log(f"  K1 {name}: the order is a permutation, bucket by bucket "
                f"({ra.k1_bucket_count(fs[0].shape[0], sizes)} buckets) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {name}: the order kernel disagrees "
                                     f"with k1_buckets")
        got = ra.roi_align_rotated_pyramid_cuda(fs, rois)
        err = compare(f"K1 {rois.shape[0]} {name} rois, C=256, bf16 (row "
                      f"design)", got, ra.roi_align_rotated_pyramid_reference(
                          fs, rois), "bfloat16")
        same = torch.equal(got, ra.roi_align_rotated_pyramid_cuda(fs, rois))
        log(f"  K1 {name}: two launches bit-identical -> "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"K1 {name}: two launches differ")
        compare(f"K1 first design, {name} rois",
                ra.roi_align_rotated_pyramid_first_design(fs, rois),
                ra.roi_align_rotated_pyramid_reference(fs, rois), "bfloat16")
        t_plain = cuda_ms(lambda: ra.roi_align_rotated_pyramid_reference(
            fs, rois), 3)
        t_kernel = cuda_ms(lambda: ra.roi_align_rotated_pyramid_cuda(
            fs, rois), 10)
        t_first = cuda_ms(lambda: ra.roi_align_rotated_pyramid_first_design(
            fs, rois), 10)
        # 4 samples per bin, 4 corners each, a multiply-add per channel
        b = bound(nbytes(*fs, rois, got), 0.0, 32.0 * got.numel())
        lvl = ra.map_roi_levels(rois[:, 3], rois[:, 4], 4)
        log(f"    kernel {t_kernel:.3f} ms (first design {t_first:.3f} ms "
            f"here, {before:.3f} before), plain {t_plain:.3f} ms, bound "
            f"{b[0]:.3f} ms by {b[1]}; rois per level "
            f"{torch.bincount(lvl, minlength=4).tolist()}")
        results[name] = (err, t_kernel, t_plain, b)
        del got
    del sets
    small = [torch.randn(2, s, s, 40, generator=g, device=dev)
             for s in (64, 32, 16, 8)]
    small_rois = uniform_rois(torch, 2, 500, 256, dev, 4)
    # C = 40 bf16: five 16-byte vectors, lanes 5-31 idle (row design);
    # C = 36 bf16: one channel per lane (first design); f32 at C = 32 (row
    # design, 4 channels a lane)
    for c, dt in ((40, torch.bfloat16), (36, torch.bfloat16),
                  (32, torch.float32)):
        fs = [f[..., :c].to(dt).contiguous() for f in small]
        design = ra.k1_plan(c, dt, rois=500)["design"]
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        compare(f"K1 500 rois, C={c}, {name} ({design} design)",
                ra.roi_align_rotated_pyramid_cuda(fs, small_rois),
                ra.roi_align_rotated_pyramid_reference(fs, small_rois), name)
    return results["uniform"], results["step-like"][1], \
        results["serving"][1]


def phase_slice(torch, build_flagship, normalize, dev, fused=False):
    """The tiny config's predict, CUDA (kernels) against the CPU (plain
    versions); with ``fused`` also fused against non-fused on CUDA."""
    g = torch.Generator().manual_seed(5)
    tiles = torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    cpu = build_flagship(tiny=True, device="cpu", fused=fused).predict(
        normalize(tiles))
    gpu = build_flagship(tiny=True, device=dev, fused=fused).predict(
        normalize(tiles.to(dev)))
    pairs = [("CUDA vs CPU", gpu, cpu)]
    if fused:
        pairs.append(("fused vs non-fused on CUDA", gpu, build_flagship(
            tiny=True, device=dev).predict(normalize(tiles.to(dev)))))
    for what, got, ref in pairs:
        if not torch.equal(got["valid"].cpu(), ref["valid"].cpu()):
            raise AssertionError(f"tiny config, {what}: valid masks differ")
        # f32 with TF32 off on both: cuDNN/cuBLAS, CPU and kernel
        # summation orders (and the folds of the fused mode)
        for key, atol in (("polys", 1e-2), ("scores", 1e-5)):
            err = (got[key].cpu() - ref[key].cpu()).abs().max().item()
            log(f"  tiny predict, {what}, {key}: max_abs_err {err:.3e} "
                f"(atol {atol})")
            if not err <= atol:
                raise AssertionError(f"tiny config, {what}: {key} differ "
                                     f"by {err}")


def phase_slice_int8(torch, build_flagship, normalize, dev, fused):
    """The tiny config served int8, CUDA (kernels) against the CPU (plain
    versions with the kernels' scale groups), f32.

    An int8 step that the two devices' f32 noise sets off (a value
    within ~1e-7 of a rounding boundary) moves its neighbourhood by
    ~1e-3 of the tensor's largest value, which sets off further steps in
    the next layer, so after a few blocks the two runs carry independent
    quantization noise and agree only as closely as int8 agrees with
    float. So: the first block on one input, where steps are still rare
    (at most 2% of the elements off by more than 1e-5 of the largest
    value, none by more than 4 steps of 1/127); the whole backbone, CUDA
    against CPU, within relative difference 0.05 and correlation 0.999
    per level, and int8 against float on CUDA within the JAX package's
    own bound (0.15, 0.995; tests/test_int8_serving.py); ``predict``
    without regard to rank (that noise reorders near-tied proposals):
    the count of valid slots within 2%, per class the sorted scores
    within 0.05."""
    g = torch.Generator().manual_seed(5)
    tiles = torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    images = normalize(tiles)
    cpu = build_flagship(tiny=True, device="cpu", fused=fused, int8=True)
    gpu = build_flagship(tiny=True, device=dev, fused=fused, int8=True)
    fp = build_flagship(tiny=True, device=dev, fused=fused)
    mode = "fused int8" if fused else "int8"
    with torch.no_grad():
        stem = cpu.backbone.patch_embed1(images.permute(0, 3, 1, 2))
        ref = cpu.backbone.block1_0(stem)
        got = gpu.backbone.block1_0(stem.to(dev)).cpu()
        diff, scale = (got - ref).abs(), ref.abs().max().item()
        share = (diff > 1e-5 * scale).float().mean().item()
        log(f"  tiny {mode}, first block on one input, CUDA vs CPU: "
            f"max_abs_err {diff.max().item():.3e} (limit "
            f"{4 * scale / 127:.3e}), {100 * share:.3f}% of the elements "
            f"off by more than 1e-5 of the largest (limit 2%)")
        if not (diff.max().item() <= 4 * scale / 127 and share <= 0.02):
            raise AssertionError(f"tiny {mode}: first block differs")
        feats = {"CPU": cpu.backbone(images),
                 "CUDA": [f.cpu() for f in gpu.backbone(images.to(dev))],
                 "float": [f.cpu() for f in fp.backbone(images.to(dev))]}
    for what, other, max_rel, min_corr in (("CUDA vs CPU", "CPU", 0.05, 0.999),
                                           ("int8 vs float on CUDA", "float",
                                            0.15, 0.995)):
        for lvl, (q, r) in enumerate(zip(feats["CUDA"], feats[other])):
            rel = ((q - r).abs().max() / r.abs().max()).item()
            corr = torch.corrcoef(torch.stack(
                [r.flatten(), q.flatten()]))[0, 1].item()
            log(f"  tiny {mode} backbone, {what}, level {lvl}: relative "
                f"difference {rel:.5f} (< {max_rel}), correlation "
                f"{corr:.6f} (> {min_corr})")
            if not (rel < max_rel and corr > min_corr):
                raise AssertionError(f"tiny {mode} backbone, {what}, differs")
    out_cpu = cpu.predict(images)
    out_gpu = gpu.predict(images.to(dev))
    n_cpu, n_gpu = int(out_cpu["valid"].sum()), int(out_gpu["valid"].sum())
    err = (out_gpu["scores"].cpu().sort(dim=1).values
           - out_cpu["scores"].sort(dim=1).values).abs().max().item()
    log(f"  tiny {mode} predict, CUDA vs CPU: {n_gpu} and {n_cpu} valid "
        f"slots, sorted scores per class differ by {err:.3e} (limit 0.05)")
    if abs(n_cpu - n_gpu) > out_cpu["valid"].numel() // 50 or not err <= 0.05:
        raise AssertionError(f"tiny {mode} predict differs")


def phase_main(torch, build_flagship, normalize, kernels, dev, card,
               fused=False, int8=False, n_requests=REQUESTS):
    """The serving path at full width; ``kernels`` maps names to the
    wrappers whose launches count. Returns the launches of the timed
    requests, tiles/s, peak memory in GiB and the median request in ms."""
    model = build_flagship(tiny=False, device=dev, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0),
                           fused=fused, int8=int8)
    rng = torch.Generator().manual_seed(6)
    requests = [torch.randint(0, 256, (BATCH, TILE, TILE, 3), generator=rng,
                              dtype=torch.uint8)
                for _ in range(n_requests + 1)]

    def serve(tiles_u8):
        return model.predict(normalize(tiles_u8.to(dev, non_blocking=True)))

    serve(requests[0])  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in kernels.values():
        fn.launches = 0
    outs, times = [], []
    for tiles in requests[1:]:
        t0 = time.perf_counter()
        outs.append(serve(tiles))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = sum(times)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    n_blocks = sum(s[3] for s in STAGES)
    per_forward = dict.fromkeys(kernels, 0)
    per_forward["roi_align_rotated_pyramid"] = 1
    mlp = "van_mlp" + ("_residual" if fused else "") + ("_int8" if int8
                                                         else "")
    per_forward[mlp] = n_blocks
    if fused:  # K4 runs K5's kernel twice (dw5, dilated dw7)
        per_forward.update(van_attn=n_blocks, depthwise_conv2d=2 * n_blocks)
    want = {k: v * n_requests for k, v in per_forward.items()}
    if launches != want:
        raise AssertionError(f"main path kernel launches {launches}, "
                             f"expected {want}")
    for out in outs:
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        want = {"polys": (BATCH, 2000, 8), "scores": (BATCH, 2000, 10),
                "valid": (BATCH, 2000)}
        if shapes != want:
            raise AssertionError(f"main path output shapes {shapes}")
        if not (torch.isfinite(out["polys"]).all()
                and torch.isfinite(out["scores"]).all()):
            raise AssertionError("main path outputs are not finite")
        if not ((out["scores"] >= 0) & (out["scores"] <= 1)).all():
            raise AssertionError("main path scores outside [0, 1]")
    valid = sum(int(o["valid"].sum()) for o in outs)
    tiles_s = n_requests * BATCH / dt
    times.sort()
    mode = ("fused VAN blocks" if fused else "non-fused VAN blocks") + (
        ", int8 serving mode" if int8 else "")
    log(f"  VAN-b3 Oriented R-CNN bf16, {mode}: {n_requests} requests of "
        f"{BATCH}x{TILE}^2 uint8 tiles in {dt:.3f} s = {tiles_s:.2f} tiles/s "
        f"(request ms min {1e3 * times[0]:.1f}, median "
        f"{1e3 * times[len(times) // 2]:.1f}, max {1e3 * times[-1]:.1f}), "
        f"peak memory {peak / 2**30:.2f} GiB, {valid} valid detection "
        f"slots [{card}]")
    log(f"  launches in the timed requests: {launches}")
    return launches, tiles_s, peak / 2**30, 1e3 * times[len(times) // 2]


def phase_k3(torch, ra, dev):
    """K3 against the plain backward (autograd of the plain forward) on
    uniform rois and on rois like a step's, its first (atomic) design on
    the same inputs, two launches bit for bit, and <K1(f), g> == <f,
    K3(g)>. Returns (max error, ms, plain ms, bound) on the uniform rois,
    the yardstick of earlier runs, and the ms on the step-like rois."""
    from rs_detection_tpu_torch.flagship import make_targets
    from rs_detection_tpu_torch.ops.rotated_iou import box_iou_rotated
    from rs_detection_tpu_torch.tools.k3k5_designs import (step_rois,
                                                           uniform_rois)

    g = torch.Generator(device=dev).manual_seed(7)
    sizes = [TILE // s for s in (4, 8, 16, 32)]
    feats32 = [torch.randn(BATCH, s, s, 256, generator=g, device=dev)
               for s in sizes]
    feats = [f.to(torch.bfloat16) for f in feats32]
    step, replaced = step_rois(torch, make_targets, box_iou_rotated, BATCH,
                               TILE, dev, 20, max_gt=MAX_GT)
    log(f"  step-like rois: per tile {MAX_GT} ground truths, 128 positives "
        f"(IoU > 0.5; {100 * replaced:.1f}% of the jittered ones set back to "
        f"their ground truth), 384 negatives")
    sets = {"uniform": uniform_rois(torch, BATCH, BATCH * 512, TILE, dev, 8),
            "step-like": step}
    err_max, times = 0.0, {}
    for (name, rois), before in zip(sets.items(), FIRST_DESIGN_MS["K3"]):
        grad = torch.randn(rois.shape[0], 7, 7, 256, generator=g,
                           device=dev).to(torch.bfloat16)
        got = ra.roi_align_rotated_pyramid_bwd_cuda(feats, rois, grad)
        plain = ra.roi_align_rotated_pyramid_bwd_reference(feats, rois, grad)
        err = compare(f"K3 {rois.shape[0]} {name} rois, C=256, bf16", got,
                      plain, "bfloat16", K3_TOL)
        again = ra.roi_align_rotated_pyramid_bwd_cuda(feats, rois, grad)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"  K3 {name}: two launches bit-identical -> "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"K3 {name}: two launches differ")
        compare(f"K3 first design (atomics) {name} rois",
                ra.roi_align_rotated_pyramid_bwd_first_design(feats, rois,
                                                              grad),
                plain, "bfloat16", K3_TOL)
        del got, again, plain
        t_plain = cuda_ms(lambda: ra.roi_align_rotated_pyramid_bwd_reference(
            feats, rois, grad), 3)
        t_kernel = cuda_ms(lambda: ra.roi_align_rotated_pyramid_bwd_cuda(
            feats, rois, grad), 10)
        t_first = cuda_ms(
            lambda: ra.roi_align_rotated_pyramid_bwd_first_design(
                feats, rois, grad), 10)
        # the gradient and the rois read, the pyramid's gradient written; 4
        # samples per bin, 4 corners each, a multiply-add per channel
        b = bound(nbytes(grad, rois, *feats), 0.0, 32.0 * grad.numel())
        log(f"    kernel {t_kernel:.3f} ms (first design {t_first:.3f} ms "
            f"here, {before:.3f} before), plain {t_plain:.3f} ms, bound "
            f"{b[0]:.3f} ms by {b[1]}")
        err_max = max(err_max, err)
        times[name] = (t_kernel, t_plain)
    small = [torch.randn(2, s, s, 32, generator=g, device=dev)
             for s in (64, 32, 16, 8)]
    small_rois = uniform_rois(torch, 2, 500, 256, dev, 9)
    for c in (32, 30):  # a 16-byte vector, then one channel per lane
        small_g = torch.randn(500, 7, 7, c, generator=g, device=dev)
        feats_c = [f[..., :c].contiguous() for f in small]
        compare(f"K3 500 rois, C={c}, f32 ({ra.k3_vec(c, torch.float32)} "
                f"channels per lane)",
                ra.roi_align_rotated_pyramid_bwd_cuda(feats_c, small_rois,
                                                      small_g),
                ra.roi_align_rotated_pyramid_bwd_reference(
                    feats_c, small_rois, small_g), "float32", K3_TOL)
    grad32 = grad.float()
    lhs = (ra.roi_align_rotated_pyramid_cuda(feats32, rois).double()
           * grad32.double()).sum().item()
    rhs = sum((f.double() * d.double()).sum().item() for f, d in zip(
        feats32, ra.roi_align_rotated_pyramid_bwd_cuda(feats32, rois,
                                                       grad32)))
    rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
    log(f"  K1/K3 adjointness, f32, step-like rois: <K1 f, g> {lhs:.6e}, "
        f"<f, K3 g> {rhs:.6e}, relative difference {rel:.2e} (tolerance "
        f"1e-5)")
    if not rel <= 1e-5:
        raise AssertionError("K3 is not the adjoint of K1")
    return (err_max, *times["uniform"], b), times["step-like"][0]


def phase_k6(torch, dwc, dev):
    """K6 against the tap loop at the VAN-b3 shapes, in the model's
    layouts; per-step totals weigh each shape by its block count. Also
    the ``dx`` conv (flipped-kernel depthwise conv) in both layouts."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(10)
    err_max, ms, plain_ms, lib_ms, bounds = 0.0, 0.0, 0.0, 0.0, []
    for (k, d, h, c, blocks, cl), first in zip(DW_SHAPES,
                                               FIRST_DESIGN_MS["K6"]):
        fmt = torch.channels_last if cl else torch.contiguous_format

        def r():
            return torch.randn(BATCH, c, h, h, generator=g, device=dev) \
                .to(torch.bfloat16).contiguous(memory_format=fmt)

        x, gr = r(), r()
        layout = "NHWC" if cl else "NCHW"
        err = compare(f"K6 k{k}d{d} [{BATCH},{h},{h},{c}] {layout} bf16",
                      dwc.dw_wgrad_cuda(x, gr, k, d),
                      dwc.dw_wgrad_reference(x, gr, k, d), "bfloat16",
                      K6_TOL)
        t_plain = cuda_ms(lambda: dwc.dw_wgrad_reference(x, gr, k, d), 2)
        t_kernel = cuda_ms(lambda: dwc.dw_wgrad_cuda(x, gr, k, d), 20)
        w = torch.randn(c, 1, k, k, generator=g, device=dev) \
            .to(torch.bfloat16)
        t_lib = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
            x, w.shape, gr, padding=d * (k - 1) // 2, dilation=d, groups=c),
            2)
        b = bound(nbytes(x, gr) + 4 * k * k * c, 0.0,
                  2.0 * k * k * x.numel())
        dx_ms = {}
        for name, f in (("NHWC", torch.channels_last),
                        ("NCHW", torch.contiguous_format)):
            gf = gr.contiguous(memory_format=f)
            dx_ms[name] = cuda_ms(lambda: F.conv2d(
                gf, w.flip((2, 3)), padding=d * (k - 1) // 2, dilation=d,
                groups=c), 5)
        log(f"    kernel {t_kernel:.3f} ms (first design {first:.3f}), plain "
            f"{t_plain:.3f} ms, conv2d_weight {t_lib:.3f} ms, bound {b[0]:.3f} ms by {b[1]} "
            f"(x{blocks} blocks per step); dx conv NHWC "
            f"{dx_ms['NHWC']:.3f} ms, NCHW {dx_ms['NCHW']:.3f} ms")
        err_max = max(err_max, err)
        ms += blocks * t_kernel
        plain_ms += blocks * t_plain
        lib_ms += blocks * t_lib
        bounds += [b] * blocks
        del x, gr
    x = torch.randn(2, 40, 37, 45, generator=g, device=dev)
    gr = torch.randn(2, 40, 37, 45, generator=g, device=dev)
    compare("K6 k7d3 [2,37,45,40] f32", dwc.dw_wgrad_cuda(x, gr, 7, 3),
            dwc.dw_wgrad_reference(x, gr, 7, 3), "float32", K6_TOL)
    x, gr = (t.contiguous(memory_format=torch.channels_last) for t in (x, gr))
    compare("K6 k7d3 [2,37,45,40] NHWC f32", dwc.dw_wgrad_cuda(x, gr, 7, 3),
            dwc.dw_wgrad_reference(x, gr, 7, 3), "float32", K6_TOL)
    b = add_bounds(bounds)
    first = sum(s[4] * t for s, t in zip(DW_SHAPES, FIRST_DESIGN_MS["K6"]))
    log(f"  K6 per step: kernel {ms:.3f} ms (first design {first:.3f}), "
        f"plain {plain_ms:.3f} ms, conv2d_weight {lib_ms:.3f} ms, bound {b[0]:.3f} ms by {b[1]}")
    return err_max, ms, plain_ms, b, lib_ms


def phase_k5(torch, dw, dev):
    """K5 against ``F.conv2d`` (groups = C). Totals are per fused
    forward: the 5x5 and the dilated 7x7 of each of the 38 attention
    half-blocks. Returns (max error, kernel ms, plain ms, bound, library
    ms) for the NHWC form, with its ms in a CUDA graph last, and for K7's
    ``[N, H, C, W]`` form. Every kernel ms is a loop of calls, as for the
    other kernels; at the attention shapes both designs are also timed in
    a CUDA graph, since at stage 4 a launch takes less card time than its
    wrapper takes host time."""
    import torch.nn.functional as F

    from rs_detection_tpu_torch.tools.k3k5_designs import graph_ms

    g = torch.Generator(device=dev).manual_seed(13)
    bf16 = torch.bfloat16

    def r(*s, scale=1.0, dt=bf16):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dt)

    def dw_bound(x, k):
        return bound(2 * nbytes(x) + x.element_size() * k * k * x.shape[-1],
                     0.0, 2.0 * k * k * x.numel())

    err_max, ms, plain_ms, bounds = 0.0, 0.0, 0.0, []
    graph_total = first_ms = first_graph_ms = before_ms = 0.0
    lib_ms = {"channels_last": 0.0, "NCHW": 0.0}
    shapes = [(5, 1, h, c, n, True) for h, c, _, n in STAGES] \
        + [(7, 3, h, c, n, True) for h, c, _, n in STAGES] \
        + [(3, 1, h, ch, n, False) for h, _, ch, n in STAGES]
    before = iter(FIRST_DESIGN_MS["K5"])
    for k, d, h, c, blocks, on_path in shapes:
        x = r(BATCH, h, h, c)
        pad = d * (k - 1) // 2
        design = dw.dw_plan(k, d, h, h, c, bf16, n=BATCH)["design"]
        if design != ("stream" if on_path else "first"):
            raise AssertionError(f"K5 k{k}d{d} C={c} picks the {design} "
                                 f"design")
        if on_path:  # as K4 calls it: nn.Conv2d's [C, k*k] taps, a bias
            wt, bias = r(c, k * k, scale=1.0 / k), r(c, scale=0.1)
            w = wt.t().reshape(k, k, c)
            args = dict(bias=bias, taps_last=True)
        else:
            w, bias = r(k, k, c, scale=1.0 / k), None
            wt, args = w, {}

        def kernel():
            return dw.depthwise_conv2d_cuda(x, wt, k, d, **args)

        def plain():
            y = dw.depthwise_conv2d_reference(x, w, k, d)
            return y if bias is None else y + bias

        err = compare(f"K5 k{k}d{d} [{BATCH},{h},{h},{c}] NHWC bf16 "
                      f"({design} design)", kernel(), plain(), "bfloat16",
                      K5_TOL)
        def first_design():
            return dw.depthwise_conv2d_first_design(x, wt, k, d, **args)

        t_plain = cuda_ms(plain, 3)
        t_kernel = cuda_ms(kernel, 20)
        t_graph = graph_ms(torch, kernel, 20)
        first = f" (in a CUDA graph {t_graph:.3f} ms"
        if on_path:
            t_first = cuda_ms(first_design, 20)
            t_first_graph = graph_ms(torch, first_design, 20)
            t_before = next(before)
            first += (f"; first design {t_first:.3f} ms here, "
                      f"{t_first_graph:.3f} in a CUDA graph, {t_before:.3f} "
                      f"before")
            graph_total += blocks * t_graph
            first_ms += blocks * t_first
            first_graph_ms += blocks * t_first_graph
            before_ms += blocks * t_before
        first += ")"
        # the library call, on the same memory (channels_last) and after
        # a copy to NCHW (the copy is not timed)
        wl = w.permute(2, 0, 1).reshape(c, 1, k, k).contiguous()
        t_lib = {}
        for name, xl in (("channels_last", x.permute(0, 3, 1, 2)),
                         ("NCHW", x.permute(0, 3, 1, 2).contiguous())):
            t_lib[name] = cuda_ms(lambda: F.conv2d(
                xl, wl, bias, padding=pad, dilation=d, groups=c), 3)
        b = dw_bound(x, k)
        log(f"    kernel {t_kernel:.3f} ms{first}, plain {t_plain:.3f} ms, "
            f"F.conv2d channels_last {t_lib['channels_last']:.3f} ms, NCHW "
            f"{t_lib['NCHW']:.3f} ms, bound {b[0]:.3f} ms by {b[1]}"
            + (f" (x{blocks} blocks per fused forward)" if on_path else ""))
        err_max = max(err_max, err)
        if on_path:
            ms += blocks * t_kernel
            plain_ms += blocks * t_plain
            for name in lib_ms:
                lib_ms[name] += blocks * t_lib[name]
            bounds += [b] * blocks
        del x
    # the streaming design at H and W no multiples of its strip or rows,
    # C = 320 (five channel chunks) and 72 (a partial last chunk), the
    # fused block's taps and bias
    for k, d in ((5, 1), (7, 3)):
        for c in (320, 72):
            x = r(2, 37, 45, c)
            w = r(c, k * k, scale=1.0 / k)
            bias = r(c, scale=0.1)
            wl = w.reshape(c, 1, k, k)
            if dw.dw_plan(k, d, 37, 45, c, bf16, n=2)["design"] != "stream":
                raise AssertionError(f"K5 k{k}d{d} C={c} does not stream")
            for b_ in (None, bias):
                ref = F.conv2d(x.permute(0, 3, 1, 2), wl, b_,
                               padding=d * (k - 1) // 2, dilation=d,
                               groups=c).permute(0, 2, 3, 1)
                compare(f"K5 k{k}d{d} [2,37,45,{c}] bf16 "
                        f"{'with' if b_ is not None else 'without'} bias "
                        f"(stream design)",
                        dw.depthwise_conv2d_cuda(x, w, k, d, bias=b_,
                                                 taps_last=True),
                        ref, "bfloat16", K5_TOL)
    nhwc = (err_max, ms, plain_ms, add_bounds(bounds),
            lib_ms["channels_last"], graph_total)
    log(f"  K5 per fused forward (76 launches): kernel {ms:.3f} ms in a loop "
        f"of calls, {graph_total:.3f} in a CUDA graph (first design "
        f"{first_ms:.3f} ms here, {first_graph_ms:.3f} in a CUDA graph, "
        f"{before_ms:.3f} before), plain {plain_ms:.3f} ms, F.conv2d "
        f"channels_last "
        f"{lib_ms['channels_last']:.3f} ms, NCHW {lib_ms['NCHW']:.3f} ms "
        f"(after a layout copy), bound {nhwc[3][0]:.3f} ms by {nhwc[3][1]}")

    # K7's layout at the prototype's shape: the row-streaming design beside
    # the first design, the plain version and F.conv2d on NCHW
    err_max, ms, plain_ms, lib_ms, bounds = 0.0, 0.0, 0.0, 0.0, []
    first_ms = before_ms = 0.0
    for (k, d), before in zip(((5, 1), (7, 3)), FIRST_DESIGN_MS["K7"]):
        x, wts = r(BATCH, 256, 64, 256), r(64, k * k, scale=1.0 / k)
        plan = dw.dw_plan(k, d, 256, 256, 64, bf16, n=BATCH, hcw=True)
        if plan["design"] != "chw":
            raise AssertionError(f"K7 form k{k}d{d}: the plan picks {plan}")
        plain = dw.dw_chw_reference(x, wts, k, d)
        err_max = max(err_max, compare(
            f"K7 form k{k}d{d} [{BATCH},256,64,256] bf16 (row-streaming "
            f"design, {plan['segs']} segments)", dw.dw_chw_cuda(x, wts, k, d),
            plain, "bfloat16", K5_TOL))
        compare(f"K7 form k{k}d{d}, first design",
                dw.dw_chw_first_design(x, wts, k, d), plain, "bfloat16",
                K5_TOL)
        t_plain = cuda_ms(lambda: dw.dw_chw_reference(x, wts, k, d), 3)
        t_kernel = cuda_ms(lambda: dw.dw_chw_cuda(x, wts, k, d), 20)
        t_first = cuda_ms(lambda: dw.dw_chw_first_design(x, wts, k, d), 20)
        xl = x.permute(0, 2, 1, 3).contiguous()
        t_lib = cuda_ms(lambda: F.conv2d(
            xl, wts.reshape(64, 1, k, k), padding=d * (k - 1) // 2,
            dilation=d, groups=64), 3)
        b = bound(2 * nbytes(x) + nbytes(wts), 0.0, 2.0 * k * k * x.numel())
        log(f"    kernel {t_kernel:.3f} ms (first design {t_first:.3f} ms "
            f"here, {before:.3f} before), plain {t_plain:.3f} ms, F.conv2d "
            f"NCHW {t_lib:.3f} ms, bound {b[0]:.3f} ms by {b[1]}")
        ms += t_kernel
        plain_ms += t_plain
        lib_ms += t_lib
        first_ms += t_first
        before_ms += before
        bounds.append(b)
        del x, plain
    log(f"  K7 form, dw5 + dw7d3: kernel {ms:.3f} ms (first design "
        f"{first_ms:.3f} ms here, {before_ms:.3f} before), plain "
        f"{plain_ms:.3f} ms, F.conv2d NCHW {lib_ms:.3f} ms")
    # ragged bf16 shapes of the row-streaming design: W short of a strip,
    # W over one strip (264: a second strip of one lane), C = 72, H = 37
    for shape in ((2, 37, 64, 200), (2, 40, 64, 264), (2, 64, 72, 256),
                  (2, 37, 72, 264)):
        for k, d in ((3, 1), (5, 1), (7, 3), (5, 2)):
            x = r(*shape)
            c = shape[2]
            wts = r(c, k * k, scale=1.0 / k)
            n_, h_, _, w_ = shape
            if dw.dw_plan(k, d, h_, w_, c, bf16, n=n_,
                          hcw=True)["design"] != "chw":
                raise AssertionError(f"K7 form k{k}d{d} {shape} does not "
                                     f"stream rows")
            compare(f"K7 form k{k}d{d} {list(shape)} bf16 (row-streaming "
                    f"design)", dw.dw_chw_cuda(x, wts, k, d),
                    dw.dw_chw_reference(x, wts, k, d), "bfloat16", K5_TOL)
    chw = (err_max, ms, plain_ms, add_bounds(bounds), lib_ms)

    # small f32, odd sizes and a ragged channel tile; both gradients
    f32 = torch.float32
    x, w = r(2, 37, 45, 40, dt=f32), r(7, 7, 40, scale=1 / 7, dt=f32)
    compare("K5 k7d3 [2,37,45,40] f32", dw.depthwise_conv2d_cuda(x, w, 7, 3),
            dw.depthwise_conv2d_reference(x, w, 7, 3), "float32", K5_TOL)
    xc = x.permute(0, 1, 3, 2).contiguous()
    wc = w.reshape(49, 40).t().contiguous()
    compare("K7 form k7d3 [2,37,40,45] f32", dw.dw_chw_cuda(xc, wc, 7, 3),
            dw.dw_chw_reference(xc, wc, 7, 3), "float32", K5_TOL)
    gr = r(2, 37, 45, 40, dt=f32)
    grads = []
    for fn in (dw.depthwise_conv2d, dw.depthwise_conv2d_reference):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(xg, wg, 7, 3), (xg, wg), gr))
    compare("depthwise_conv2d dx (K5 on the flipped taps), f32", grads[0][0],
            grads[1][0], "float32", K5_TOL)
    compare("depthwise_conv2d dw (K6), f32", grads[0][1], grads[1][1],
            "float32", K6_TOL)
    return nhwc, chw


def phase_k7_path(torch, dw, dev):
    """The prototype's own path (``chw_dw_proto.py:main``): ``dw_chw`` at
    [8, 256, 64, 256] for dw5 and dw7 dilation 3, held against the NHWC
    op on the transposed input. Returns its launches."""
    g = torch.Generator(device=dev).manual_seed(14)
    x_nhwc = torch.randn(BATCH, 256, 256, 64, generator=g,
                         device=dev).to(torch.bfloat16)
    x_chw = x_nhwc.permute(0, 1, 3, 2).contiguous()
    dw.dw_chw_cuda.launches = 0
    outs = []
    for k, d in ((5, 1), (7, 3)):
        wts = (torch.randn(64, k * k, generator=g, device=dev) * 0.1) \
            .to(torch.bfloat16)
        outs.append((k, d, wts, dw.dw_chw(x_chw, wts, k, d)))
    launches = dw.dw_chw_cuda.launches
    torch.cuda.synchronize()
    for k, d, wts, y in outs:
        ref = dw.depthwise_conv2d(x_nhwc, wts.t().reshape(k, k, 64)
                                  .contiguous(), k, d)
        compare(f"dw_chw k{k}d{d} vs the NHWC op", y.permute(0, 1, 3, 2),
                ref, "bfloat16", K5_TOL)
    if launches != 2:
        raise AssertionError(f"dw_chw launched its kernel {launches} times")
    return launches


def phase_k4(torch, va, dev):
    """K4 against its plain version; returns (max error, kernel ms, plain
    ms, bound) per forward, each stage weighed by its block count."""
    g = torch.Generator(device=dev).manual_seed(15)

    def inputs(n, h, w, c, dt):
        def r(*s, scale=1.0, t=dt):
            return (torch.randn(*s, generator=g, device=dev) * scale).to(t)
        f32 = torch.float32
        mix = c ** -0.5
        return (r(n, h, w, c, scale=0.5), 1 + r(c, scale=0.1, t=f32),
                r(c, scale=0.1, t=f32), r(c, c, 1, 1, scale=mix),
                r(c, scale=0.1), r(c, 1, 5, 5, scale=0.2), r(c, scale=0.1),
                r(c, 1, 7, 7, scale=1 / 7), r(c, scale=0.1),
                r(c, c, 1, 1, scale=mix), r(c, scale=0.1),
                r(c, c, 1, 1, scale=mix), r(c, scale=0.1), r(c, scale=0.3))

    err_max, ms, plain_ms, bounds = 0.0, 0.0, 0.0, []
    for (h, c, _, blocks), first in zip(STAGES, FIRST_DESIGN_MS["K4"]):
        args = inputs(BATCH, h, h, c, torch.bfloat16)
        if va.attn_plan(c, torch.bfloat16)["design"] != "wgmma":
            raise AssertionError(f"K4: C={c} does not pick the wgmma design")
        err = compare(f"K4 [{BATCH},{h},{h},{c}] bf16",
                      va.van_attn_cuda(*args), va.van_attn_reference(*args),
                      "bfloat16", K4_TOL)
        t_plain = cuda_ms(lambda: va.van_attn_reference(*args), 5)
        t_kernel = cuda_ms(lambda: va.van_attn_cuda(*args), 20)
        pixels = BATCH * h * h
        # x and the weights read, out written; three C x C products on
        # the tensor cores, 25 + 49 taps in f32
        b = bound(nbytes(*args) + nbytes(args[0]), 6.0 * pixels * c * c,
                  2.0 * 74 * pixels * c)
        log(f"    kernel {t_kernel:.3f} ms (4 launches; first design "
            f"{first:.3f}), plain {t_plain:.3f} ms, bound {b[0]:.3f} ms by "
            f"{b[1]} (x{blocks} blocks per forward)")
        err_max = max(err_max, err)
        ms += blocks * t_kernel
        plain_ms += blocks * t_plain
        bounds += [b] * blocks
        del args
    # pixel counts that are no multiple of a block's 128 (64 in tail at
    # C = 512), at widths the wgmma design takes
    for shape in ((1, 13, 11, 64), (2, 9, 7, 320), (1, 15, 13, 512)):
        args = inputs(*shape, torch.bfloat16)
        compare(f"K4 {list(shape)} bf16", va.van_attn_cuda(*args),
                va.van_attn_reference(*args), "bfloat16", K4_TOL)
    for shape in ((1, 13, 16, 32), (2, 24, 20, 32), (2, 9, 7, 40)):
        args = inputs(*shape, torch.float32)
        compare(f"K4 {list(shape)} f32", va.van_attn_cuda(*args),
                va.van_attn_reference(*args), "float32", K4_TOL)
    first = sum(s[3] * t for s, t in zip(STAGES, FIRST_DESIGN_MS["K4"]))
    log(f"  K4 per forward: kernel {ms:.3f} ms (first design {first:.3f}), "
        f"plain {plain_ms:.3f} ms")
    return err_max, ms, plain_ms, add_bounds(bounds)


def _before_bn(name):
    """Conv biases that feed a BatchNorm: the batch mean removes them,
    so their gradient is zero up to rounding."""
    return name.startswith("backbone.patch_embed") and name.endswith(
        "proj.bias")


def phase_train_tiny(torch, build_flagship, make_targets, train_mod, dev):
    """The tiny config's training step on CUDA against the CPU, f32,
    TF32 off, every candidate sampled (the two devices draw different
    random numbers)."""
    from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import AdamW

    rng = torch.Generator().manual_seed(11)
    images = torch.randn(2, 64, 64, 3, generator=rng)
    targets = make_targets(2, 64, 6, rng)
    # axis-aligned ground truths: sin/cos differ in the last ulp between
    # the CPU and CUDA, and the RPN's low-quality rescue keeps every
    # anchor that ties a ground truth's best IoU, so one ulp can change
    # the sampled set (rotated boxes still reach the head as proposals)
    targets["rboxes"][..., 4] = 0.0
    out = {}
    for device in ("cpu", dev):
        model = build_flagship(tiny=True, device=device, train=True)
        model.rpn.sampler = RandomSampler(num=4096, pos_fraction=1.0)
        model.bbox_head.sampler = RandomSampler(num=64 + 6, pos_fraction=1.0)
        opt = AdamW(model.parameters(), grad_clip=dict(max_norm=35))
        losses = train_mod.train_step(
            model, opt, StepLR([7, 10]), images.to(device),
            {k: v.to(device) for k, v in targets.items()},
            torch.Generator(device=device).manual_seed(0), epoch=0)
        out[str(device)] = ({k: float(v) for k, v in losses.items()},
                            {k: p.grad.cpu() for k, p in
                             model.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out[str(dev)]
    for k, v in l_cpu.items():
        rel = abs(l_gpu[k] - v) / max(abs(v), 1e-6)
        log(f"  tiny train {k}: CPU {v:.6f}, CUDA {l_gpu[k]:.6f}, "
            f"relative {rel:.2e} (tolerance 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError(f"tiny train: {k} differs")
    worst = 0.0
    for k, a in g_cpu.items():
        if _before_bn(k):
            continue
        scale = max(a.abs().max().item(), g_gpu[k].abs().max().item(), 1e-12)
        worst = max(worst, (g_gpu[k] - a).abs().max().item() / scale)
    log(f"  tiny train gradients: worst scaled max error {worst:.2e} "
        f"(tolerance 1e-3) over {len(g_cpu)} parameters")
    if not worst <= 1e-3:
        raise AssertionError("tiny train: gradients differ")


def phase_train(torch, build_flagship, make_targets, normalize, train_mod,
                kernels, dev, card):
    """The training path at full width: 1 warm-up + TRAIN_STEPS timed
    steps; ``kernels`` maps names to the wrappers whose launches count."""
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import AdamW

    model = build_flagship(tiny=False, device=dev, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0),
                           train=True)
    opt = AdamW(model.parameters(), lr=1e-4, weight_decay=0.05,
                grad_clip=dict(max_norm=35))
    sched = StepLR([7, 10], warmup="linear", warmup_iters=500,
                   warmup_ratio=1.0 / 3)
    gen = torch.Generator(device=dev).manual_seed(12)
    tiles = torch.randint(0, 256, (BATCH, TILE, TILE, 3), generator=gen,
                          device=dev, dtype=torch.uint8)
    images = normalize(tiles)
    targets = make_targets(BATCH, TILE, MAX_GT, gen)

    def step():
        return train_mod.train_step(model, opt, sched, images, targets, gen,
                                    epoch=0)

    step()  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in kernels.values():
        fn.launches = 0
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"van_mlp": 0, "roi_align_rotated_pyramid": TRAIN_STEPS,
            "roi_align_rotated_pyramid_bwd": TRAIN_STEPS,
            "dw_wgrad": 3 * sum(s[3] for s in STAGES) * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"training path kernel launches {launches}, "
                             f"expected {want}")
    for ls in losses:
        vals = {k: float(v) for k, v in ls.items()}
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"training losses not finite: {vals}")
        if not (vals["loss_rpn_bbox"] > 0 and vals["orcnn_bbox_loss"] > 0):
            raise AssertionError(f"a bbox loss is zero: {vals}")
    bad = [k for k, p in model.named_parameters() if not _before_bn(k) and (
        p.grad is None or not torch.isfinite(p.grad).all()
        or not p.grad.abs().max() > 0)]
    if bad:
        raise AssertionError(f"parameters without a finite nonzero "
                             f"gradient: {bad}")
    dt = sum(times) / len(times)
    times.sort()
    first, last = losses[0], losses[-1]
    log(f"  VAN-b3 Oriented R-CNN train step, batch {BATCH}, {TILE}^2, bf16 "
        f"compute, f32 master weights: {1e3 * dt:.1f} ms/step (min "
        f"{1e3 * times[0]:.1f}, max {1e3 * times[-1]:.1f}) = "
        f"{BATCH / dt:.2f} tiles/s, peak memory {peak / 2**30:.2f} GiB "
        f"[{card}]")
    log("  losses, first and last timed step: " + ", ".join(
        f"{k} {float(first[k]):.4f} -> {float(last[k]):.4f}" for k in first))
    log(f"  launches in the {TRAIN_STEPS} timed steps: {launches}")
    return launches, 1e3 * times[len(times) // 2]


def write_tiles(tiles_dir, names, size, seed):
    """Seeded uint8 RGB tiles as PNG files."""
    import numpy as np
    from PIL import Image

    os.makedirs(tiles_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in names:
        Image.fromarray(rng.randint(0, 256, (size, size, 3)).astype(
            np.uint8)).save(os.path.join(tiles_dir, name))


def render_fair_split(split_dir, names, size, n_objects, seed, xml=True):
    """Seeded raw scenes in the FAIR1M layout: ``images/<name>.tif``
    (8-bit RGB TIFF) and, with ``xml``, ``labelXml/<name>.xml`` with
    ``n_objects`` rotated rectangles a scene, drawn on it as
    ``tests/test_map_pipeline.py:render_dataset`` draws them, under
    FAIR1M-2.0 fine class names. Also used by the CPU tests."""
    import numpy as np
    from PIL import Image

    from rs_detection_tpu_torch.config.constant import FAIR_CLASSES

    os.makedirs(os.path.join(split_dir, "images"), exist_ok=True)
    if xml:
        os.makedirs(os.path.join(split_dir, "labelXml"), exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in names:
        img = np.full((size, size, 3), 60, np.uint8)
        img += (rng.rand(size, size, 3) * 20).astype(np.uint8)
        objects = []
        for _ in range(n_objects):
            cx, cy = rng.uniform(0.05 * size, 0.95 * size, 2)
            w, h = rng.uniform(0.02, 0.1) * size, rng.uniform(0.01, 0.03) * size
            th = rng.uniform(-1.2, 1.2)
            c, s = math.cos(th), math.sin(th)
            r = math.hypot(w, h) / 2 + 1
            x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, size)
            y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, size)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            u = (xx - cx) * c + (yy - cy) * s
            v = -(xx - cx) * s + (yy - cy) * c
            img[y0:y1, x0:x1][(np.abs(u) < w / 2) & (np.abs(v) < h / 2)] = \
                rng.randint(120, 256, 3)
            pts = [(cx + a * c - b * s, cy + a * s + b * c) for a, b in
                   ((-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2),
                    (-w / 2, h / 2))]
            objects.append((FAIR_CLASSES[rng.randint(len(FAIR_CLASSES))],
                            pts + pts[:1]))
        Image.fromarray(img).save(os.path.join(split_dir, "images",
                                               name + ".tif"))
        if not xml:
            continue
        with open(os.path.join(split_dir, "labelXml", name + ".xml"),
                  "w") as f:
            f.write(f"<annotation><source><filename>{name}.tif</filename>"
                    f"</source><objects>")
            for cls, pts in objects:
                f.write("<object><coordinate>pixel</coordinate><type>"
                        "rectangle</type><possibleresult><name>"
                        f"{cls}</name><probability>1</probability>"
                        "</possibleresult><points>"
                        + "".join(f"<point>{x:.6f},{y:.6f}</point>"
                                  for x, y in pts)
                        + "</points></object>")
            f.write("</objects></annotation>\n")


def write_config(path, **entries):
    """A ``.py`` config file of ``name = value`` lines."""
    with open(path, "w") as f:
        for k, v in entries.items():
            f.write(f"{k} = {v!r}\n")
    return path


def read_rows(paths):
    rows = 0
    for p in paths:
        with open(p) as f:
            rows += sum(1 for line in f if line.strip())
    return rows


def phase_runner_tiny(torch, dev, tmp):
    """The tiny config through the runner, CUDA (kernels) against the CPU
    (plain versions)."""
    import numpy as np

    from rs_detection_tpu_torch.config import get_cfg, init_cfg, update_cfg
    from rs_detection_tpu_torch.data.devkits.data_merge import \
        data_merge_result
    from rs_detection_tpu_torch.flagship import (PIXEL_MEAN, PIXEL_STD,
                                                 flagship_cfg)
    from rs_detection_tpu_torch.runner import Runner

    tiles = os.path.join(tmp, "tiny_tiles")
    write_tiles(tiles, ["S0__1.0__0___0.png", "S0__1.0__200___0.png"], 256,
                21)
    cfg = write_config(
        os.path.join(tmp, "tiny_runner.py"), seed=5, flip_test=True,
        model=flagship_cfg(tiny=True),
        dataset=dict(test=dict(
            type="ImageDataset", images_dir=tiles, dataset_type="FAIR1M_1_5",
            batch_size=1, transforms=[
                dict(type="RotatedResize", min_size=256, max_size=256),
                dict(type="Pad", size_divisor=32),
                dict(type="Normalize", mean=list(PIXEL_MEAN),
                     std=list(PIXEL_STD), to_bgr=False)])),
        optimizer=dict(type="AdamW", lr=1e-4, weight_decay=0.05),
        merge_cfg=dict(dataset_type="FAIR1M_1_5"))
    runners, cwd = {}, os.getcwd()
    try:
        for name, device in (("cuda", dev), ("cpu", "cpu")):
            init_cfg(cfg)
            update_cfg({"work_dir": os.path.join(tmp, name, "work")})
            os.makedirs(os.path.join(tmp, name))
            os.chdir(os.path.join(tmp, name))
            runners[name] = Runner(device=device)
            runners[name].test(flip_test=bool(get_cfg().flip_test))
        err = {"polys": 0.0, "scores": 0.0}
        for mode in (None, "H", "V", "HV"):
            for images, targets, _ in runners["cpu"].test_dataset.batches(
                    mode):
                got = runners["cuda"].predict(images, targets)
                ref = runners["cpu"].predict(images, targets)
                if not (got["valid"] == ref["valid"]).all():
                    raise AssertionError(f"tiny runner, flip {mode}: valid "
                                         f"masks differ")
                for key in err:
                    err[key] = max(err[key], float(
                        np.abs(got[key] - ref[key]).max()))
        for key, atol in (("polys", 1e-2), ("scores", 1e-5)):
            log(f"  tiny runner test, CUDA vs CPU, 2 tiles x 4 flips, {key}: "
                f"max_abs_err {err[key]:.3e} (atol {atol})")
            if not err[key] <= atol:
                raise AssertionError(f"tiny runner: {key} differ by "
                                     f"{err[key]}")
        pkl = os.path.join(tmp, "cuda", "work", "test", "test_0.pkl")
        again = os.path.join(tmp, "merge_again")
        os.makedirs(again)
        os.chdir(again)
        data_merge_result(pkl, again, 0, "tiny_runner",
                          dataset_type="FAIR1M_1_5")
    finally:
        os.chdir(cwd)
    a = os.path.join(tmp, "cuda", "work", "test", "submit_0", "after_nms")
    b = os.path.join(again, "test", "submit_0", "after_nms")
    names = sorted(os.listdir(a))
    same = names == sorted(os.listdir(b)) and all(
        open(os.path.join(a, n), "rb").read()
        == open(os.path.join(b, n), "rb").read() for n in names)
    log(f"  the CUDA pickle merged twice: {len(names)} after-NMS files, "
        f"{read_rows(os.path.join(a, n) for n in names)} rows, identical: "
        f"{same}")
    if not same or not names:
        raise AssertionError("tiny runner: merges of one pickle differ")


def phase_run_net(torch, tmp, kernels, card):
    """``run_net --task test`` at full width, the wrappers' launches
    counted over the whole task; returns them and the tiles/s of
    inference."""
    import pickle

    import numpy as np

    from rs_detection_tpu_torch.tools import run_net

    tiles = os.path.join(tmp, "tiles")
    names = [f"S{k}__1.0__{x}___{y}.png" for k in range(2)
             for x, y in SCENE_OFFSETS]
    write_tiles(tiles, names, TILE, 22)
    base = os.path.join(ROOT, "configs", "orcnn_van3_fair1m_1_5.py")
    work = os.path.join(tmp, "work")
    cfg = write_config(
        os.path.join(tmp, "orcnn_van3_fair1m_1_5_chip.py"), _base_=base,
        model=dict(compute_dtype="bfloat16"),
        dataset=dict(test=dict(images_dir=tiles), train=None, val=None),
        allow_random_init=True, merge_cfg=dict(dataset_type="FAIR1M_1_5"),
        work_dir=work)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        runner = run_net.main(["--config-file", cfg, "--task", "test"])
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
    finally:
        os.chdir(cwd)
    stats = runner.test_stats
    forwards = len(names) * FLIPS
    n_blocks = sum(st[3] for st in STAGES)
    want = dict.fromkeys(kernels, 0)
    want.update(van_mlp=n_blocks * forwards,
                roi_align_rotated_pyramid=forwards)
    if launches != want:
        raise AssertionError(f"test task kernel launches {launches}, "
                             f"expected {want}")
    with open(os.path.join(work, "test", "test_0.pkl"), "rb") as f:
        results = pickle.load(f)
    if len(results) != forwards or stats["tiles"] != forwards:
        raise AssertionError(f"test task: {len(results)} results for "
                             f"{forwards} forwards")
    n_in = 0
    for (polys, scores, labels), meta in results:
        if not (np.isfinite(polys).all() and np.isfinite(scores).all()
                and polys.shape == (len(scores), 8)
                and ((labels >= 1) & (labels <= 10)).all()):
            raise AssertionError(f"test task: bad detections for {meta}")
        n_in += len(scores)
    after = os.path.join(work, "test", "submit_0", "after_nms")
    n_out = read_rows(os.path.join(after, n) for n in os.listdir(after))
    csv = os.path.join(tmp, "submit_zips", "orcnn_van3_fair1m_1_5_chip.csv")
    n_csv = read_rows([csv])
    if not (0 < n_out == n_csv < n_in) or n_in != stats["detections"]:
        raise AssertionError(f"test task: {n_in} detections in, {n_out} "
                             f"after NMS, {n_csv} CSV rows")
    log(f"  run_net --task test, VAN-b3 Oriented R-CNN bf16 from "
        f"configs/orcnn_van3_fair1m_1_5.py: {len(names)} tiles of "
        f"{TILE}^2 x {FLIPS} flips = {forwards} forwards at batch 1 in "
        f"{stats['inference_s']:.3f} s = {forwards / stats['inference_s']:.2f}"
        f" tiles/s of inference (decode, transforms, H2D, predict, "
        f"threshold); merge {stats['merge_s']:.3f} s; detections {n_in} in, "
        f"{n_out} out after NMS ({len(os.listdir(after))} class files, "
        f"{n_csv} CSV rows); whole task {wall:.1f} s [{card}]")
    log(f"  launches in the test task: {launches}")
    phase_run_net_breakdown(runner, work, tmp, card)
    return launches, forwards / stats["inference_s"]


def phase_run_net_breakdown(runner, work, tmp, card):
    """Where the test task's seconds go: one unflipped pass over the
    tiles with the host data (decode, transforms, collate) and ``predict``
    timed apart, then the merge's stages on the task's pickle."""
    from rs_detection_tpu_torch.config import get_classes_by_name
    from rs_detection_tpu_torch.data.devkits.data_merge import prepare_data
    from rs_detection_tpu_torch.data.devkits.result_merge import mergebypoly

    t0 = time.perf_counter()
    batches = list(runner.test_dataset.batches())
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [runner.predict(images, targets) for images, targets, _ in batches]
    t_pred = time.perf_counter() - t0
    t0 = time.perf_counter()
    for out, (_, _, metas) in zip(outs, batches):
        runner.postprocess_dense(out, metas)
    t_post = time.perf_counter() - t0
    n = len(batches)
    log(f"  test task per tile (one unflipped pass, {n} tiles): host data "
        f"{1e3 * t_data / n:.1f} ms, predict (H2D, forward, D2H) "
        f"{1e3 * t_pred / n:.1f} ms, threshold {1e3 * t_post / n:.1f} ms "
        f"[{card}]")
    pkl = os.path.join(work, "test", "test_0.pkl")
    before = os.path.join(tmp, "breakdown", "before_nms")
    after = os.path.join(tmp, "breakdown", "after_nms")
    t0 = time.perf_counter()
    prepare_data(pkl, before, get_classes_by_name("FAIR1M_1_5"))
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    mergebypoly(before, after, nms_threshold_type=1)
    t_nms = time.perf_counter() - t0
    log(f"  merge stages: pickle -> per-class files {t_prep:.3f} s, "
        f"mergebypoly (spawned class workers, native NMS) {t_nms:.3f} s, "
        f"of the task's merge {runner.test_stats['merge_s']:.3f} s [{card}]")


def write_labelled(root, names, size, seed, rboxes, labels):
    """Seeded tiles under ``root/images`` and a ``labels.pkl`` of their
    rotated boxes and 1-based labels (one row of ``rboxes`` / ``labels``
    per tile)."""
    import pickle

    import numpy as np

    write_tiles(os.path.join(root, "images"), names, size, seed)
    infos = [dict(filename=n, width=size, height=size, ann=dict(
        bboxes=np.asarray(r, np.float32), labels=np.asarray(lab, np.int64),
        bboxes_ignore=np.zeros((0, 5), np.float32)))
        for n, r, lab in zip(names, rboxes, labels)]
    with open(os.path.join(root, "labels.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return root


def assert_near_params(a, b, lrs, what):
    """Two models' parameters after the same AdamW steps: each element
    within 2 x (the sum of the step rates), since one step moves a weight
    by about lr x sign(gradient) and a gradient that is noise (the biases
    ahead of a BatchNorm) may take either sign; at most 0.5% of the
    elements beyond 1e-6 (tests/test_torch_port_train_runner.py holds the
    CPU port to the JAX runner by the same bound). BN statistics to 1e-4
    relative."""
    bound = 2 * sum(lrs) + 1e-6
    sa, sb = a.state_dict(), b.state_dict()
    worst, beyond, total = 0.0, 0, 0
    for k, va in sa.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (va.detach().float().cpu() - sb[k].detach().float().cpu()).abs()
        if k.endswith(("running_mean", "running_var")):
            scale = sb[k].detach().float().abs().max().item()
            if not d.max().item() <= 1e-4 * max(scale, 0.1):
                raise AssertionError(f"{what}: {k} differs by "
                                     f"{d.max().item()}")
            continue
        worst = max(worst, d.max().item())
        beyond += int((d > 1e-6).sum())
        total += d.numel()
    log(f"  {what}: parameters max_abs_err {worst:.3e} (bound {bound:.3e}), "
        f"{beyond} of {total} elements beyond 1e-6 (at most 0.5%)")
    if not (worst <= bound and beyond <= 0.005 * total):
        raise AssertionError(f"{what}: parameters differ")


def phase_runner_train_tiny(torch, dev, tmp):
    """The tiny config through the runner's training (the SWA switch
    after epoch 0), CUDA (kernels) against the CPU (plain versions), and
    a run broken by a save and a resume against the unbroken one."""
    import copy

    import numpy as np

    from rs_detection_tpu_torch.config import get_cfg, init_cfg
    from rs_detection_tpu_torch.flagship import (PIXEL_MEAN, PIXEL_STD,
                                                 flagship_cfg)
    from rs_detection_tpu_torch.runner import Runner

    size, max_gt = 128, 8
    rng = np.random.RandomState(23)
    rboxes, labels = [], []
    for _ in range(4):
        # axis-aligned, as phase 9's: one ulp of sin / cos between the
        # devices can change the RPN's tie-keeping low-quality matches
        r = np.stack([rng.uniform(24, 104, 5), rng.uniform(24, 104, 5),
                      rng.uniform(16, 48, 5), rng.uniform(8, 24, 5),
                      np.zeros(5)], 1)
        rboxes.append(r)
        labels.append(rng.randint(1, 11, 5))
    ds = write_labelled(os.path.join(tmp, "tiny_labelled"),
                        [f"T{i}.png" for i in range(4)], size, 23, rboxes,
                        labels)
    model = flagship_cfg(tiny=True)
    # every candidate sampled: >= the 9548 anchors of a 128^2 image, and
    # nms_post + max_gt proposals
    model["rpn"]["sampler"] = dict(num=16384, pos_fraction=1.0)
    model["bbox_head"]["sampler"] = dict(num=64 + max_gt, pos_fraction=1.0,
                                         add_gt_as_proposals=True)
    norm = dict(type="Normalize", mean=list(PIXEL_MEAN), std=list(PIXEL_STD),
                to_bgr=False)
    cfg = write_config(
        os.path.join(tmp, "tiny_train.py"), seed=6, model=model,
        max_epoch=2, swa_start_epoch=1, log_interval=1,
        dataset=dict(train=dict(
            type="DOTADataset", dataset_dir=ds, batch_size=2, shuffle=True,
            max_gt=max_gt, transforms=[
                dict(type="RotatedResize", min_size=size, max_size=size),
                dict(type="RotatedRandomFlip", prob=0.5),
                dict(type="RandomRotateAug", random_rotate_on=True),
                dict(type="Pad", size_divisor=32), norm])),
        optimizer=dict(type="AdamW", lr=1e-4, weight_decay=0.05,
                       grad_clip=dict(max_norm=35)),
        scheduler=dict(type="StepLR", warmup="linear", warmup_iters=500,
                       warmup_ratio=1.0 / 3, milestones=[7, 10]),
        optimizer_swa=dict(type="AdamW", lr=1e-4, weight_decay=0.05),
        scheduler_swa=dict(type="CosineAnnealingLR", max_steps=1,
                           min_lr_ratio=0.01))
    init_cfg(cfg)
    base = copy.deepcopy(dict(get_cfg()))

    def run(name, device, **extra):
        c = get_cfg()
        c.clear()
        c.update(copy.deepcopy(base))
        c.update(work_dir=os.path.join(tmp, "tiny_train", name), **extra)
        runner = Runner(device=device)
        runner.run()
        return runner

    gpu, cpu = run("cuda", dev), run("cpu", "cpu")
    lrs = [r["lr"] for r in gpu.history]
    if [r["lr"] for r in cpu.history] != lrs or len(lrs) != 4:
        raise AssertionError(f"tiny train task: rates {lrs}")
    worst = 0.0
    for g, c in zip(gpu.history, cpu.history):
        for k, v in c.items():
            if "loss" in k:
                worst = max(worst, abs(g[k] - v) / max(abs(v), 1e-6))
    log(f"  tiny train task, CUDA vs CPU, 4 steps across the SWA switch "
        f"(rates {', '.join(f'{x:.4g}' for x in lrs)}): losses worst "
        f"relative error {worst:.2e} (tolerance 1e-4, phase 9's)")
    if not worst <= 1e-4:
        raise AssertionError("tiny train task: losses differ")
    assert_near_params(gpu.model, cpu.model, lrs, "tiny train task, CUDA "
                       "vs CPU")
    if not (gpu._swa_active and gpu.optimizer.iterations == 2):
        raise AssertionError("tiny train task: no SWA phase of 2 steps")
    run("resumed", dev, max_epoch=1)
    resumed = run("resumed", dev)
    if [r["lr"] for r in resumed.history] != lrs[2:] or resumed.iter != 4:
        raise AssertionError(f"tiny train task: the resumed run took "
                             f"{resumed.iter} steps at {resumed.history}")
    assert_near_params(resumed.model, gpu.model, lrs,
                       "tiny train task on CUDA, 2 steps + save + resume + "
                       "2 steps vs 4 unbroken")


def phase_train_task(torch, tmp, kernels, card, phase10_ms):
    """``run_net --task train`` at full width across the SWA switch,
    ``get_swa_model``, then ``run_net --task val`` from the averaged
    checkpoint; the wrappers' launches counted over each task. Returns
    (train task launches, val task launches)."""
    import numpy as np

    from rs_detection_tpu_torch.flagship import make_targets
    from rs_detection_tpu_torch.tools import get_swa_model, run_net

    n_tiles, steps_per_epoch = TRAIN_TASK_TILES, TRAIN_TASK_TILES // BATCH
    names = [f"F{i:02d}.png" for i in range(n_tiles)]
    t = make_targets(n_tiles, TILE, MAX_GT, torch.Generator().manual_seed(24))
    t0 = time.perf_counter()
    ds = write_labelled(os.path.join(tmp, "train_task"), names, TILE, 24,
                        t["rboxes"].numpy(), t["labels"].numpy())
    t_write = time.perf_counter() - t0
    base = os.path.join(ROOT, "configs", "orcnn_van3_fair1m_1_5.py")
    work = os.path.join(tmp, "train_work")
    cfg = write_config(
        os.path.join(tmp, "orcnn_van3_fair1m_1_5_train.py"), _base_=base,
        model=dict(compute_dtype="bfloat16"), allow_random_init=True,
        dataset=dict(train=dict(dataset_dir=ds), val=None, test=None),
        max_epoch=2, swa_start_epoch=1, checkpoint_interval=1,
        log_interval=1, work_dir=work)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = run_net.main(["--config-file", cfg, "--task", "train"])
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    train_launches = {k: fn.launches for k, fn in kernels.items()}
    steps = 2 * steps_per_epoch
    want = dict.fromkeys(kernels, 0)
    want.update(roi_align_rotated_pyramid=steps,
                roi_align_rotated_pyramid_bwd=steps,
                dw_wgrad=3 * sum(st[3] for st in STAGES) * steps)
    if train_launches != want:
        raise AssertionError(f"train task kernel launches {train_launches}, "
                             f"expected {want}")
    hist = runner.history
    if len(hist) != steps or runner.iter != steps:
        raise AssertionError(f"train task: {runner.iter} steps, {len(hist)} "
                             f"records")
    for rec in hist:
        losses = {k: v for k, v in rec.items() if "loss" in k}
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train task: losses not finite: {rec}")
        if not (losses["loss_rpn_bbox"] > 0 and losses["orcnn_bbox_loss"] > 0):
            raise AssertionError(f"train task: a bbox loss is zero: {rec}")
    swa = runner.optimizer_swa
    swa_lr0 = runner.scheduler_swa(swa.defaults["lr"], 0, 0.0)
    if not (runner._swa_active and runner.optimizer is swa
            and swa.iterations == steps_per_epoch
            and hist[steps_per_epoch]["lr"] == swa_lr0):
        raise AssertionError(f"train task: SWA phase {runner._swa_active}, "
                             f"{swa.iterations} steps, first rate "
                             f"{hist[steps_per_epoch]['lr']} (want {swa_lr0})")
    dtypes = {p.dtype for p in runner.model.parameters()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"train task: master weights {dtypes}")
    ckpts = os.path.join(work, "checkpoints")
    t0 = time.perf_counter()
    swa_path = get_swa_model.get_swa_model(work, 1, 2)
    t_swa = time.perf_counter() - t0
    have = sorted(os.listdir(ckpts))
    if have != ["ckpt_1.pkl", "ckpt_2.pkl", "swa_1-2.pkl"]:
        raise AssertionError(f"train task: checkpoints {have}")
    step_ms = sorted(1e3 * x for x in runner.train_stats["step_s"][1:])
    med = step_ms[len(step_ms) // 2]
    wait = runner.train_stats["loader_wait_s"]
    log(f"  run_net --task train, VAN-b3 Oriented R-CNN from "
        f"configs/orcnn_van3_fair1m_1_5.py, bf16 compute, f32 master "
        f"weights: {n_tiles} tiles of {TILE}^2 with {MAX_GT} boxes, batch "
        f"{BATCH}, 8 loader threads, {steps} steps ({steps_per_epoch} AdamW "
        f"+ StepLR, {steps_per_epoch} SWA from rate {swa_lr0:.3g}); "
        f"{t_train:.1f} s whole task (2 checkpoints); ms/step through the "
        f"runner, median of steps 2-{steps}: {med:.1f} (min {step_ms[0]:.1f}"
        f", max {step_ms[-1]:.1f}); phase 10's train_step alone "
        f"{phase10_ms:.1f}; the loop waited {wait:.2f} s on the loader in "
        f"all; peak memory {peak / 2**30:.2f} GiB [{card}]")
    log("  losses, first and last step: " + ", ".join(
        f"{k} {hist[0][k]:.4f} -> {hist[-1][k]:.4f}" for k in hist[0]
        if "loss" in k))
    log(f"  launches in the train task: {train_launches}; tiles written in "
        f"{t_write:.1f} s, get_swa_model {t_swa:.1f} s")
    phase_train_task_breakdown(torch, runner, card)

    val_ds = os.path.join(tmp, "val_task")
    write_labelled(val_ds, names[:BATCH], TILE, 24,
                   t["rboxes"][:BATCH].numpy(), t["labels"][:BATCH].numpy())
    vcfg = write_config(
        os.path.join(tmp, "orcnn_van3_fair1m_1_5_val.py"), _base_=base,
        model=dict(compute_dtype="bfloat16"), allow_random_init=True,
        dataset=dict(train=None, val=dict(dataset_dir=val_ds), test=None),
        resume_path=swa_path, work_dir=os.path.join(tmp, "val_work"))
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    vrunner = run_net.main(["--config-file", vcfg, "--task", "val"])
    t_val = time.perf_counter() - t0
    val_launches = {k: fn.launches for k, fn in kernels.items()}
    want = dict.fromkeys(kernels, 0)
    want.update(van_mlp=sum(st[3] for st in STAGES),
                roi_align_rotated_pyramid=1)
    if val_launches != want:
        raise AssertionError(f"val task kernel launches {val_launches}, "
                             f"expected {want} (one forward of {BATCH})")
    aps = vrunner.val_aps
    classes = [k for k in aps if k != "eval/0_meanAP"]
    if len(classes) != 10 or not all(math.isfinite(v) for v in aps.values()):
        raise AssertionError(f"val task: APs {aps}")
    log(f"  run_net --task val from swa_1-2.pkl, {BATCH} tiles in one "
        f"forward: {t_val:.1f} s whole task; eval/0_meanAP "
        f"{aps['eval/0_meanAP']:.4f} (random weights, no gate); launches "
        f"{val_launches} [{card}]")
    return train_launches, val_launches


def phase_train_task_breakdown(torch, runner, card):
    """Where the train task's step goes beyond phase 10's: ``train_step``
    on the runner's model (after its run) with phase 10's seeded batch,
    its ground truths as they are (MAX_GT slots) and padded to the
    dataset's ``max_gt`` (the collated batches' width), 1 warm-up and 2
    timed steps each."""
    from rs_detection_tpu_torch.flagship import make_targets, normalize
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import AdamW
    from rs_detection_tpu_torch.parallel.train_step import train_step

    dev = runner.device
    gen = torch.Generator(device=dev).manual_seed(12)
    images = normalize(torch.randint(0, 256, (BATCH, TILE, TILE, 3),
                                     generator=gen, device=dev,
                                     dtype=torch.uint8))
    t = make_targets(BATCH, TILE, MAX_GT, gen)
    width = runner.train_dataset.max_gt
    padded = dict(img_hw=t["img_hw"])
    for k, v in (("rboxes", t["rboxes"]), ("labels", t["labels"]),
                 ("gt_mask", t["gt_mask"])):
        p = torch.zeros((BATCH, width) + v.shape[2:], dtype=v.dtype,
                        device=dev)
        p[:, :MAX_GT] = v
        padded[k] = p
    opt = AdamW(runner.model.parameters(), lr=1e-4, weight_decay=0.05)
    out = []
    for n, tg in ((MAX_GT, t), (width, padded)):
        train_step(runner.model, opt, StepLR([7, 10]), images, tg, gen,
                   epoch=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            train_step(runner.model, opt, StepLR([7, 10]), images, tg, gen,
                       epoch=0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 2
        out.append(f"{n} ground-truth slots {ms:.1f} ms/step, peak "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  train_step on the train task's model, phase 10's batch: "
        f"{'; '.join(out)} [{card}]")


def resnet_tiny_model():
    """The model section of ``tests/test_runner.py:_tiny_cfg`` (Resnet18,
    32-wide FPN and heads; its copy in ``tests/test_torch_overfit_map.py``)
    with the zoo's freezing (``frozen_stages=1``, ``norm_eval=True``) and
    samplers that take every candidate (>= the 4092 anchors of a 128^2
    tile; nms_post + 6 ground truths), as the CPU runner tests train it."""
    from test_torch_overfit_map import tiny_cfg

    model = tiny_cfg("", "", None)["model"]
    model["backbone"].update(frozen_stages=1, norm_eval=True)
    model["rpn"]["sampler"] = dict(num=4096, pos_fraction=1.0)
    model["bbox_head"]["sampler"] = dict(num=32 + 6, pos_fraction=1.0,
                                         add_gt_as_proposals=True)
    return model


def phase_resnet_tiny(torch, dev):
    """The tiny ResNet config's ``predict`` and two SGD steps, CUDA (K1,
    K3) against the CPU (plain versions), f32, TF32 off, from one seed."""
    from rs_detection_tpu_torch.flagship import (init_weights, make_targets,
                                                 normalize)
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel.train_step import train_step
    from rs_detection_tpu_torch.utils.registry import MODELS, build_from_cfg

    g = torch.Generator().manual_seed(25)
    tiles = torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    targets = make_targets(2, 128, 6, g)
    # axis-aligned, as phase 9's (the RPN's tie-keeping rescue)
    targets["rboxes"][..., 4] = 0.0
    runs = {}
    for device in ("cpu", dev):
        model = build_from_cfg(resnet_tiny_model(), MODELS)
        init_weights(model, torch.Generator().manual_seed(3))
        model.to(device)
        start = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
        pred = model.eval().predict(normalize(tiles.to(device)))
        opt = SGD(model.parameters(), lr=0.01, momentum=0.9,
                  grad_clip=dict(max_norm=35))
        sched = StepLR([8], warmup="linear", warmup_iters=4,
                       warmup_ratio=0.25)
        losses = []
        for step in range(2):
            out = train_step(model, opt, sched, normalize(tiles.to(device)),
                             {k: v.to(device) for k, v in targets.items()},
                             torch.Generator(device=device).manual_seed(step),
                             epoch=opt.iterations / 2)
            losses.append({k: float(v) for k, v in out.items()})
        runs[str(device)] = (pred, losses, start, {
            k: v.detach().cpu() for k, v in model.state_dict().items()})
    (p_cpu, l_cpu, s0, w_cpu), (p_gpu, l_gpu, _, w_gpu) = runs["cpu"], \
        runs[str(dev)]
    if not torch.equal(p_cpu["valid"], p_gpu["valid"].cpu()):
        raise AssertionError("tiny ResNet predict: valid masks differ")
    for key, atol in (("polys", 1e-2), ("scores", 1e-5)):  # phase 5's
        err = (p_gpu[key].cpu() - p_cpu[key]).abs().max().item()
        log(f"  tiny ResNet predict, CUDA vs CPU, {key}: max_abs_err "
            f"{err:.3e} (atol {atol})")
        if not err <= atol:
            raise AssertionError(f"tiny ResNet predict: {key} differ")
    worst = max(abs(g_[k] - c[k]) / max(abs(c[k]), 1e-6)
                for g_, c in zip(l_gpu, l_cpu) for k in c if "loss" in k)
    log(f"  tiny ResNet, 2 SGD steps, losses CUDA vs CPU: worst relative "
        f"error {worst:.2e} (tolerance 1e-4, phase 9's)")
    if not worst <= 1e-4:
        raise AssertionError("tiny ResNet training: losses differ")
    # each parameter within 1e-6 + 3% of its move (the CPU runner test's
    # bound, tests/test_torch_resnet_runner.py); the frozen stem and
    # layer1 moved too (weight decay), and no running statistic moved
    worst, frozen_moved = 0.0, True
    for k, c in w_cpu.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (w_gpu[k] - c).abs().max().item()
        moved = (c - s0[k]).abs().max().item()
        if k.endswith(("running_mean", "running_var")):
            if moved != 0.0 or d != 0.0:
                raise AssertionError(f"tiny ResNet training: {k} moved")
            continue
        worst = max(worst, d / (moved + 1e-12))
        if not d <= 1e-6 + 0.03 * moved:
            raise AssertionError(f"tiny ResNet training: {k} differs by "
                                 f"{d} of a move of {moved}")
        if k.startswith(("backbone.Conv_0", "backbone.layer1_")) and \
                ".Conv_" in f".{k}" and k.endswith("weight"):
            frozen_moved &= moved > 0.0
    log(f"  tiny ResNet, 2 SGD steps, parameters CUDA vs CPU: worst "
        f"difference {100 * worst:.3f}% of the parameter's move (tolerance "
        f"3%); frozen stem and layer1 conv weights decayed: {frozen_moved}; "
        f"running "
        f"statistics unmoved")
    if not frozen_moved:
        raise AssertionError("tiny ResNet training: a frozen parameter "
                             "did not decay")


def captured_roi_calls(torch, fn):
    """The (features, rois) of each RoI extractor call inside ``fn()``."""
    from rs_detection_tpu_torch.models.roi_extractors import \
        oriented_single_level as extractor

    seen = []
    call = extractor.roi_align_rotated_pyramid

    def capture(feats, rois, *args, **kwargs):
        seen.append(([f.detach().clone() for f in feats],
                     rois.detach().clone()))
        return call(feats, rois, *args, **kwargs)

    extractor.roi_align_rotated_pyramid = capture
    try:
        fn()
    finally:
        extractor.roi_align_rotated_pyramid = call
    return seen


def phase_resnet_train_task(torch, tmp, kernels, card):
    """``run_net --task train`` then ``--task test`` with the merge on
    ``projects/oriented_rcnn/configs/orcnn_r50_fpn_1x_dota.py`` at full
    width; the wrappers' launches counted over each task; K1 and K3 at
    this path's shapes. Returns (train task launches, test task launches,
    K1 (ms, plain ms, bound), K3 (ms, plain ms, bound))."""
    import pickle

    import numpy as np

    from rs_detection_tpu_torch.flagship import make_targets, normalize
    from rs_detection_tpu_torch.ops import roi_align as ra
    from rs_detection_tpu_torch.tools import run_net

    names = [f"R{i:02d}.png" for i in range(RESNET_TILES)]
    t = make_targets(RESNET_TILES, TILE, MAX_GT,
                     torch.Generator().manual_seed(26))
    ds = write_labelled(os.path.join(tmp, "r50_train"), names, TILE, 26,
                        t["rboxes"].numpy(), t["labels"].numpy())
    tiles = os.path.join(tmp, "r50_test")
    test_names = [f"S{k}__1.0__{x}___{y}.png" for k in range(2)
                  for x, y in SCENE_OFFSETS]
    write_tiles(tiles, test_names, TILE, 27)
    base = os.path.join(ROOT, "projects", "oriented_rcnn", "configs",
                        "orcnn_r50_fpn_1x_dota.py")
    work = os.path.join(tmp, "r50_work")
    cfg = write_config(
        os.path.join(tmp, "orcnn_r50_fpn_1x_dota_chip.py"), _base_=base,
        allow_random_init=True, max_epoch=1, log_interval=1,
        checkpoint_interval=1, work_dir=work,
        dataset=dict(train=dict(dataset_dir=ds),
                     test=dict(images_dir=tiles)),
        merge_cfg=dict(dataset_type="DOTA"))
    steps = RESNET_TILES // 2
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = run_net.main(["--config-file", cfg, "--task", "train"])
        t_train = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        train_launches = {k: fn.launches for k, fn in kernels.items()}
        want = dict.fromkeys(kernels, 0)
        want.update(roi_align_rotated_pyramid=steps,
                    roi_align_rotated_pyramid_bwd=steps)
        if train_launches != want:
            raise AssertionError(f"ResNet train task launches "
                                 f"{train_launches}, expected {want}")
        hist = runner.history
        if len(hist) != steps or type(runner.optimizer).__name__ != "SGD":
            raise AssertionError(f"ResNet train task: {len(hist)} records, "
                                 f"{type(runner.optimizer).__name__}")
        for rec in hist:
            losses = {k: v for k, v in rec.items() if "loss" in k}
            if not (all(math.isfinite(v) for v in losses.values())
                    and losses["loss_rpn_bbox"] > 0
                    and losses["orcnn_bbox_loss"] > 0):
                raise AssertionError(f"ResNet train task: losses {rec}")
        dtypes = {p.dtype for p in runner.model.parameters()}
        if dtypes != {torch.float32} or runner.model.compute_dtype:
            raise AssertionError(f"ResNet train task: dtypes {dtypes}")
        step_ms = sorted(1e3 * x for x in runner.train_stats["step_s"][1:])
        log(f"  run_net --task train, ResNet-50 Oriented R-CNN from "
            f"projects/oriented_rcnn/configs/orcnn_r50_fpn_1x_dota.py (f32, "
            f"as written; SGD, 3-ratio RPN, 15 classes, frozen stem and "
            f"layer1, norms on running statistics): {RESNET_TILES} tiles of "
            f"{TILE}^2 with {MAX_GT} boxes, batch 2, 4 loader threads, "
            f"{steps} steps in {t_train:.1f} s whole task; ms/step through "
            f"the runner, median of steps 2-{steps}: "
            f"{step_ms[len(step_ms) // 2]:.1f} (min {step_ms[0]:.1f}, max "
            f"{step_ms[-1]:.1f}); loader wait "
            f"{runner.train_stats['loader_wait_s']:.2f} s; peak memory "
            f"{peak / 2**30:.2f} GiB [{card}]")
        log("  losses, first and last step: " + ", ".join(
            f"{k} {hist[0][k]:.4f} -> {hist[-1][k]:.4f}" for k in hist[0]
            if "loss" in k))
        log(f"  launches in the train task: {train_launches}")

        model = runner.model
        x = normalize(torch.randint(
            0, 256, (2, TILE, TILE, 3), dtype=torch.uint8,
            generator=torch.Generator().manual_seed(28)).to(runner.device))
        tgt = {k: v[:2].to(runner.device) for k, v in t.items()}
        fwd = captured_roi_calls(torch, lambda: model.eval().predict(x))
        with torch.no_grad():
            step = captured_roi_calls(torch, lambda: model.train().loss(
                x, tgt, torch.Generator(device=runner.device).manual_seed(0)))
        del runner, model
        torch.cuda.empty_cache()

        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        tester = run_net.main(["--config-file", cfg, "--task", "test"])
        t_test = time.perf_counter() - t0
        test_launches = {k: fn.launches for k, fn in kernels.items()}
    finally:
        os.chdir(cwd)
    forwards = len(test_names) // 2
    want = dict.fromkeys(kernels, 0)
    want.update(roi_align_rotated_pyramid=forwards)
    if test_launches != want or tester.epoch != 1:
        raise AssertionError(f"ResNet test task launches {test_launches}, "
                             f"expected {want}; epoch {tester.epoch}")
    with open(os.path.join(work, "test", "test_1.pkl"), "rb") as f:
        results = pickle.load(f)
    if len(results) != len(test_names) or not all(
            np.isfinite(p).all() and np.isfinite(s).all()
            for (p, s, _), _ in results):
        raise AssertionError("ResNet test task: bad results")
    after = os.path.join(work, "test", "submit_1", "after_nms")
    n_out = read_rows(os.path.join(after, n) for n in os.listdir(after))
    stats = tester.test_stats
    log(f"  run_net --task test from ckpt_1.pkl: {len(test_names)} tiles "
        f"at batch 2 in {stats['inference_s']:.3f} s = "
        f"{len(test_names) / stats['inference_s']:.2f} tiles/s of inference; "
        f"merge {stats['merge_s']:.3f} s; detections {stats['detections']} "
        f"in, {n_out} after NMS; whole task {t_test:.1f} s [{card}]")
    log(f"  launches in the test task: {test_launches}")

    # K1 and K3 on what this path hands them
    if len(fwd) != 1 or len(step) != 1:
        raise AssertionError("ResNet path: the RoI extractor calls differ")
    out = []
    for what, (fs, rois) in (("K1, one test forward", fwd[0]),
                             ("K3, one training step", step[0])):
        g = torch.Generator(device=rois.device).manual_seed(29)
        if what.startswith("K1"):
            got = ra.roi_align_rotated_pyramid_cuda(fs, rois)
            compare(f"{what}: {rois.shape[0]} rois, C=256, f32", got,
                    ra.roi_align_rotated_pyramid_reference(fs, rois),
                    "float32")
            t_k = cuda_ms(lambda: ra.roi_align_rotated_pyramid_cuda(
                fs, rois), 10)
            t_p = cuda_ms(lambda: ra.roi_align_rotated_pyramid_reference(
                fs, rois), 3)
            b = bound(nbytes(*fs, rois, got), 0.0, 32.0 * got.numel())
        else:
            grad = torch.randn(rois.shape[0], 7, 7, fs[0].shape[-1],
                               generator=g, device=rois.device)
            compare(f"{what}: {rois.shape[0]} rois, C=256, f32",
                    ra.roi_align_rotated_pyramid_bwd_cuda(fs, rois, grad),
                    ra.roi_align_rotated_pyramid_bwd_reference(fs, rois,
                                                               grad),
                    "float32", K3_TOL)
            t_k = cuda_ms(lambda: ra.roi_align_rotated_pyramid_bwd_cuda(
                fs, rois, grad), 10)
            t_p = cuda_ms(lambda: ra.roi_align_rotated_pyramid_bwd_reference(
                fs, rois, grad), 3)
            b = bound(nbytes(grad, rois, *fs), 0.0, 32.0 * grad.numel())
        log(f"    {what}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound "
            f"{b[0]:.3f} ms by {b[1]} [{card}]")
        out.append((t_k, t_p, b))
    return train_launches, test_launches, out[0], out[1]


def phase_eqlv2(torch, tmp, card):
    """``run_net --task train`` on
    ``orcnn_r101_fpn_ms_flip_rotate_bc_le90_eqlv2.py`` at full width for 2
    steps at batch 2 (the config's 8, cut), then a new ``Runner``
    resuming its checkpoint: the EQLv2 state moved and came back."""
    import pickle

    from rs_detection_tpu_torch.flagship import make_targets
    from rs_detection_tpu_torch.runner import Runner
    from rs_detection_tpu_torch.tools import run_net

    names = [f"E{i}.png" for i in range(4)]
    t = make_targets(4, TILE, MAX_GT, torch.Generator().manual_seed(30))
    ds = write_labelled(os.path.join(tmp, "eqlv2_train"), names, TILE, 30,
                        t["rboxes"].numpy(), t["labels"].numpy())
    base = os.path.join(ROOT, "projects", "oriented_rcnn", "configs",
                        "orcnn_r101_fpn_ms_flip_rotate_bc_le90_eqlv2.py")
    work = os.path.join(tmp, "eqlv2_work")
    cfg = write_config(
        os.path.join(tmp, "orcnn_r101_eqlv2_chip.py"), _base_=base,
        allow_random_init=True, max_epoch=1, log_interval=1,
        checkpoint_interval=1, work_dir=work,
        dataset=dict(train=dict(dataset_dir=ds, batch_size=2), val=None,
                     test=None))
    log("  cut: batch 8 -> 2 (the dense RPN assignment over 436,480 anchors "
        "and the dataset's 512 ground-truth slots takes ~7 GB per [B, A, "
        "512] f32 tensor at batch 8, beside ResNet-101's activations); "
        "everything else as the config writes it")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = run_net.main(["--config-file", cfg, "--task", "train"])
    t_train = time.perf_counter() - t0
    head = runner.model.bbox_head
    if type(head).__name__ != "OrientedEQLv2Head" or runner.iter != 2:
        raise AssertionError(f"EQLv2: {type(head).__name__}, "
                             f"{runner.iter} steps")
    state = {k: getattr(head.efl, k).detach().cpu().clone()
             for k in ("pos_grad", "neg_grad")}
    fresh = head.cls_loss_fn.init_state()
    moved = all(not torch.equal(state[k], getattr(fresh, k))
                and bool(torch.isfinite(state[k]).all()) for k in state)
    hist = runner.history
    if not moved or not all(math.isfinite(v) for r in hist
                            for k, v in r.items() if "loss" in k):
        raise AssertionError(f"EQLv2: state moved {moved}, records {hist}")
    with open(os.path.join(work, "checkpoints", "ckpt_1.pkl"), "rb") as f:
        saved = pickle.load(f)["model"]
    second_ms = 1e3 * runner.train_stats["step_s"][-1]
    del runner, head
    torch.cuda.empty_cache()
    resumed = Runner()  # the same config: resumes work_dir's ckpt_1.pkl
    back = resumed.model.bbox_head.efl
    same = resumed.epoch == 1 and all(
        torch.equal(getattr(back, k).cpu(), v)
        and (saved[f"bbox_head.efl.{k}"] == v.numpy()).all()
        for k, v in state.items())
    log(f"  run_net --task train, ResNet-101 Oriented R-CNN with "
        f"OrientedEQLv2Head (f32, 10 classes, 5-ratio RPN), 2 steps of "
        f"batch 2 in {t_train:.1f} s whole task, the second "
        f"{second_ms:.1f} ms, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB: EQLv2 "
        f"pos_grad sum {state['pos_grad'].sum().item():.4f}, neg_grad sum "
        f"{state['neg_grad'].sum().item():.4f} (from "
        f"{fresh.pos_grad.sum().item():.4f} each); saved and resumed "
        f"bit for bit -> {'ok' if same else 'FAIL'} [{card}]")
    if not same:
        raise AssertionError("EQLv2: the state did not survive the round "
                             "trip")


def phase_overfit(torch, dev, tmp, card):
    """The torch form of the JAX overfit test on the card: 200 epochs of
    the tiny ResNet config on rendered tiles, per-class APs float and
    int8, merged scene detections (``tests/test_torch_overfit_map.py``).
    Returns the trained runner, its rendered dataset and a copy of its
    config (phase 31 serves a scene with it)."""
    import copy

    import test_torch_overfit_map as overfit

    from rs_detection_tpu_torch.config import get_cfg

    root = os.path.join(tmp, "overfit")
    os.makedirs(root)
    cwd = os.getcwd()
    os.chdir(root)  # submit_zips/ is cwd-relative
    t0 = time.perf_counter()
    try:
        runner, ds_dir = overfit.trained_runner(root, dev)
        out = overfit.check_trained(runner, ds_dir, int8=True)
    finally:
        os.chdir(cwd)
    log(f"  overfit, Resnet18 Oriented R-CNN (tests/test_runner.py:"
        f"_tiny_cfg, SGD lr 0.001), 400 steps on 4 rendered 128^2 tiles in "
        f"{time.perf_counter() - t0:.1f} s: APs float "
        + ", ".join(f"{k} {v:.4f}" for k, v in out["aps"].items())
        + "; int8 serving " + ", ".join(
            f"{k} {v:.4f}" for k, v in out["aps_int8"].items())
        + f" (gates: >= 0.3, int8 within 0.05); merged scene detections on "
        f"{out['matched'][0]} of {out['matched'][1]} ground truths (gate "
        f"40%) [{card}]")
    return runner, ds_dir, copy.deepcopy(get_cfg().dump())


def compare_tile_dirs(a, b):
    """Tiles of two splits of the same scenes: the same image and label
    names, byte-equal labelTxt files, pixels equal at rate 1.0 and within
    1 LSB elsewhere; returns (tiles, differing pixels, pixels) of the
    resized tiles."""
    import numpy as np
    from PIL import Image

    names = sorted(os.listdir(os.path.join(a, "images")))
    if not names or names != sorted(os.listdir(os.path.join(b, "images"))):
        raise AssertionError(f"tile names differ: {a} vs {b}")
    la = os.path.join(a, "labelTxt")
    if os.path.isdir(la):
        labels = sorted(os.listdir(la))
        if labels != sorted(os.listdir(os.path.join(b, "labelTxt"))):
            raise AssertionError(f"label names differ: {a} vs {b}")
        for n in labels:
            with open(os.path.join(la, n), "rb") as f, \
                    open(os.path.join(b, "labelTxt", n), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"labelTxt {n} differs")
    def diff(n):
        with Image.open(os.path.join(a, "images", n)) as x, \
                Image.open(os.path.join(b, "images", n)) as y:
            d = np.abs(np.asarray(x, np.int16) - np.asarray(y, np.int16))
        return int(d.max()), int((d > 0).sum()), d.size

    differ = total = 0
    with ThreadPoolExecutor(8) as pool:  # Pillow decodes off the lock
        for n, (worst, k, size) in zip(names, pool.map(diff, names)):
            limit = 0 if "__1.0__" in n else 1
            if worst > limit:
                raise AssertionError(f"tile {n}: pixels differ by {worst}")
            if limit:
                differ, total = differ + k, total + size
    return len(names), differ, total


def phase_preprocess(torch, tmp, card):
    """Dataset preparation: ``tools/preprocess.py``'s main on
    ``configs/preprocess/fair1m_1_5_ms.py`` over rendered FAIR scenes, on
    the card and with ``--cpu``; the two outputs agree; 2 training steps
    of the tiny config read the labels it made. Returns the directory of
    the trainval scenes."""
    import contextlib
    import io
    import pickle

    import numpy as np

    from rs_detection_tpu_torch.flagship import (PIXEL_MEAN, PIXEL_STD,
                                                 flagship_cfg)
    from rs_detection_tpu_torch.tools import preprocess, run_net

    src = os.path.join(tmp, "prep", "src")
    t0 = time.perf_counter()
    render_fair_split(os.path.join(src, "trainval"), ["1", "2"], SCENE_SIDE,
                      SCENE_OBJECTS, seed=29)
    # the config's test task needs a split; one scene without labels (cut
    # from two to keep the phase short)
    render_fair_split(os.path.join(src, "test"), ["3"], SCENE_SIDE, 0,
                      seed=30, xml=False)
    log(f"  rendered 2 trainval scenes of {SCENE_SIDE}^2 (8-bit RGB TIFF, "
        f"{SCENE_OBJECTS} rotated objects each, FAIR1M-2.0 class names in "
        f"labelXml) and 1 test scene in {time.perf_counter() - t0:.1f} s")
    cfg = os.path.join(ROOT, "configs", "preprocess", "fair1m_1_5_ms.py")
    runs = {}
    for name, extra in (("card", []), ("cpu", ["--cpu"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            outs = preprocess.main([
                "--config-file", cfg, "--set", f"source_dataset_path={src}",
                f"target_dataset_path={os.path.join(tmp, 'prep', name)}"]
                + extra)
        wall = time.perf_counter() - t0
        stats = [json.loads(line[len("img_split "):])
                 for line in buf.getvalue().splitlines()
                 if line.startswith("img_split ")]
        want = "cuda" if name == "card" else "cpu"
        if len(stats) != 2 or any(not st["device"].startswith(want)
                                  for st in stats):
            raise AssertionError(f"preprocess ({name}): splits {stats}")
        runs[name] = outs, wall, stats
    n_tiles = differ = total = 0
    for a, b in zip(runs["card"][0], runs["cpu"][0]):
        n, d, t = compare_tile_dirs(a, b)
        n_tiles, differ, total = n_tiles + n, differ + d, total + t
    pkls = []
    for outs, _, _ in runs.values():
        with open(os.path.join(outs[0], "labels.pkl"), "rb") as f:
            pkls.append(pickle.load(f))
    n_boxes = sum(len(i["ann"]["bboxes"]) for i in pkls[0])
    same = len(pkls[0]) == len(pkls[1]) > 0 and all(
        a.keys() == b.keys() and all(
            np.array_equal(a["ann"][k], b["ann"][k]) for k in a["ann"])
        and {k: v for k, v in a.items() if k != "ann"}
        == {k: v for k, v in b.items() if k != "ann"}
        for a, b in zip(*pkls))
    if not same or not n_boxes:
        raise AssertionError("preprocess: labels.pkl of the card and the "
                             "CPU differ")
    log(f"  preprocess, card vs CPU: {n_tiles} tiles of {TILE}^2 (rates "
        f"{SCENE_RATES}), the same names, byte-equal labelTxt, equal "
        f"labels.pkl ({len(pkls[0])} tiles, {n_boxes} boxes); pixels equal "
        f"at rate 1.0, within 1 LSB elsewhere, {differ} of {total} "
        f"({differ / max(total, 1):.3e}) differ")
    for name, (outs, wall, stats) in runs.items():
        scenes = sum(st["scenes"] for st in stats) // len(SCENE_RATES)
        stage = {k: sum(st[k] for st in stats) for k in
                 ("decode", "resize", "wait", "cut", "labels", "encode")}
        rest = wall - stage["decode"] - stage["resize"] - stage["wait"]
        log(f"  preprocess on the {name}: {wall:.2f} s for {scenes} scenes = "
            f"{wall / scenes:.2f} s a scene; in the parent: decode "
            f"{stage['decode']:.2f} s, resize (with copies) "
            f"{stage['resize']:.2f} s, waiting for the 8 window threads "
            f"{stage['wait']:.2f} s (their summed cut {stage['cut']:.2f}, "
            f"labels {stage['labels']:.2f}, PNG encode {stage['encode']:.2f} "
            f"s), TIFF -> PNG, labels.pkl and the rest {rest:.2f} s "
            f"[{card}]")

    norm = dict(type="Normalize", mean=list(PIXEL_MEAN), std=list(PIXEL_STD),
                to_bgr=False)
    work = os.path.join(tmp, "prep", "train_work")
    train_cfg = write_config(
        os.path.join(tmp, "prep", "tiny_train.py"), name="prep_train",
        seed=29, work_dir=work, model=flagship_cfg(tiny=True),
        dataset=dict(train=dict(
            type="FAIR1M_1_5_Dataset", dataset_dir=runs["card"][0][0],
            batch_size=2, max_gt=64, shuffle=True, transforms=[
                dict(type="RotatedResize", min_size=512, max_size=512),
                dict(type="Pad", size_divisor=32), norm])),
        optimizer=dict(type="AdamW", lr=1e-4, weight_decay=0.05),
        max_epoch=1, max_iter=2, log_interval=1)
    runner = run_net.main(["--config-file", train_cfg, "--task", "train"])
    losses = [{k: v for k, v in r.items() if "loss" in k}
              for r in runner.history]
    if len(losses) != 2 or not all(
            v and all(math.isfinite(x) for x in v.values()) for v in losses):
        raise AssertionError(f"training on the prepared tiles: {losses}")
    log(f"  run_net --task train, tiny config on the card's labels.pkl: 2 "
        f"steps, losses " + "; ".join(
            ", ".join(f"{k} {v:.4f}" for k, v in step.items())
            for step in losses))
    return os.path.join(src, "trainval", "images")


def phase_scene_task(torch, dev, tmp, scenes, kernels, card, tile_file_tps):
    """Raw-scene serving at full width: ``run_net --task test`` on
    ``configs/orcnn_van3_fair1m_1_5.py`` with ``dataset.test`` a
    ``SceneDataset`` over phase 29's two scenes, then the same scenes
    screened by a random-init ``TileScreen`` at ``budget=4``. Returns the
    dense task's launches."""
    import pickle

    import numpy as np

    from rs_detection_tpu_torch.data.device_tiler import tile_positions
    from rs_detection_tpu_torch.data.scene import SceneDataset
    from rs_detection_tpu_torch.tools import run_net

    kw = dict(images_dir=scenes, subsize=TILE, gap=200, rates=SCENE_RATES,
              batch_size=BATCH)
    per_variant = [len(tile_positions(round(SCENE_SIDE * r), TILE,
                                      TILE - 200)) ** 2 for r in SCENE_RATES]
    tiles = 2 * sum(per_variant)
    forwards = -(-tiles // BATCH)
    if tiles != 90:
        raise AssertionError(f"scene tiles {tiles}, expected 90")
    work = os.path.join(tmp, "scene", "work")
    os.makedirs(work)
    cfg = write_config(
        os.path.join(tmp, "scene", "orcnn_van3_fair1m_1_5_scene.py"),
        _base_=os.path.join(ROOT, "configs", "orcnn_van3_fair1m_1_5.py"),
        model=dict(compute_dtype="bfloat16"),
        dataset=dict(test=dict(_cover_=True, type="SceneDataset",
                               dataset_type="FAIR1M_1_5", **kw),
                     train=None, val=None),
        flip_test=False, allow_random_init=True,
        merge_cfg=dict(dataset_type="FAIR1M_1_5"), work_dir=work)
    n_blocks = sum(st[3] for st in STAGES)
    cwd = os.getcwd()
    os.chdir(os.path.join(tmp, "scene"))
    try:
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = run_net.main(["--config-file", cfg, "--task", "test"])
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        stats = dict(runner.test_stats)
        want = dict.fromkeys(kernels, 0)
        want.update(van_mlp=n_blocks * forwards,
                    roi_align_rotated_pyramid=forwards)
        if launches != want or stats["tiles"] != tiles:
            raise AssertionError(f"scene task: {stats['tiles']} tiles, "
                                 f"launches {launches}, expected {want}")
        with open(os.path.join(work, "test", "test_0.pkl"), "rb") as f:
            results = pickle.load(f)
        n_in = 0
        for (polys, scores, labels), meta in results:
            if not (np.isfinite(polys).all() and np.isfinite(scores).all()
                    and polys.shape == (len(scores), 8)
                    and ((labels >= 1) & (labels <= 10)).all()):
                raise AssertionError(f"scene task: bad detections, {meta}")
            n_in += len(scores)
        csv = os.path.join(tmp, "scene", "submit_zips",
                           "orcnn_van3_fair1m_1_5_scene.csv")
        n_csv = read_rows([csv])
        if len(results) != tiles or not 0 < n_csv < n_in:
            raise AssertionError(f"scene task: {len(results)} results, "
                                 f"{n_in} detections, {n_csv} CSV rows")
        log(f"  run_net --task test over 2 raw scenes of {SCENE_SIDE}^2 "
            f"(SceneDataset, rates {SCENE_RATES}: {per_variant} tiles a "
            f"scene-variant), VAN-b3 bf16: {tiles} tiles in {forwards} "
            f"forwards of {BATCH} in {stats['inference_s']:.3f} s = "
            f"{tiles / stats['inference_s']:.2f} scene tiles/s (decode, H2D, "
            f"resize, tile, normalize on the card, predict) beside phase "
            f"22's {tile_file_tps:.2f} tile-file tiles/s at batch 1; merge "
            f"{stats['merge_s']:.3f} s; detections {n_in}, {n_csv} CSV "
            f"rows; peak {peak:.2f} GiB; whole task {wall:.1f} s; K2 "
            f"{launches['van_mlp'] // forwards} and K1 "
            f"{launches['roi_align_rotated_pyramid'] // forwards} launches "
            f"a forward [{card}]")

        # each served tile against the CPU port's tile of the same name
        err, n = 0.0, 0
        for (gi, _, gm), (ri, _, rm) in zip(
                SceneDataset(device=dev, **kw).batches(),
                SceneDataset(device="cpu", **kw).batches()):
            if [m and m["filename"] for m in gm] != \
                    [m and m["filename"] for m in rm]:
                raise AssertionError("scene tiles: names differ card / CPU")
            err = max(err, (gi.cpu() - ri).abs().max().item())
            n += sum(1 for m in gm if m)
        log(f"  scene tiles on the card vs the CPU port's, by name: {n} "
            f"tiles, max_abs_err {err:.3e} (f32, tolerance 1e-4)")
        if n != tiles or not err <= 1e-4:
            raise AssertionError(f"scene tiles card vs CPU: {n}, {err}")

        runner.test_dataset = SceneDataset(
            device=dev, screen=dict(budget=4, allow_random_init=True), **kw)
        for fn in kernels.values():
            fn.launches = 0
        # cut: the screened run skips the merge (7 s of host NMS over the
        # random weights' detections; the dense run above merged)
        runner.cfg.merge_cfg = None
        runner.test(flip_test=False)
        screened = {k: fn.launches for k, fn in kernels.items()}
        sstats = runner.test_dataset.screen_stats
        kept = 4 * 2 * len(SCENE_RATES)
        want = dict.fromkeys(kernels, 0)
        want.update(van_mlp=n_blocks * -(-kept // BATCH),
                    roi_align_rotated_pyramid=-(-kept // BATCH))
        if sstats != dict(total=tiles, kept=kept) or screened != want \
                or runner.test_stats["tiles"] != kept:
            raise AssertionError(f"screened scene task: {sstats}, "
                                 f"{runner.test_stats}, {screened}")
        log(f"  the same scenes screened by a random-init TileScreen at "
            f"budget=4: screen_stats {sstats}, {kept} tiles in "
            f"{-(-kept // BATCH)} forwards, inference "
            f"{runner.test_stats['inference_s']:.3f} s (screen included); "
            f"no merge (cut) [{card}]")
    finally:
        os.chdir(cwd)
    return launches


def phase_screened_scene(torch, dev, tmp, card, runner, ds_dir, saved_cfg):
    """The torch form of the JAX screened-scene mAP test on the card,
    with phase 28's trained detector (``tests/test_torch_scene.py:
    check_screened_scene``)."""
    import test_torch_scene as scene_tests

    from rs_detection_tpu_torch.config import get_cfg

    cfg = get_cfg()  # the runner reads the global config: phase 28's again
    cfg.clear()
    cfg.update(saved_cfg)
    root = os.path.join(tmp, "screened")
    os.makedirs(root)
    cwd = os.getcwd()
    os.chdir(root)
    t0 = time.perf_counter()
    try:
        out = scene_tests.check_screened_scene(runner, ds_dir, root, dev)
    finally:
        os.chdir(cwd)
    log(f"  screened scene (SP001, 3 x 3 tiles of 128^2, 4 occupied) in "
        f"{time.perf_counter() - t0:.1f} s: screen logits "
        f"{out['screen_logits']}; ground truths matched of {out['total']}: "
        f"dense {out['dense']}, thresh 0.5 {out['thresh']} "
        f"({out['thresh_stats']}, the occupied tiles' detections as the "
        f"dense run's, the dense merged detections above {out['floor']} "
        f"reproduced), budget 1 {out['budget1']} ({out['budget1_stats']}) "
        f"[{card}]")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    if not os.path.isdir(os.path.join(ROOT, "rs_detection_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (rs_detection_tpu_torch/ is missing)")
    sys.path.insert(0, ROOT)
    # phases 25, 28 and 31 share the CPU tests' configs and rendered tiles
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from rs_detection_tpu_torch.flagship import (build_flagship,
                                                 make_targets, normalize)
    from rs_detection_tpu_torch.ops import _build
    from rs_detection_tpu_torch.ops import dw_conv as dwc
    from rs_detection_tpu_torch.ops import dwconv as dw
    from rs_detection_tpu_torch.ops import quant
    from rs_detection_tpu_torch.ops import roi_align as ra
    from rs_detection_tpu_torch.ops import van_attn as va
    from rs_detection_tpu_torch.ops import van_mlp as vm
    from rs_detection_tpu_torch.parallel import train_step as train_mod

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} ({card}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.kernel_library()
    log(f"[2] build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(_build.library_path(), ROOT)}")

    serving = {"van_mlp": vm.van_mlp_cuda,
               "van_mlp_residual": vm.van_mlp_residual_cuda,
               "van_mlp_int8": vm.van_mlp_int8_cuda,
               "van_mlp_residual_int8": vm.van_mlp_residual_int8_cuda,
               "van_attn": va.van_attn_cuda,
               "depthwise_conv2d": dw.depthwise_conv2d_cuda,
               "roi_align_rotated_pyramid": ra.roi_align_rotated_pyramid_cuda}
    log("[3] K2 fused VAN MLP vs plain")
    k2 = phase_k2(torch, vm.van_mlp_cuda, vm.van_mlp_reference, dev)
    log("[4] K1 rotated pyramid RoIAlign vs plain and its first design")
    k1, k1_step_ms, k1_serving_ms = phase_k1(torch, ra, build_flagship,
                                             normalize, dev)
    log("[5] tiny config predict: CUDA (kernels) vs CPU (plain), f32")
    phase_slice(torch, build_flagship, normalize, dev)
    log("[6] serving path")
    modes = {}
    launches, *modes["non-fused"] = phase_main(
        torch, build_flagship, normalize, serving, dev, card)
    log("[7] K3 RoIAlign backward vs plain, bit for bit across launches, "
        "K1/K3 adjointness")
    k3, k3_step_ms = phase_k3(torch, ra, dev)
    log("[8] K6 depthwise weight gradient vs plain")
    k6 = phase_k6(torch, dwc, dev)
    log("[9] tiny config training step: CUDA (kernels) vs CPU (plain), f32")
    phase_train_tiny(torch, build_flagship, make_targets, train_mod, dev)
    log("[10] training path")
    training = {"van_mlp": vm.van_mlp_cuda,
                "roi_align_rotated_pyramid": ra.roi_align_rotated_pyramid_cuda,
                "roi_align_rotated_pyramid_bwd":
                    ra.roi_align_rotated_pyramid_bwd_cuda,
                "dw_wgrad": dwc.dw_wgrad_cuda}
    train_launches, phase10_ms = phase_train(
        torch, build_flagship, make_targets, normalize, train_mod, training,
        dev, card)
    log("[11] K5 depthwise forward (and K7's layout) vs plain")
    k5, k7 = phase_k5(torch, dw, dev)
    k7_launches = phase_k7_path(torch, dw, dev)
    log("[12] K2r residual form of the VAN MLP kernel vs plain")
    k2r = phase_k2(torch, vm.van_mlp_residual_cuda,
                   vm.van_mlp_residual_reference, dev, name="K2r")
    log("[13] K4 fused VAN attention half-block vs plain")
    k4 = phase_k4(torch, va, dev)
    log("[14] tiny config fused predict: CUDA vs CPU, fused vs non-fused")
    phase_slice(torch, build_flagship, normalize, dev, fused=True)
    log("[15] fused serving path")
    fused_launches, *modes["fused"] = phase_main(
        torch, build_flagship, normalize, serving, dev, card, fused=True)
    log("[16] K2q int8 form of the VAN MLP kernel, and its residual form, "
        "vs plain")
    k2q = phase_k2q(torch, vm, dev, residual=False)
    k2qr = phase_k2q(torch, vm, dev, residual=True)
    phase_k2q_pack(torch, vm, quant, _build.kernel_library(), dev)
    log("[17] integer products of the int8 mode: CUDA vs CPU, bit for bit")
    phase_int_products(torch, quant, dev)
    log("[18] tiny config int8 predict: CUDA vs CPU, int8 vs float")
    phase_slice_int8(torch, build_flagship, normalize, dev, fused=False)
    phase_slice_int8(torch, build_flagship, normalize, dev, fused=True)
    log("[19] int8 serving path")
    int8_launches, *modes["int8 non-fused"] = phase_main(
        torch, build_flagship, normalize, serving, dev, card, int8=True)
    log("[20] fused int8 serving path")
    int8_fused_launches, *modes["int8 fused"] = phase_main(
        torch, build_flagship, normalize, serving, dev, card, fused=True,
        int8=True, n_requests=INT8_REQUESTS_FUSED)
    log("  serving, same run: " + "; ".join(
        f"{mode} {t:.2f} tiles/s, request median {med:.1f} ms, peak "
        f"{peak:.2f} GiB" for mode, (t, peak, med) in modes.items())
        + f" [{card}]")
    with tempfile.TemporaryDirectory() as tmp:
        log("[21] tiny config through the runner: CUDA vs CPU")
        phase_runner_tiny(torch, dev, tmp)
        log("[22] run_net --task test at full width")
        test_launches, tile_file_tps = phase_run_net(torch, tmp, serving,
                                                     card)
        log("[23] tiny config through the runner's training: CUDA vs CPU, "
            "resume")
        phase_runner_train_tiny(torch, dev, tmp)
        log("[24] run_net --task train at full width, get_swa_model, "
            "run_net --task val")
        train_task_launches, val_task_launches = phase_train_task(
            torch, tmp, dict(serving, **training), card, phase10_ms)
        log("[25] tiny ResNet config: predict and 2 SGD steps, CUDA vs CPU")
        phase_resnet_tiny(torch, dev)
        log("[26] run_net --task train and --task test on "
            "orcnn_r50_fpn_1x_dota.py at full width")
        r50_train, r50_test, k1_r50, k3_r50 = phase_resnet_train_task(
            torch, tmp, dict(serving, **training), card)
        log("[27] EQLv2 at full width: orcnn_r101_fpn_ms_flip_rotate_bc_le90_"
            "eqlv2.py, 2 steps, save, resume")
        phase_eqlv2(torch, tmp, card)
        log("[28] the overfit test on the card: per-class APs, float and "
            "int8")
        trained = phase_overfit(torch, dev, tmp, card)
        log("[29] dataset preparation: tools/preprocess.py on the card and "
            "on the CPU, then 2 training steps on its labels")
        scenes = phase_preprocess(torch, tmp, card)
        log("[30] raw-scene serving at full width: run_net --task test over "
            "a SceneDataset, dense and screened")
        scene_launches = phase_scene_task(torch, dev, tmp, scenes, serving,
                                          card, tile_file_tps)
        log("[31] the screened scene: train_screen, dense / thresh / budget "
            "serving with phase 28's detector")
        phase_screened_scene(torch, dev, tmp, card, *trained)

    csrc = "rs_detection_tpu_torch/csrc/"
    jops = "rs_detection_tpu/ops/"

    def entry(name, source, replaces, n_launches, res, library_ms=None,
              **also):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": res[0], "ms": res[1], "plain_ms": res[2],
                "bound_ms": res[3][0], "bound_by": res[3][1],
                "library_ms": library_ms, **also}

    kernels = [
        entry("van_mlp", "van_mlp_wgmma.cu", jops + "pallas_van_mlp.py:68",
              launches["van_mlp"], k2,
              test_task_launches=test_launches["van_mlp"],
              val_task_launches=val_task_launches["van_mlp"],
              scene_task_launches=scene_launches["van_mlp"]),
        entry("roi_align_rotated_pyramid", "roi_align_rotated_fwd.cu",
              jops + "pallas_roi_align.py:116",
              launches["roi_align_rotated_pyramid"], k1,
              step_like_ms=k1_step_ms, serving_ms=k1_serving_ms,
              test_task_launches=test_launches["roi_align_rotated_pyramid"],
              train_task_launches=train_task_launches[
                  "roi_align_rotated_pyramid"],
              val_task_launches=val_task_launches[
                  "roi_align_rotated_pyramid"],
              resnet_train_task_launches=r50_train[
                  "roi_align_rotated_pyramid"],
              resnet_test_task_launches=r50_test[
                  "roi_align_rotated_pyramid"],
              resnet_ms=k1_r50[0], resnet_plain_ms=k1_r50[1],
              resnet_bound_ms=k1_r50[2][0],
              scene_task_launches=scene_launches[
                  "roi_align_rotated_pyramid"]),
        entry("roi_align_rotated_pyramid_bwd", "roi_align_rotated_bwd.cu",
              jops + "pallas_roi_align.py:721",
              train_launches["roi_align_rotated_pyramid_bwd"], k3,
              step_like_ms=k3_step_ms,
              train_task_launches=train_task_launches[
                  "roi_align_rotated_pyramid_bwd"],
              resnet_train_task_launches=r50_train[
                  "roi_align_rotated_pyramid_bwd"],
              resnet_ms=k3_r50[0], resnet_plain_ms=k3_r50[1],
              resnet_bound_ms=k3_r50[2][0]),
        entry("dw_wgrad", "dw_wgrad.cu", jops + "pallas_dw_wgrad.py:41",
              train_launches["dw_wgrad"], k6, k6[4],
              train_task_launches=train_task_launches["dw_wgrad"]),
        entry("van_attn", "van_attn_wgmma.cu", jops + "pallas_van_attn.py:89",
              fused_launches["van_attn"], k4),
        entry("van_mlp_residual", "van_mlp_wgmma.cu",
              jops + "pallas_van_mlp.py:303",
              fused_launches["van_mlp_residual"], k2r),
        entry("van_mlp_int8", "van_mlp_int8_wgmma.cu",
              jops + "pallas_van_mlp.py:68",
              int8_launches["van_mlp_int8"], k2q),
        entry("van_mlp_residual_int8", "van_mlp_int8_wgmma.cu",
              jops + "pallas_van_mlp.py:68",
              int8_fused_launches["van_mlp_residual_int8"], k2qr),
        entry("depthwise_conv2d", "dw_conv_fwd_stream.cu",
              jops + "pallas_dwconv.py:27",
              fused_launches["depthwise_conv2d"], k5, k5[4],
              graph_ms=k5[5]),
        entry("dw_chw", "dw_conv_chw.cu",
              "tools/analysis_tools/chw_dw_proto.py:25", k7_launches, k7,
              k7[4]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
