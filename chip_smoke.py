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
     on the scene's ground truth. It trains in a child process of this
     script with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, under
     ``torch.use_deterministic_algorithms`` and no cuDNN autotuning, so
     every run trains the same bits (their sha256 printed) and the gates
     decide one outcome; no other phase runs with that variable. The
     trained runner comes back to phase 31 through ``Runner.save`` /
     ``Runner.load``
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
 32. the tiny RoI-Transformer, KFIoU RoI-Transformer and FasterRCNN-OBB
     (``tests/test_networks_smoke.py:94-125``'s ResNet-18 models with the
     zoo's freezing): ``predict`` and two SGD steps on CUDA (K1 / K3 in
     stage 2) against the CPU, f32, both sides sampling the first
     candidates by index, at phase 5's and phase 9's tolerances; two K1
     launches on the stage-2 rois bit for bit
 33. the RoI-Transformer at full width: ``run_net --task train`` on
     ``projects/roi_transformer/configs/faster_rcnn_RoITrans_r50_fpn_1x_dota.py``
     (JDet's legacy-schema RoI Transformer: ResNet-50, FPN-256, 2000
     proposals, 512 rois a stage, f32, batch 2) over 8 seeded 1024^2
     tiles with 42 boxes each (4 steps), then ``--task test`` with the
     DOTA merge over 4 scene tiles; checks losses (stage-1 and stage-2
     bbox losses above 0), results and K1 1 / K3 1 launches a step, K1 1
     a test forward; prints ms/step, peak memory, tiles/s, the merge's
     seconds; K1 on one test forward's 4,000 stage-2 rois (against its
     plain version, bit for bit twice) and K3 on one step's 1,024 against
     their plain versions and bounds, and the plain horizontal RoIAlign's
     time and memory on the 4,000 stage-1 rois beside K1's
 34. FasterRCNN-OBB at full width: ``projects/faster_rcnn/configs/
     faster_rcnn_obb_r50_fpn_1x_dota.py``, 2 train steps and 2 test tiles;
     K1 and K3 never launch; prints ms/step and peak memory
 35. the tiny S2ANet (``tests/test_s2anet.py:16-27``'s ResNet-18 model
     with the zoo's freezing): ``predict`` and two SGD steps on CUDA
     against the CPU, f32, at phase 5's and 9's tolerances; the
     deformable conv's forward and gradients, the ARF weights and RIP,
     ``multiclass_nms_rotated_jit`` on 3,000 x 15 candidates and the
     blocked rotated IoU, card against CPU
 36. S2ANet at full width: ``run_net --task train`` on
     ``configs/s2anet_r50_fpn_1x_dota.py`` (ResNet-50, FPN-256
     ``on_input`` from C2, 15 classes, f32, batch 2) over 8 seeded 1024^2
     tiles with 42 boxes each in 512 slots (4 steps), then ``--task
     test`` with the DOTA merge over 4 scene tiles from the checkpoint,
     its ODM prior lifted so that the random head detects; checks losses,
     results, no kernel launch; prints ms/step, peak memory, tiles/s, the
     merge's seconds, and at the path's shapes the plain deformable conv
     and ``ORConv2d`` at level 0, one FAM and one ODM target round and
     ``multiclass_nms_rotated_jit`` on one tile's candidates
 37. ``projects/s2anet/configs/s2anet_r50_fpn_1x_dota_bs8.py``: two
     ``train_step``s at batch 8, 1024^2, 512 slots; prints ms/step, the
     peak memory (below the card's) and one FAM round's
 38. the tiny Gliding Vertex (``tests/test_torch_gliding_cuda.py``):
     ``predict`` and two SGD steps on CUDA against the CPU, f32, both
     samplers taking the first candidates by index, at phase 5's and 9's
     tolerances; ``GVFixCoder`` on 4096 axis-aligned quads bit for bit
     (the first of two tied vertices on both), ``GVRatioCoder`` within
     its f32 bound
 39. Gliding Vertex at full width: ``run_net --task train`` on
     ``projects/gliding/configs/gliding_r50_fpn_1x_dota_with_flip_rotate_
     balance_cate.py`` (ResNet-50, FPN-256, the hbb RPN with 261,888
     anchors a tile, 512 roi slots, f32, batch 2, ``RandomRotateAug``,
     ``balance_category``) over 2 seeded 1024^2 tiles, balanced to a
     copy for each class they hold, then ``--task test`` with the DOTA
     merge over 4 scene tiles; checks losses, results, no kernel launch;
     prints ms/step, peak memory, tiles/s, the merge's seconds and the
     plain horizontal RoIAlign's time on one test forward's rois
 40. the tiny RetinaNet (``tests/test_torch_retinanet_cuda.py``) with the
     modern ``bbox_head`` and the legacy ``rpn_net`` of
     ``projects/retinanet``: ``predict`` and three ``GradMutilpySGD``
     steps with the YangXue groups on CUDA against the CPU, f32:
     detections, losses, every parameter, the frozen stem
 41. RetinaNet at full width: ``run_net --task train`` on
     ``projects/retinanet/configs/retinanet_r50v1d_fpn_dota.py``
     (ResNet-50-v1d, FPN-256 from C3, 126 rotated anchors a position,
     1,681,218 a tile at 800^2, f32, ``GradMutilpySGD`` with the YangXue
     groups; the train batch cut from 3 to 1, 2 steps, no pretrained
     weights) over 2 seeded tiles, then ``--task test`` over 4 tiles at
     batch 4 (cut from 32) from the checkpoint, the classifier's prior
     lifted; checks losses, results, no kernel launch, the frozen stem
     unmoved; prints ms/step, peak memory, one target round's share of
     a step, tiles/s, the merge's seconds and the NMS kept count
 42-45. FCOS and R3Det: the tiny networks CUDA against the CPU and
     their zoo configs' train and test tasks at full width (``phase_fcos_
     tiny``, ``phase_fcos_task``, ``phase_r3det_tiny``,
     ``phase_r3det_task``)
 46. the tiny SSD (``tests/test_torch_ssd_cuda.py``: VGG-16 on 96^2
     tiles, the neck padded on every extra level, 3 classes):
     ``predict`` and two SGD steps on CUDA against the CPU, f32, at
     phase 5's and 9's tolerances, the inputs' assignment and
     hard-negative margins above 1e-5
 47. SSD at full width: ``run_net --task train`` on
     ``projects/ssd/configs/ssd300_coco.py`` (VGG-16 + L2Norm, the SSD
     neck, the multibox head, 39,202,226 parameters, 10,765 anchors at
     300^2, f32, SGD) at the config's batch 32 over 96 rendered
     COCO-format 300^2 images (3 steps, 512 slots), then ``--task val``
     (``COCODataset.evaluate``) and ``--task test`` at batch 1 from the
     checkpoint with the classifier spread; the dataset sections covered
     with the JAX ``COCODataset``'s keys and ``img_size=300``; no kernel
     launches; ``ssd300_coco_test.py`` builds and takes one step; prints
     ms/step, peak memory, the target round's and the hard-negative
     mining's time at batch 32, images/s and one image's NMS time
Each phase prints its seconds and the card's peak memory since its
start; a phase that raises prints ``phase N failed: <type>: <message>``
and its traceback to stderr, and the script stops with exit code 1. The
whole run's seconds come on a line before the JSON lines.
Then prints one JSON line of per-kernel results (time, plain time, the
card's bound for the same work, the library call's time where PyTorch
has one; K1's and K3's time on the step-like rois, K1's on a serving
request's, K5's in a CUDA graph; K1's and K2's launches in phase 22's
test task, K1's, K3's and K6's in phase 24's train task, K1's and K2's in
its val task and in phase 30's scene task, ``scene_task_launches``;
K1's and K3's launches in phase 26's tasks and their
times, plain times and bounds at its shapes, ``resnet_*``, and the same
for phase 33's RoI-Transformer tasks, ``roitrans_*``; every kernel's
launches in phase 36's S2ANet tasks, ``s2anet_*_launches``, phase 39's
Gliding Vertex tasks, ``gliding_*_launches``, phase 41's RetinaNet
tasks, ``retinanet_*_launches``, phases 43 and 45's ``fcos_*`` and
``r3det_*_launches`` and phase 47's SSD train, val and test tasks,
``ssd_*_launches``, all 0), the
card's name and power limit, and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
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
ROITRANS_TILES = 8  # phase 33: 4 steps of batch 2
S2ANET_TILES = 8  # phase 36: 4 steps of batch 2
GLIDING_TILES = 2  # phase 39: balanced to one copy a class and more
FCOS_TILES = 6  # phase 43: 3 steps of batch 2
R3DET_TILES = 2  # phase 45: 2 steps of batch 1
SSD_TRAIN = 96  # phase 47: 3 steps of the config's batch 32
SSD_VAL = 8
SSD_TEST = 8
SSD_CLASSES = 80
# the transforms of the FCOS recipe, for the R3Det config, which has no
# dataset section
NORMALIZE = dict(type="Normalize", mean=[123.675, 116.28, 103.53],
                 std=[58.395, 57.12, 57.375], to_bgr=False)
R3DET_TRAIN = [dict(type="RotatedResize", min_size=1024, max_size=1024),
               dict(type="RotatedRandomFlip", prob=0.5),
               dict(type="Pad", size_divisor=32), NORMALIZE]
R3DET_TEST = [dict(type="RotatedResize", min_size=1024, max_size=1024),
              dict(type="Pad", size_divisor=32), NORMALIZE]
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


def run_phase(torch, n, title, fn):
    """Phase ``n``: its title, then ``fn()``, then its seconds and the
    card's peak memory in it (each phase starts from freed memory and a
    reset peak; a phase that resets the peak itself shows the peak
    since then). A raise prints ``phase N failed: <type>: <message>`` and
    the traceback to stderr and goes on up: the script stops with exit
    code 1, nothing carries on."""
    import gc
    import traceback

    log(f"[{n}] {title}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = fn()
    except BaseException as e:
        line = f"phase {n} failed: {type(e).__name__}: " + \
            " ".join(str(e).split())
        log(line)
        print(line, file=sys.stderr, flush=True)
        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()
        raise
    log(f"  phase {n}: {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (since the "
        f"phase's last reset of the peak)")
    return out


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


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms (cuBLAS's among them need
    ``CUBLAS_WORKSPACE_CONFIG`` set before torch first touches the card)
    and no cuDNN autotuning inside the block, the earlier settings back
    after it."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.backends.cudnn.benchmark = was[1]


def params_digest(model):
    """sha256 of every parameter and buffer's bytes, in state_dict order."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


OVERFIT_CHILD = "--overfit-child"


def overfit_child(root):
    """Phase 28's training and gates, in a process of its own whose
    ``CUBLAS_WORKSPACE_CONFIG`` the parent set: TF32 off as phase 1 sets
    it, then ``deterministic``. Logs the phase's line, saves the trained
    runner and leaves (checkpoint, dataset, config) in
    ``root/trained.pkl``."""
    import copy
    import pickle

    import torch

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_overfit_map as overfit

    from rs_detection_tpu_torch.config import get_cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    os.makedirs(root)
    os.chdir(root)  # submit_zips/ is cwd-relative
    t0 = time.perf_counter()
    with deterministic(torch):
        runner, ds_dir = overfit.trained_runner(root, torch.device("cuda", 0))
        digest = params_digest(runner.model)
        out = overfit.check_trained(runner, ds_dir, int8=True)
    log(f"  overfit, Resnet18 Oriented R-CNN (tests/test_runner.py:"
        f"_tiny_cfg, SGD lr 0.001), 400 steps on 4 rendered 128^2 tiles in "
        f"{time.perf_counter() - t0:.1f} s: APs float "
        + ", ".join(f"{k} {v:.4f}" for k, v in out["aps"].items())
        + "; int8 serving " + ", ".join(
            f"{k} {v:.4f}" for k, v in out["aps_int8"].items())
        + f" (gates: >= 0.3, int8 within 0.05); merged scene detections on "
        f"{out['matched'][0]} of {out['matched'][1]} ground truths (gate "
        f"40%); trained parameters sha256 {digest}; cuBLAS workspace "
        f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')} [{card}]")
    with open(os.path.join(root, "trained.pkl"), "wb") as f:
        pickle.dump((runner.save(), ds_dir,
                     copy.deepcopy(get_cfg().dump())), f)


def phase_overfit(torch, dev, tmp, card):
    """The torch form of the JAX overfit test on the card: 200 epochs of
    the tiny ResNet config on rendered tiles, per-class APs float and
    int8, merged scene detections (``tests/test_torch_overfit_map.py``),
    under ``deterministic``: the same bits, so the same APs, in every
    run. It runs in a child process (``overfit_child``), the only one
    with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which deterministic cuBLAS
    needs and which slows some of cuBLAS's products elsewhere
    (``rs_detection_tpu_torch/tools/cublas_workspace.py``). Returns the
    trained runner, loaded here from the child's checkpoint, its
    rendered dataset and a copy of its config (phase 31 serves a scene
    with it)."""
    import pickle

    from rs_detection_tpu_torch.config import get_cfg
    from rs_detection_tpu_torch.runner.runner import Runner

    root = os.path.join(tmp, "overfit")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           OVERFIT_CHILD, root], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        log(line)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-20000:])
        raise AssertionError(f"the overfit child exited {proc.returncode}")
    with open(os.path.join(root, "trained.pkl"), "rb") as f:
        ckpt, ds_dir, saved_cfg = pickle.load(f)
    cfg = get_cfg()
    cfg.clear()
    cfg.update(saved_cfg)
    runner = Runner(device=dev)
    runner.load(ckpt)
    digest = params_digest(runner.model)
    log(f"  the trained runner loaded here from {os.path.basename(ckpt)}: "
        f"sha256 {digest}")
    if f"sha256 {digest}" not in proc.stdout:
        raise AssertionError("the loaded runner is not the child's")
    return runner, ds_dir, saved_cfg


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


def phase_roitrans_tiny(torch, dev):
    """The tiny RoI-Transformer, KFIoU RoI-Transformer and FasterRCNN-OBB
    (``tests/test_networks_smoke.py:94-125``'s models: ResNet-18 with the
    zoo's freezing as phase 25's, 32-wide FPN with ``on_input`` extra
    convs, hbb RPN, cascade head): ``predict``
    and two SGD steps on CUDA (K1 / K3 in stage 2) against the CPU (plain
    versions), f32, from one seed. No sampler takes every candidate of a
    cascade's stage 2 (``num`` + G candidates for ``num`` slots), so both
    sides sample the first candidates by index
    (``tests/test_torch_roitrans_cuda.py:first_k_sample``). Then two K1
    launches on the stage-2 rois of the CUDA predict, bit for bit and
    against the plain version."""
    from test_torch_roitrans_cuda import (TINY_KINDS, first_k_sample,
                                          run_tiny, tiny_inputs, tiny_model)

    from rs_detection_tpu_torch.flagship import init_weights, normalize
    from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
    from rs_detection_tpu_torch.ops import roi_align as ra
    from rs_detection_tpu_torch.utils.registry import MODELS, build_from_cfg

    tiles, targets = tiny_inputs()
    sample = RandomSampler.sample
    RandomSampler.sample = first_k_sample
    try:
        for kind in sorted(TINY_KINDS):
            _, p_cpu, l_cpu = run_tiny(kind, "cpu", tiles, targets)
            _, p_gpu, l_gpu = run_tiny(kind, dev, tiles, targets)
            if not torch.equal(p_cpu["valid"], p_gpu["valid"].cpu()):
                raise AssertionError(f"tiny {kind} predict: valid masks "
                                     f"differ")
            errs = {key: (p_gpu[key].cpu() - p_cpu[key]).abs().max().item()
                    for key in ("polys", "scores")}
            worst, where = max(
                (abs(g_[k] - c[k]) / max(abs(c[k]), 1e-6), f"{k}, step {i}")
                for i, (g_, c) in enumerate(zip(l_gpu, l_cpu), 1)
                for k in c if "loss" in k)
            log(f"  tiny {kind}, CUDA vs CPU: predict polys max_abs_err "
                f"{errs['polys']:.3e} (atol 1e-2), scores "
                f"{errs['scores']:.3e} (atol 1e-5), phase 5's; 2 SGD steps, "
                f"losses worst relative error {worst:.2e} ({where}; "
                f"tolerance 1e-4, phase 9's); losses {l_gpu[-1]}")
            if not (errs["polys"] <= 1e-2 and errs["scores"] <= 1e-5
                    and worst <= 1e-4):
                raise AssertionError(f"tiny {kind}: CUDA and CPU differ")
            if not all(math.isfinite(v) for v in l_gpu[-1].values()):
                raise AssertionError(f"tiny {kind}: losses {l_gpu[-1]}")
    finally:
        RandomSampler.sample = sample
    model = build_from_cfg(tiny_model("roitrans"), MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    model.to(dev).eval()
    x = normalize(tiles.to(dev))
    seen = captured_roi_calls(torch, lambda: model.predict(x))
    if len(seen) != 1:
        raise AssertionError(f"tiny RoI-Transformer: {len(seen)} rotated "
                             f"RoI extractor calls in a predict")
    fs, rois = seen[0]
    a = ra.roi_align_rotated_pyramid_cuda(fs, rois)
    b = ra.roi_align_rotated_pyramid_cuda(fs, rois)
    compare(f"K1 on {rois.shape[0]} stage-2 rois of the tiny cascade, C=32, "
            f"f32", a, ra.roi_align_rotated_pyramid_reference(fs, rois),
            "float32")
    if not torch.equal(a, b):
        raise AssertionError("K1 on stage-2 rois: two launches differ")
    log("  K1 on the stage-2 rois: two launches equal bit for bit")


class _CaptureExtractor:
    """Stands in for a head's horizontal extractor and keeps the
    (features, rois) of each call."""

    def __init__(self, ext):
        self.ext = ext
        self.seen = []

    def __call__(self, feats, rois):
        self.seen.append(([f.detach().clone() for f in feats],
                          rois.detach().clone()))
        return self.ext(feats, rois)


def train_task(torch, tmp, kernels, config, n_train, n_test, tag,
               train=None, test=None, **extra):
    """``run_net --task train`` over ``n_train`` seeded 1024^2 tiles with
    42 boxes each at the config's batch (``config``: the path's parts
    under the repository), the wrappers' launches counted over the task;
    also writes ``n_test`` scene tiles for ``test_task``. ``train`` /
    ``test``: more keys of those dataset sections, ``extra`` more
    top-level entries of the written config. Returns (runner, launches,
    seconds, peak bytes, the seeded targets, the written config, work
    dir). ``extra`` may hold a ``merge_cfg`` in place of the DOTA one."""
    from rs_detection_tpu_torch.flagship import make_targets
    from rs_detection_tpu_torch.tools import run_net

    names = [f"{tag}{i:02d}.png" for i in range(n_train)]
    t = make_targets(n_train, TILE, MAX_GT,
                     torch.Generator().manual_seed(33))
    ds = write_labelled(os.path.join(tmp, f"{tag}_train"), names, TILE, 33,
                        t["rboxes"].numpy(), t["labels"].numpy())
    tiles = os.path.join(tmp, f"{tag}_test")
    write_tiles(tiles, [f"S0__1.0__{x}___{y}.png"
                        for x, y in SCENE_OFFSETS[:n_test]], TILE, 34)
    work = os.path.join(tmp, f"{tag}_work")
    base = os.path.join(ROOT, *config)
    cfg = write_config(
        os.path.join(tmp, f"{tag}_chip.py"), _base_=base,
        allow_random_init=True, max_epoch=1, log_interval=1,
        checkpoint_interval=1, work_dir=work,
        dataset=dict(train=dict(dataset_dir=ds, **(train or {})), val=None,
                     test=dict(images_dir=tiles, **(test or {}))),
        merge_cfg=extra.pop("merge_cfg", dict(dataset_type="DOTA")), **extra)
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
        launches = {k: fn.launches for k, fn in kernels.items()}
    finally:
        os.chdir(cwd)
    return runner, launches, t_train, peak, t, cfg, work


def test_task(torch, tmp, kernels, cfg):
    """``run_net --task test`` with the DOTA merge on ``train_task``'s
    config, from its checkpoint, the wrappers' launches counted over the
    task. Returns (tester, launches, seconds)."""
    from rs_detection_tpu_torch.tools import run_net

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        tester = run_net.main(["--config-file", cfg, "--task", "test"])
        t_test = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
    finally:
        os.chdir(cwd)
    return tester, launches, t_test


def train_test_task(torch, tmp, kernels, config, n_train, n_test, tag):
    """``train_task`` then ``test_task`` on its checkpoint. Returns
    (runner, tester, train launches, test launches, train seconds, test
    seconds, train peak bytes, the seeded targets, work dir)."""
    runner, train_launches, t_train, peak, t, cfg, work = train_task(
        torch, tmp, kernels, config, n_train, n_test, tag)
    tester, test_launches, t_test = test_task(torch, tmp, kernels, cfg)
    return (runner, tester, train_launches, test_launches, t_train, t_test,
            peak, t, work)


def check_task_losses(runner, steps, bbox_keys, what, optimizer="SGD"):
    hist = runner.history
    if len(hist) != steps or type(runner.optimizer).__name__ != optimizer:
        raise AssertionError(f"{what}: {len(hist)} records, "
                             f"{type(runner.optimizer).__name__}")
    for rec in hist:
        losses = {k: v for k, v in rec.items() if "loss" in k}
        if not (all(math.isfinite(v) for v in losses.values())
                and all(losses[k] > 0 for k in bbox_keys)):
            raise AssertionError(f"{what}: losses {rec}")
    step_ms = sorted(1e3 * x for x in runner.train_stats["step_s"][1:])
    log("  losses, first and last step: " + ", ".join(
        f"{k} {hist[0][k]:.4f} -> {hist[-1][k]:.4f}" for k in hist[0]
        if "loss" in k))
    return step_ms


def check_test_results(np, tester, work, n_tiles, what):
    import pickle

    with open(os.path.join(work, "test", "test_1.pkl"), "rb") as f:
        results = pickle.load(f)
    if tester.epoch != 1 or len(results) != n_tiles or not all(
            np.isfinite(p).all() and np.isfinite(s).all()
            for (p, s, _), _ in results):
        raise AssertionError(f"{what}: bad results")
    after = os.path.join(work, "test", "submit_1", "after_nms")
    return read_rows(os.path.join(after, n) for n in os.listdir(after))


def phase_roitrans_task(torch, tmp, kernels, card):
    """``run_net --task train`` then ``--task test`` on
    ``projects/roi_transformer/configs/faster_rcnn_RoITrans_r50_fpn_1x_dota.py``
    at full width (ResNet-50, FPN-256, 2000 proposals, 512 rois per
    stage, f32 as written, batch 2; 8 tiles = 4 steps, then 4 test tiles
    at the config's test batch with the merge); K1 and K3 on this path's stage-2 rois against their
    plain versions and bounds, the plain horizontal RoIAlign on its
    stage-1 rois beside K1. Returns (train launches, test launches, K1
    (ms, plain ms, bound), K3 (ms, plain ms, bound))."""
    import numpy as np

    from rs_detection_tpu_torch.flagship import normalize
    from rs_detection_tpu_torch.ops import roi_align as ra

    steps, n_test = ROITRANS_TILES // 2, 4
    config = ("projects", "roi_transformer", "configs",
              "faster_rcnn_RoITrans_r50_fpn_1x_dota.py")
    (runner, tester, train_launches, test_launches, t_train, t_test, peak,
     t, work) = train_test_task(torch, tmp, kernels, config,
                                 ROITRANS_TILES, n_test, "rt")
    want = dict.fromkeys(kernels, 0)
    want.update(roi_align_rotated_pyramid=steps,
                roi_align_rotated_pyramid_bwd=steps)
    if train_launches != want:
        raise AssertionError(f"RoI-Transformer train task launches "
                             f"{train_launches}, expected {want}")
    step_ms = check_task_losses(
        runner, steps, ("loss_rpn_bbox", "rbbox_reg_loss_1",
                        "rbbox_reg_loss_2"), "RoI-Transformer train task")
    dtypes = {p.dtype for p in runner.model.parameters()}
    if dtypes != {torch.float32} or runner.model.compute_dtype:
        raise AssertionError(f"RoI-Transformer train task: dtypes {dtypes}")
    log(f"  run_net --task train, ResNet-50 RoI-Transformer from "
        f"projects/roi_transformer/configs/faster_rcnn_RoITrans_r50_fpn_1x_"
        f"dota.py (f32, as written; legacy schema: FasterrcnnHead RPN, 2000 "
        f"proposals, two SharedFCBBoxHeadRbbox stages of 512 rois, 15 "
        f"classes, frozen stem and layer1; cut: {ROITRANS_TILES} seeded "
        f"tiles of {TILE}^2 with {MAX_GT} boxes, {steps} steps of batch 2, "
        f"random weights): {t_train:.1f} s whole task; ms/step through the "
        f"runner, median of steps 2-{steps}: {step_ms[len(step_ms) // 2]:.1f}"
        f" (min {step_ms[0]:.1f}, max {step_ms[-1]:.1f}); loader wait "
        f"{runner.train_stats['loader_wait_s']:.2f} s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    log(f"  launches in the train task: {train_launches}")

    batch = tester.test_dataset.batch_size
    forwards = -(-n_test // batch)
    want = dict.fromkeys(kernels, 0)
    want.update(roi_align_rotated_pyramid=forwards)
    if test_launches != want:
        raise AssertionError(f"RoI-Transformer test task launches "
                             f"{test_launches}, expected {want}")
    n_out = check_test_results(np, tester, work, n_test,
                               "RoI-Transformer test task")
    stats = tester.test_stats
    log(f"  run_net --task test from ckpt_1.pkl: {n_test} tiles at batch "
        f"{batch} (the config's) in {stats['inference_s']:.3f} s = "
        f"{n_test / stats['inference_s']:.2f} tiles/s of inference; merge "
        f"{stats['merge_s']:.3f} s; detections {stats['detections']} in, "
        f"{n_out} after NMS; whole task {t_test:.1f} s [{card}]")
    log(f"  launches in the test task: {test_launches}")

    # this path's rois: stage 1's hbbs and stage 2's rotated boxes
    model = runner.model
    del runner, tester
    x = normalize(torch.randint(
        0, 256, (2, TILE, TILE, 3), dtype=torch.uint8,
        generator=torch.Generator().manual_seed(35)).to("cuda"))
    tgt = {k: v[:2].to("cuda") for k, v in t.items()}
    hcap = _CaptureExtractor(model.bbox_head.h_extractor)
    model.bbox_head.h_extractor = hcap
    fwd = captured_roi_calls(torch, lambda: model.eval().predict(x))
    model.bbox_head.h_extractor = hcap.ext
    with torch.no_grad():
        step = captured_roi_calls(torch, lambda: model.train().loss(
            x, tgt, torch.Generator(device="cuda").manual_seed(0)))
        # the hbb RPN's proposals: a host sync per NMS sweep
        model.eval()
        outs = model.rpn(model.extract_feats(x))
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.rpn.get_proposals(*outs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    log(f"    hbb RPN get_proposals, batch 2 (5 levels, nms_pre 2000, cap "
        f"4096, Jacobi NMS): {1e3 * sorted(times)[1]:.1f} ms host, median "
        f"of 3 [{card}]")
    del model, outs
    torch.cuda.empty_cache()
    if len(fwd) != 1 or len(step) != 1 or len(hcap.seen) != 1:
        raise AssertionError("RoI-Transformer path: the RoI extractor calls "
                             "differ")
    out = []
    for what, (fs, rois) in (("K1, one test forward's stage 2", fwd[0]),
                             ("K3, one training step's stage 2", step[0])):
        if what.startswith("K1"):
            got = ra.roi_align_rotated_pyramid_cuda(fs, rois)
            compare(f"{what}: {rois.shape[0]} rotated rois, C=256, f32", got,
                    ra.roi_align_rotated_pyramid_reference(fs, rois),
                    "float32")
            if not torch.equal(got, ra.roi_align_rotated_pyramid_cuda(
                    fs, rois)):
                raise AssertionError("K1 on stage-2 rois: two launches "
                                     "differ")
            t_k = cuda_ms(lambda: ra.roi_align_rotated_pyramid_cuda(
                fs, rois), 10)
            t_p = cuda_ms(lambda: ra.roi_align_rotated_pyramid_reference(
                fs, rois), 3)
            b = bound(nbytes(*fs, rois, got), 0.0, 32.0 * got.numel())
        else:
            grad = torch.randn(rois.shape[0], 7, 7, fs[0].shape[-1],
                               generator=torch.Generator(
                                   device="cuda").manual_seed(36),
                               device="cuda")
            compare(f"{what}: {rois.shape[0]} rotated rois, C=256, f32",
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
    fs, rois = hcap.seen[0]
    ext = hcap.ext
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ext(fs, rois)
    torch.cuda.synchronize()
    h_peak = torch.cuda.max_memory_allocated() - base
    t_h = cuda_ms(lambda: ext(fs, rois), 3)
    log(f"    plain horizontal RoIAlign (stage 1, each roi at its level, "
        f"{1024} rois a chunk): {rois.shape[0]} hbb rois, C=256, f32, "
        f"{t_h:.3f} ms, {h_peak / 2**30:.2f} GiB above its inputs; K1 on "
        f"the same number of rotated rois {out[0][0]:.3f} ms [{card}]")
    return train_launches, test_launches, out[0], out[1]


def phase_faster_rcnn_obb(torch, tmp, kernels, card):
    """``run_net --task train`` (2 steps of batch 2) and ``--task test``
    (2 tiles) on ``projects/faster_rcnn/configs/
    faster_rcnn_obb_r50_fpn_1x_dota.py`` at full width: its one stage
    pools on the horizontal RoIAlign, so no kernel launches."""
    import numpy as np

    config = ("projects", "faster_rcnn", "configs",
              "faster_rcnn_obb_r50_fpn_1x_dota.py")
    (runner, tester, train_launches, test_launches, t_train, t_test, peak,
     _, work) = train_test_task(torch, tmp, kernels, config, 4, 2, "fo")
    want = dict.fromkeys(kernels, 0)
    if train_launches != want or test_launches != want:
        raise AssertionError(f"FasterRCNN-OBB launches {train_launches}, "
                             f"{test_launches}; expected none")
    step_ms = check_task_losses(runner, 2, ("loss_rpn_bbox",
                                            "rbbox_reg_loss_1"),
                                "FasterRCNN-OBB train task")
    n_out = check_test_results(np, tester, work, 2, "FasterRCNN-OBB test "
                               "task")
    stats = tester.test_stats
    log(f"  FasterRCNN-OBB (ResNet-50, f32, one shared-FC stage on the "
        f"horizontal RoIAlign): 2 steps of batch 2 in {t_train:.1f} s whole "
        f"task, ms/step of step 2 {step_ms[-1]:.1f}, peak memory "
        f"{peak / 2**30:.2f} GiB; test 2 tiles in "
        f"{stats['inference_s']:.3f} s of inference, {n_out} detections "
        f"after NMS; launches {train_launches} / {test_launches} [{card}]")

def phase_s2anet_tiny(torch, dev):
    """The tiny S2ANet (``tests/test_s2anet.py:16-27``'s model with the
    zoo's freezing; ``tests/test_torch_s2anet_cuda.py:run_tiny``):
    ``predict`` and two SGD steps on the card against the CPU, f32, one
    seed; then the deformable conv (forward and both gradients), the ARF
    weights and RIP, ``multiclass_nms_rotated_jit`` on one tile's 3,000
    candidates and the blocked rotated IoU, each on the card against the
    CPU at the tolerance stated beside it."""
    from test_torch_s2anet_cuda import (DCN_RTOL, LOSS_RTOL, POLY_ATOL,
                                        SCORE_ATOL, dcn_fwd_bwd, dcn_inputs,
                                        nms_inputs, run_tiny, tiny_inputs)

    from rs_detection_tpu_torch.models.roi_heads.s2anet_head import ORConv2d
    from rs_detection_tpu_torch.ops import orn
    from rs_detection_tpu_torch.ops.nms_rotated import \
        multiclass_nms_rotated_jit
    from rs_detection_tpu_torch.ops.rotated_iou import box_iou_rotated

    tiles, targets = tiny_inputs()
    _, p_cpu, l_cpu = run_tiny("cpu", tiles, targets)
    _, p_gpu, l_gpu = run_tiny(dev, tiles, targets)
    if not (torch.equal(p_cpu["valid"], p_gpu["valid"].cpu())
            and torch.equal(p_cpu["labels"], p_gpu["labels"].cpu())):
        raise AssertionError("tiny S2ANet predict: valid slots or labels "
                             "differ")
    errs = {key: (p_gpu[key].cpu() - p_cpu[key]).abs().max().item()
            for key in ("polys", "scores")}
    worst, where = max(
        (abs(g_[k] - c[k]) / max(abs(c[k]), 1e-6), f"{k}, step {i}")
        for i, (g_, c) in enumerate(zip(l_gpu, l_cpu), 1) for k in c)
    log(f"  tiny S2ANet, CUDA vs CPU: {int(p_cpu['valid'].sum())} "
        f"detections; polys max_abs_err {errs['polys']:.3e} (atol "
        f"{POLY_ATOL}), scores {errs['scores']:.3e} (atol {SCORE_ATOL}); 2 "
        f"SGD steps, losses worst relative error {worst:.2e} ({where}; "
        f"tolerance {LOSS_RTOL}); losses {l_gpu[-1]}")
    if not (p_cpu["valid"].sum() > 4 and errs["polys"] <= POLY_ATOL
            and errs["scores"] <= SCORE_ATOL and worst <= LOSS_RTOL
            and all(math.isfinite(v) for v in l_gpu[-1].values())):
        raise AssertionError("tiny S2ANet: CUDA and CPU differ")
    got = dcn_fwd_bwd(*dcn_inputs(dev))
    want = dcn_fwd_bwd(*dcn_inputs("cpu"))
    rel = [((a.cpu() - b).abs().max() / b.abs().max()).item()
           for a, b in zip(got, want)]
    log(f"  deform_conv2d [2, 40, 48, 64] -> 32, CUDA vs CPU: output, "
        f"d input, d weight relative errors {rel[0]:.2e}, {rel[1]:.2e}, "
        f"{rel[2]:.2e} (tolerance {DCN_RTOL})")
    if max(rel) > DCN_RTOL:
        raise AssertionError("deform_conv2d: CUDA and CPU differ")
    m = ORConv2d(64, 8)
    with torch.no_grad():
        m.weight.normal_(generator=torch.Generator().manual_seed(39))
    x = torch.randn(2, 9, 10, 64, generator=torch.Generator().manual_seed(40))
    if not (torch.equal(m.to(dev).rotated_weight().cpu(),
                        m.cpu().rotated_weight())
            and torch.equal(orn.rotation_invariant_pooling(x.to(dev)).cpu(),
                            orn.rotation_invariant_pooling(x))):
        raise AssertionError("ARF / RIP: CUDA and CPU differ")
    b, sc = nms_inputs("cpu")
    ref = multiclass_nms_rotated_jit(b, sc, 0.05, 0.1)
    out = multiclass_nms_rotated_jit(b.to(dev), sc.to(dev), 0.05, 0.1)
    det_err = (out[0].cpu() - ref[0]).abs().max().item()
    log(f"  ARF weights and RIP: CUDA equals CPU; multiclass_nms_rotated_jit "
        f"on 3,000 x 15 candidates: {int(ref[2].sum())} kept, slots and "
        f"labels equal, dets max_abs_err {det_err:.2e} (atol 1e-3 px)")
    if not (torch.equal(out[2].cpu(), ref[2])
            and torch.equal(out[1].cpu(), ref[1]) and det_err <= 1e-3):
        raise AssertionError("multiclass_nms_rotated_jit: CUDA and CPU "
                             "differ")
    bd = b.to(dev)[:900]
    whole = box_iou_rotated(bd, bd[:311])
    if not all(torch.equal(box_iou_rotated(bd, bd[:311], pair_block=k),
                           whole) for k in (1, 1000)):
        raise AssertionError("box_iou_rotated: blocks change bits on the "
                             "card")
    iou_err = (whole.cpu() - box_iou_rotated(b[:900], b[:311])).abs().max()
    log(f"  box_iou_rotated on the card: blocks of 1 and 1,000 pairs equal "
        f"one block bit for bit; CUDA vs CPU max_abs_err {iou_err:.2e} "
        f"(atol 1e-5)")
    if iou_err > 1e-5:
        raise AssertionError("box_iou_rotated: CUDA and CPU differ")


def lift_odm_prior(path, key="bbox_head.odm_cls_out.bias"):
    """Set the classifier's bias ``key`` (S2ANet's ODM classifier by
    default) of the checkpoint at ``path`` to 0 (scores near 0.5 instead
    of the 0.01 prior), so that a random-weight single-stage network
    detects up to its ``max_per_img`` a tile, as a trained one does, and
    the merge sees that volume."""
    import pickle

    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    ckpt["model"][key][...] = 0.0
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)


def timed_host(torch, fn, reps=3):
    """Median host seconds of ``fn`` over ``reps`` synchronized calls,
    and its last result."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def phase_s2anet_task(torch, tmp, kernels, card):
    """``run_net --task train`` then ``--task test`` on
    ``configs/s2anet_r50_fpn_1x_dota.py`` at full width (JDet's S2ANet
    recipe: ResNet-50, FPN-256 ``on_input`` from C2, 15 classes, f32 as
    written, batch 2): 8 seeded 1024^2 tiles with 42 boxes (4 steps), then
    4 test tiles at the config's batch 2 with the DOTA merge, from the
    checkpoint with the ODM prior lifted (``lift_odm_prior``). No kernel
    launches: ``kernels`` holds every wrapper. Then the path's pieces at
    its shapes, on the test task's model and its first batch of tiles:
    the plain deformable conv at level 0 (forward, forward and backward),
    ``ORConv2d`` there, one FAM and one ODM target round against the
    seeded ground truths in 512 slots, ``multiclass_nms_rotated_jit`` on
    the first tile's candidates as ``get_bboxes`` calls it, which must
    keep some. Returns (train launches, test launches)."""
    import numpy as np

    from rs_detection_tpu_torch.models.boxes.anchor_target import \
        anchor_target_single
    from rs_detection_tpu_torch.ops.deform_conv import deform_conv2d
    from rs_detection_tpu_torch.ops.nms_rotated import \
        multiclass_nms_rotated_jit

    steps, n_test = S2ANET_TILES // 2, 4
    runner, train_launches, t_train, peak, t, cfg, work = train_task(
        torch, tmp, kernels, ("configs", "s2anet_r50_fpn_1x_dota.py"),
        S2ANET_TILES, n_test, "s2")
    lift_odm_prior(os.path.join(work, "checkpoints", "ckpt_1.pkl"))
    tester, test_launches, t_test = test_task(torch, tmp, kernels, cfg)
    none = dict.fromkeys(kernels, 0)
    if train_launches != none or test_launches != none:
        raise AssertionError(f"S2ANet launches {train_launches}, "
                             f"{test_launches}; expected none")
    step_ms = check_task_losses(runner, steps, ("loss_fam_bbox",
                                                "loss_odm_bbox"),
                                "S2ANet train task")
    dtypes = {p.dtype for p in runner.model.parameters()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"S2ANet train task: dtypes {dtypes}")
    log(f"  run_net --task train, S2ANet from configs/s2anet_r50_fpn_1x_"
        f"dota.py (ResNet-50, FPN-256 on_input from C2, level 0 256^2, 15 "
        f"classes, f32 as written; cut: {S2ANET_TILES} seeded tiles of "
        f"{TILE}^2 with {MAX_GT} boxes in 512 slots, {steps} steps of batch "
        f"2, random weights): {t_train:.1f} s whole task; ms/step through "
        f"the runner, median of steps 2-{steps}: "
        f"{step_ms[len(step_ms) // 2]:.1f} (min {step_ms[0]:.1f}, max "
        f"{step_ms[-1]:.1f}); loader wait "
        f"{runner.train_stats['loader_wait_s']:.2f} s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    batch = tester.test_dataset.batch_size
    n_out = check_test_results(np, tester, work, n_test, "S2ANet test task")
    stats = tester.test_stats
    log(f"  run_net --task test from ckpt_1.pkl (ODM prior lifted): {n_test} "
        f"tiles at batch {batch} (the config's) in "
        f"{stats['inference_s']:.3f} s = "
        f"{n_test / stats['inference_s']:.2f} tiles/s of inference; merge "
        f"{stats['merge_s']:.3f} s; detections {stats['detections']} in, "
        f"{n_out} after NMS; whole task {t_test:.1f} s; launches "
        f"{train_launches} / {test_launches} [{card}]")
    if stats["detections"] == 0:
        raise AssertionError("S2ANet test task: no detection")

    model = tester.model
    head = model.bbox_head
    images, _, _ = next(iter(tester.test_dataset.batches()))
    del runner, tester
    x = torch.as_tensor(images, device="cuda")
    tgt = {k: v[:2].to("cuda") for k, v in t.items()}
    gt = torch.zeros(2, 512, 5, device="cuda")
    gt[:, :MAX_GT] = tgt["rboxes"]
    gt_mask = torch.zeros(2, 512, dtype=torch.bool, device="cuda")
    gt_mask[:, :MAX_GT] = True
    labels = torch.zeros(2, 512, dtype=torch.long, device="cuda")
    labels[:, :MAX_GT] = tgt["labels"]
    model.eval()
    with torch.no_grad():
        feats = model.extract_feats(x)
        outs = head(feats, train=False)
    f0, r0 = feats[0], outs[2][0]
    off = head.align_conv.offsets(r0, head.anchor_strides[0])
    wt = head.align_conv.weight.detach()
    xg = f0.detach().clone().requires_grad_()
    wg = wt.clone().requires_grad_()
    grad = torch.randn(*f0.shape[:3], wt.shape[0], device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(
                           42))

    def dcn_step():
        out = deform_conv2d(xg, off, wg)
        out.backward(grad)
        return out

    with torch.no_grad():
        t_fwd = cuda_ms(lambda: deform_conv2d(f0, off, wt), 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_fb = cuda_ms(dcn_step, 3)
    dcn_peak = torch.cuda.max_memory_allocated() - base
    xg.grad = wg.grad = None
    with torch.no_grad():
        align = head.align_conv(f0, r0, head.anchor_strides[0])
        a_nchw = align.permute(0, 3, 1, 2)
        t_or = cuda_ms(lambda: head.or_conv(a_nchw), 5)
        init_anchors = torch.cat([head.anchors(i, p.shape[1:3], "cuda")
                                  for i, p in enumerate(outs[1])])
        refined = torch.cat([r.reshape(2, -1, 5) for r in outs[2]], 1)
        rounds = {}
        for what, anchors in (("FAM", init_anchors), ("ODM", refined)):
            inside = torch.ones(anchors.shape[-2], dtype=torch.bool,
                                device="cuda")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            sec, res = timed_host(torch, lambda: anchor_target_single(
                anchors, inside, gt, gt_mask, labels, head.assigner,
                head.sampler, head.coder.encode, None))
            rounds[what] = (sec, torch.cuda.max_memory_allocated() - base,
                            int(res.num_pos.sum()))
        boxes, scores = head.candidates(outs, 0, torch.ones((), device="cuda"))

        def nms():
            return multiclass_nms_rotated_jit(
                boxes, scores, head.score_thr, head.nms_iou_thr,
                pre_nms=min(2000, scores.shape[0] * head.cls_out_channels),
                max_num=head.max_per_img)

        kept = int(nms()[2].sum())
        if kept == 0:
            raise AssertionError("S2ANet: NMS kept nothing of the first test "
                                 "tile's candidates")
        t_nms, _ = timed_host(torch, nms)
    pairs = init_anchors.shape[0] * 2 * 512
    log(f"    plain deform_conv2d at level 0 ({list(f0.shape)} NHWC -> "
        f"{wt.shape[0]}, 3x3, f32): forward {t_fwd:.2f} ms, forward and "
        f"backward {t_fb:.2f} ms, {dcn_peak / 2**30:.2f} GiB above its "
        f"inputs; ORConv2d there {t_or:.2f} ms (CUDA events) [{card}]")
    log(f"    target rounds at batch 2, 512 slots ({pairs / 1e6:.1f} M pairs, "
        f"blocks of 2^21): " + "; ".join(
            f"{k} {1e3 * v[0]:.1f} ms host, {v[1] / 2**30:.2f} GiB above its "
            f"inputs, {v[2]} positives" for k, v in rounds.items())
        + f" [{card}]")
    log(f"    multiclass_nms_rotated_jit on the first test tile's "
        f"{boxes.shape[0]} candidates x {scores.shape[1] - 1} classes, the "
        f"test task's model: {1e3 * t_nms:.1f} ms host, median of 3, {kept} "
        f"kept [{card}]")
    return train_launches, test_launches


def phase_s2anet_bs8(torch, card):
    """Two ``train_step``s of ``projects/s2anet/configs/
    s2anet_r50_fpn_1x_dota_bs8.py`` at its batch 8 (ResNet-50, FPN-256
    from C3, 1024^2, 42 seeded boxes in 512 ground-truth slots, f32,
    random weights): the blocked rotated IoU keeps each target round's
    89.4 M pairs inside the card. Prints ms/step, the step's peak memory
    and one FAM round's peak."""
    from rs_detection_tpu_torch.config.config import Config
    from rs_detection_tpu_torch.flagship import (init_weights, make_targets,
                                                 normalize)
    from rs_detection_tpu_torch.models.boxes.anchor_target import \
        anchor_target_single
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel.train_step import train_step
    from rs_detection_tpu_torch.utils.registry import MODELS, build_from_cfg

    cfg = Config(os.path.join(ROOT, "projects", "s2anet", "configs",
                              "s2anet_r50_fpn_1x_dota_bs8.py"))
    b = cfg.dataset["train"]["batch_size"]
    model = build_from_cfg(cfg.model, MODELS)
    init_weights(model, torch.Generator().manual_seed(43))
    model.to("cuda")
    oc = dict(cfg.optimizer)
    oc.pop("type")
    opt = SGD(model.parameters(), **oc)
    sched = StepLR(**{k: v for k, v in cfg.scheduler.items() if k != "type"})
    g = torch.Generator(device="cuda").manual_seed(44)
    t = make_targets(b, TILE, MAX_GT, g)
    tgt = dict(rboxes=torch.zeros(b, 512, 5, device="cuda"),
               gt_mask=torch.zeros(b, 512, dtype=torch.bool, device="cuda"),
               labels=torch.zeros(b, 512, dtype=torch.long, device="cuda"))
    tgt["rboxes"][:, :MAX_GT] = t["rboxes"]
    tgt["gt_mask"][:, :MAX_GT] = True
    tgt["labels"][:, :MAX_GT] = t["labels"]
    x = normalize(torch.randint(0, 256, (b, TILE, TILE, 3), dtype=torch.uint8,
                                device="cuda", generator=g))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for step in range(2):
        t0 = time.perf_counter()
        out = train_step(model, opt, sched, x, tgt, None, epoch=0.0)
        losses.append({k: float(v) for k, v in out.items()})
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if not (all(math.isfinite(v) for d in losses for v in d.values())
            and losses[-1]["loss_fam_bbox"] > 0
            and losses[-1]["loss_odm_bbox"] > 0):
        raise AssertionError(f"bs8 S2ANet: losses {losses}")
    head = model.bbox_head
    with torch.no_grad():
        sizes = [(TILE // s, TILE // s) for s in head.anchor_strides]
        anchors = torch.cat([head.anchors(i, hw, "cuda")
                             for i, hw in enumerate(sizes)])
        inside = torch.ones(anchors.shape[0], dtype=torch.bool,
                            device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sec, res = timed_host(torch, lambda: anchor_target_single(
            anchors, inside, tgt["rboxes"], tgt["gt_mask"], tgt["labels"],
            head.assigner, head.sampler, head.coder.encode, None), reps=1)
        fam_peak = torch.cuda.max_memory_allocated() - base
    log(f"  s2anet_r50_fpn_1x_dota_bs8.py, batch {b}, {TILE}^2, 512 slots "
        f"({anchors.shape[0]} anchors a tile, "
        f"{anchors.shape[0] * b * 512 / 1e6:.1f} M pairs a round): 2 "
        f"train_steps {times[0]:.0f} / {times[1]:.0f} ms; peak "
        f"{peak / 2**30:.2f} GiB of {total / 2**30:.1f}; one FAM round "
        f"{1e3 * sec:.0f} ms, {fam_peak / 2**30:.2f} GiB above its inputs, "
        f"{int(res.num_pos.sum())} positives; losses {losses[-1]} [{card}]")
    if peak >= total:
        raise AssertionError("bs8 S2ANet: peak at the card's memory")


def phase_gliding_tiny(torch, dev):
    """The tiny Gliding Vertex (``tests/test_torch_gliding_cuda.py``:
    ResNet-18 with the zoo's freezing, a 32-wide FPN, the hbb RPN and the
    head with 16 roi slots): ``predict`` and two SGD steps on the card
    against the CPU, f32, one seed, both samplers taking the first
    candidates by index; then ``GVFixCoder`` and ``GVRatioCoder`` on 4096
    axis-aligned quads in every vertex order (two tied vertices on every
    side), the glides bit for bit, the ratios within their f32 bound."""
    from test_torch_gliding_cuda import (LOSS_RTOL, POLY_ATOL, SCORE_ATOL,
                                         aligned_quads, ratio_bound,
                                         run_tiny, tiny_inputs)

    from rs_detection_tpu_torch.models.boxes.coder import (GVFixCoder,
                                                           GVRatioCoder)

    tiles, targets = tiny_inputs()
    _, p_cpu, l_cpu = run_tiny("cpu", tiles, targets)
    _, p_gpu, l_gpu = run_tiny(dev, tiles, targets)
    if not torch.equal(p_cpu["valid"], p_gpu["valid"].cpu()):
        raise AssertionError("tiny Gliding Vertex predict: valid masks "
                             "differ")
    errs = {key: (p_gpu[key].cpu() - p_cpu[key]).abs().max().item()
            for key in ("polys", "scores")}
    worst, where = max(
        (abs(g_[k] - c[k]) / max(abs(c[k]), 1e-6), f"{k}, step {i}")
        for i, (g_, c) in enumerate(zip(l_gpu, l_cpu), 1) for k in c)
    log(f"  tiny Gliding Vertex, CUDA vs CPU: {int(p_cpu['valid'].sum())} "
        f"valid proposals; polys max_abs_err {errs['polys']:.3e} (atol "
        f"{POLY_ATOL}), scores {errs['scores']:.3e} (atol {SCORE_ATOL}); 2 "
        f"SGD steps, losses worst relative error {worst:.2e} ({where}; "
        f"tolerance {LOSS_RTOL}); losses {l_gpu[-1]}")
    if not (errs["polys"] <= POLY_ATOL and errs["scores"] <= SCORE_ATOL
            and worst <= LOSS_RTOL
            and all(math.isfinite(v) for v in l_gpu[-1].values())):
        raise AssertionError("tiny Gliding Vertex: CUDA and CPU differ")
    q = aligned_quads()
    fix_gpu = GVFixCoder().encode(q.to(dev)).cpu()
    err = (GVRatioCoder().encode(q.to(dev)).cpu()
           - GVRatioCoder().encode(q)).abs()
    rb = ratio_bound(q)
    log(f"  GVFixCoder on {q.shape[0]} axis-aligned quads: card equals CPU "
        f"bit for bit: {torch.equal(fix_gpu, GVFixCoder().encode(q))}; "
        f"GVRatioCoder max_abs_err {err.max().item():.2e}, at most "
        f"{(err / rb).max().item():.3f} of its f32 bound (ratio_bound)")
    if not torch.equal(fix_gpu, GVFixCoder().encode(q)) or (err > rb).any():
        raise AssertionError("GV coders on aligned quads: CUDA and CPU "
                             "differ")


def phase_gliding_task(torch, tmp, kernels, card):
    """``run_net --task train`` then ``--task test`` on
    ``projects/gliding/configs/gliding_r50_fpn_1x_dota_with_flip_rotate_
    balance_cate.py`` at full width (ResNet-50, FPN-256, the hbb RPN with
    261,888 anchors a tile, 2000 proposals, the head's 512 roi slots, f32
    as written, batch 2, ``RandomRotateAug`` and ``balance_category``):
    2 seeded 1024^2 tiles, balanced to one entry a class they hold and
    more (a step a pair), then 4 test tiles at the config's batch with
    the DOTA merge. No kernel launches: the horizontal
    RoIAlign is plain PyTorch in both packages. Then the plain horizontal
    RoIAlign's time on one test forward's rois. Returns (train launches,
    test launches)."""
    import numpy as np

    from rs_detection_tpu_torch.flagship import normalize

    n_test = 4
    config = ("projects", "gliding", "configs",
              "gliding_r50_fpn_1x_dota_with_flip_rotate_balance_cate.py")
    (runner, tester, train_launches, test_launches, t_train, t_test, peak,
     _, work) = train_test_task(torch, tmp, kernels, config, GLIDING_TILES,
                                n_test, "gv")
    # balance_category repeats a tile once per class it holds, times the
    # class's factor
    steps = -(-len(runner.train_dataset) // 2)
    none = dict.fromkeys(kernels, 0)
    if train_launches != none or test_launches != none:
        raise AssertionError(f"Gliding Vertex launches {train_launches}, "
                             f"{test_launches}; expected none")
    step_ms = check_task_losses(
        runner, steps, ("loss_rpn_bbox", "gliding_bbox_loss",
                        "gliding_fix_loss"), "Gliding Vertex train task")
    dtypes = {p.dtype for p in runner.model.parameters()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"Gliding Vertex train task: dtypes {dtypes}")
    log(f"  run_net --task train, Gliding Vertex from projects/gliding/"
        f"configs/gliding_r50_fpn_1x_dota_with_flip_rotate_balance_cate.py "
        f"(ResNet-50, FPN-256, GlidingRPNHead 3 anchors x 87,296 positions, "
        f"2000 proposals, GlidingHead 512 rois, 15 classes, f32 as written, "
        f"RandomRotateAug, balance_category; cut: {GLIDING_TILES} seeded "
        f"tiles of {TILE}^2 with {MAX_GT} boxes in 512 slots, balanced to "
        f"{len(runner.train_dataset)}, {steps} steps of batch 2, random "
        f"weights): {t_train:.1f} s whole task; ms/step "
        f"through the runner, median of steps 2-{steps}: "
        f"{step_ms[len(step_ms) // 2]:.1f} (min {step_ms[0]:.1f}, max "
        f"{step_ms[-1]:.1f}); loader wait "
        f"{runner.train_stats['loader_wait_s']:.2f} s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    batch = tester.test_dataset.batch_size
    n_out = check_test_results(np, tester, work, n_test,
                               "Gliding Vertex test task")
    stats = tester.test_stats
    log(f"  run_net --task test from ckpt_1.pkl: {n_test} tiles at batch "
        f"{batch} (the config's) in {stats['inference_s']:.3f} s = "
        f"{n_test / stats['inference_s']:.2f} tiles/s of inference; merge "
        f"{stats['merge_s']:.3f} s; detections {stats['detections']} in, "
        f"{n_out} after NMS; whole task {t_test:.1f} s; launches "
        f"{train_launches} / {test_launches} [{card}]")
    model = tester.model
    del runner, tester
    x = normalize(torch.randint(
        0, 256, (batch, TILE, TILE, 3), dtype=torch.uint8,
        generator=torch.Generator().manual_seed(45)).to("cuda"))
    cap = _CaptureExtractor(model.bbox_head.extractor)
    model.bbox_head.extractor = cap
    model.eval().predict(x)
    model.bbox_head.extractor = cap.ext
    if len(cap.seen) != 1:
        raise AssertionError("Gliding Vertex: the RoI extractor calls differ")
    fs, rois = cap.seen[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        cap.ext(fs, rois)
        torch.cuda.synchronize()
        h_peak = torch.cuda.max_memory_allocated() - base
        t_h = cuda_ms(lambda: cap.ext(fs, rois), 3)
    log(f"    plain horizontal RoIAlign on one test forward (batch "
        f"{batch}): {rois.shape[0]} hbb rois, C=256, f32, {t_h:.3f} ms, "
        f"{h_peak / 2**30:.2f} GiB above its inputs [{card}]")
    return train_launches, test_launches


def phase_retina_tiny(torch, dev):
    """The tiny RetinaNet (``tests/test_torch_retinanet_cuda.py``:
    ResNet-18 with running statistics, a 32-wide FPN from C3) in both head
    forms, the modern ``bbox_head`` and the legacy ``rpn_net`` of
    ``projects/retinanet``: ``predict`` (the classifier spread) and three
    ``GradMutilpySGD`` steps with the recipe's YangXue links (conv biases'
    gradients x 2 and decay 0 inside the clip, the stem frozen), on the
    card against the CPU, f32, one seed: detections, losses and every
    parameter, and the stem where it started."""
    from test_torch_retinanet_cuda import (FORMS, LOSS_RTOL, PARAM_ATOL,
                                           POLY_ATOL, SCORE_ATOL, STEM,
                                           compare, run_tiny, tiny_inputs,
                                           tiny_model)

    from rs_detection_tpu_torch.flagship import init_weights
    from rs_detection_tpu_torch.utils.registry import MODELS, build_from_cfg

    tiles, targets = tiny_inputs()
    for form in FORMS:
        cpu = run_tiny(form, "cpu", tiles, targets)
        gpu = run_tiny(form, dev, tiles, targets)
        same = (torch.equal(cpu[1]["valid"], gpu[1]["valid"].cpu())
                and torch.equal(cpu[1]["labels"], gpu[1]["labels"].cpu()))
        err = compare(cpu, gpu)
        fresh = build_from_cfg(tiny_model(form), MODELS)
        init_weights(fresh, torch.Generator().manual_seed(3))
        stem = all(torch.equal(gpu[0].state_dict()[k].cpu(),
                               fresh.state_dict()[k]) for k in STEM)
        log(f"  tiny RetinaNet ({form} head, "
            f"{gpu[0].bbox_head.num_anchors} anchors a position), CUDA vs "
            f"CPU: {int(cpu[1]['valid'].sum())} detections, slots and labels "
            f"equal {same}; polys max_abs_err {err['polys']:.3e} (atol "
            f"{POLY_ATOL}), scores {err['scores']:.3e} (atol {SCORE_ATOL}); 3 "
            f"GradMutilpySGD + YangXue steps: losses worst relative error "
            f"{err['losses']:.2e} (tolerance {LOSS_RTOL}), parameters "
            f"max_abs_err {err['params']:.2e} (atol {PARAM_ATOL}); stem "
            f"unmoved {stem}; losses {gpu[2][-1]}")
        if not (same and stem and err["polys"] <= POLY_ATOL
                and err["scores"] <= SCORE_ATOL
                and err["losses"] <= LOSS_RTOL
                and err["params"] <= PARAM_ATOL
                and int(cpu[1]["valid"].sum()) > 4
                and all(math.isfinite(v) for v in gpu[2][-1].values())):
            raise AssertionError(f"tiny RetinaNet ({form}): CUDA and CPU "
                                 f"differ")


def phase_retina_task(torch, tmp, kernels, card):
    """``run_net --task train`` then ``--task test`` on
    ``projects/retinanet/configs/retinanet_r50v1d_fpn_dota.py`` at full
    width (ResNet-50-v1d, FPN-256 from C3 with ReLU'd ``on_output`` extra
    convs, the legacy ``rpn_net``: 7 ratios x 3 octave scales x 6 angles
    = 126 anchors a position, 1,681,218 a tile at 800^2; f32;
    ``GradMutilpySGD`` with the YangXue groups). Cut: the train batch 3
    to 1, 2 seeded tiles (2 steps, 42 boxes in 512 slots), the test batch
    32 to 4 with 4 tiles, random weights (no ``pretrained_weights``), the
    classifier's prior lifted in the checkpoint so that the test task
    detects. No kernel launches. Then, on the trained model: the frozen
    stem where the seed put it, one target round at batch 1 against 512
    slots (its share of a step), and ``multiclass_nms_rotated_jit`` on
    the first test tile's candidates. Returns (train launches, test
    launches)."""
    import numpy as np

    from rs_detection_tpu_torch.config.config import Config
    from rs_detection_tpu_torch.flagship import init_weights
    from rs_detection_tpu_torch.models.boxes.anchor_target import \
        anchor_target_single
    from rs_detection_tpu_torch.ops.nms_rotated import \
        multiclass_nms_rotated_jit
    from rs_detection_tpu_torch.utils.registry import MODELS, build_from_cfg

    n_train, n_test = 2, 4
    config = ("projects", "retinanet", "configs",
              "retinanet_r50v1d_fpn_dota.py")
    runner, train_launches, t_train, peak, t, cfg, work = train_task(
        torch, tmp, kernels, config, n_train, n_test, "rn",
        train=dict(batch_size=1), test=dict(batch_size=4),
        pretrained_weights=None)
    lift_odm_prior(os.path.join(work, "checkpoints", "ckpt_1.pkl"),
                   "bbox_head.retina_cls.bias")
    tester, test_launches, t_test = test_task(torch, tmp, kernels, cfg)
    none = dict.fromkeys(kernels, 0)
    if train_launches != none or test_launches != none:
        raise AssertionError(f"RetinaNet launches {train_launches}, "
                             f"{test_launches}; expected none")
    step_ms = check_task_losses(runner, n_train, ("loss_bbox",),
                                "RetinaNet train task", "GradMutilpySGD")
    model = runner.model
    fresh = build_from_cfg(Config(cfg).model, MODELS)
    init_weights(fresh, torch.Generator().manual_seed(runner.cfg.seed or 0))
    stem = [k for k in fresh.state_dict()
            if k.startswith(("backbone.Conv_", "backbone.Norm_"))
            and not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))]
    moved = [k for k in stem if not torch.equal(
        model.state_dict()[k].cpu(), fresh.state_dict()[k])]
    if not stem or moved or len(runner.optimizer.frozen) != len(stem):
        raise AssertionError(f"RetinaNet train task: the frozen stem moved "
                             f"({moved} of {stem})")
    head = model.bbox_head
    log(f"  run_net --task train, RetinaNet from projects/retinanet/configs/"
        f"retinanet_r50v1d_fpn_dota.py (ResNet-50-v1d, FPN-256 from C3, "
        f"legacy rpn_net: {head.num_anchors} anchors a position, 15 "
        f"classes, f32; GradMutilpySGD, YangXue groups; cut: {n_train} "
        f"seeded tiles of {TILE}^2 resized to 800^2 with {MAX_GT} boxes in "
        f"512 slots, {n_train} steps of batch 1 (the config's 3), random "
        f"weights): {t_train:.1f} s whole task; ms/step through the runner, "
        f"step 2: {step_ms[-1]:.1f}; loader wait "
        f"{runner.train_stats['loader_wait_s']:.2f} s; peak memory "
        f"{peak / 2**30:.2f} GiB; the stem's {len(stem)} tensors unmoved "
        f"[{card}]")
    n_out = check_test_results(np, tester, work, n_test, "RetinaNet test "
                               "task")
    stats = tester.test_stats
    log(f"  run_net --task test from ckpt_1.pkl (classifier prior lifted): "
        f"{n_test} tiles at batch 4 (the config's 32) in "
        f"{stats['inference_s']:.3f} s = "
        f"{n_test / stats['inference_s']:.2f} tiles/s of inference; merge "
        f"{stats['merge_s']:.3f} s; detections {stats['detections']} in, "
        f"{n_out} after NMS; whole task {t_test:.1f} s; launches "
        f"{train_launches} / {test_launches} [{card}]")
    if stats["detections"] == 0:
        raise AssertionError("RetinaNet test task: no detection")
    images, _, _ = next(iter(tester.test_dataset.batches()))
    test_model = tester.model
    del runner, tester
    x = torch.as_tensor(images[:1], device="cuda")
    gt = torch.zeros(1, 512, 5, device="cuda")
    gt[:, :MAX_GT] = t["rboxes"][:1].to("cuda") * (800 / TILE)
    gt[:, :MAX_GT, 4] = t["rboxes"][:1, :, 4].to("cuda")
    gt_mask = torch.zeros(1, 512, dtype=torch.bool, device="cuda")
    gt_mask[:, :MAX_GT] = True
    labels = torch.zeros(1, 512, dtype=torch.long, device="cuda")
    labels[:, :MAX_GT] = t["labels"][:1].to("cuda")
    with torch.no_grad():
        test_model.eval()
        outs = test_model.bbox_head(test_model.extract_feats(x))
        sizes = [tuple(c.shape[1:3]) for c in outs[0]]
        anchors = torch.cat([head.anchors(i, hw, "cuda")
                             for i, hw in enumerate(sizes)])
        inside = torch.ones(anchors.shape[0], dtype=torch.bool,
                            device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sec, res = timed_host(torch, lambda: anchor_target_single(
            anchors, inside, gt, gt_mask, labels, head.assigner,
            head.sampler, head.coder.encode, None), reps=1)
        round_peak = torch.cuda.max_memory_allocated() - base
        boxes, scores = test_model.bbox_head.candidates(
            outs, 0, torch.ones((), device="cuda"))
        th = test_model.bbox_head

        def nms():
            return multiclass_nms_rotated_jit(
                boxes, scores, th.score_thr, th.nms_iou_thr,
                pre_nms=min(2000, scores.shape[0] * th.cls_out_channels),
                max_num=th.max_per_img)

        kept = int(nms()[2].sum())
        t_nms, _ = timed_host(torch, nms)
    pairs = anchors.shape[0] * 512
    log(f"    one target round at batch 1, 512 slots ({anchors.shape[0]} "
        f"anchors, {pairs / 1e6:.1f} M rotated-IoU pairs, blocks of 2^21): "
        f"{1e3 * sec:.1f} ms host, {100 * 1e3 * sec / step_ms[-1]:.1f}% of "
        f"step 2, {round_peak / 2**30:.2f} GiB above its inputs, "
        f"{int(res.num_pos.sum())} positives [{card}]")
    log(f"    multiclass_nms_rotated_jit on the first test tile's "
        f"{boxes.shape[0]} candidates x {scores.shape[1] - 1} classes: "
        f"{1e3 * t_nms:.1f} ms host, median of 3, {kept} kept [{card}]")
    if kept == 0 or anchors.shape[0] != 1681218:
        raise AssertionError(f"RetinaNet: {kept} kept, {anchors.shape[0]} "
                             f"anchors")
    return train_launches, test_launches


def phase_fcos_tiny(torch, dev):
    """The tiny FCOS (``tests/test_torch_fcos_cuda.py``: ResNet-18 with
    running statistics, a 32-wide FPN from C2, the head at 32 channels
    on strides 4-64): ``predict`` (the classifier spread) and two SGD
    steps on the card against the CPU, f32, one seed, axis-aligned boxes;
    then the weighted poly-IoU and poly-GIoU losses and their gradients
    on ~3,900 box pairs held 1e-3 from every decision, and
    ``convex_sort`` on 4,096 sets of 24 points, card against CPU."""
    import numpy as np
    from test_torch_fcos_cuda import (LOSS_RTOL, POLY_ATOL, SCORE_ATOL,
                                      compare, poly_loss_fwd_bwd,
                                      poly_loss_inputs, run_tiny,
                                      tiny_inputs)

    from rs_detection_tpu_torch.ops.convex_sort import convex_sort

    tiles, targets = tiny_inputs()
    cpu = run_tiny("cpu", tiles, targets)
    gpu = run_tiny(dev, tiles, targets)
    same = (torch.equal(cpu[1]["valid"], gpu[1]["valid"].cpu())
            and torch.equal(cpu[1]["labels"], gpu[1]["labels"].cpu()))
    err = compare(cpu, gpu)
    log(f"  tiny FCOS, CUDA vs CPU: {int(cpu[1]['valid'].sum())} "
        f"detections, slots and labels equal {same}; polys max_abs_err "
        f"{err['polys']:.3e} (atol {POLY_ATOL}), scores {err['scores']:.3e} "
        f"(atol {SCORE_ATOL}); 2 SGD steps, losses worst relative error "
        f"{err['losses']:.2e} (tolerance {LOSS_RTOL}); losses {gpu[2][-1]}")
    if not (same and err["polys"] <= POLY_ATOL
            and err["scores"] <= SCORE_ATOL and err["losses"] <= LOSS_RTOL
            and int(cpu[1]["valid"].sum()) > 4
            and all(math.isfinite(v) for v in gpu[2][-1].values())):
        raise AssertionError("tiny FCOS: CUDA and CPU differ")
    pred, target, w = poly_loss_inputs()
    for giou in (False, True):
        lc, gc = poly_loss_fwd_bwd("cpu", pred, target, w, giou)
        lg, gg = poly_loss_fwd_bwd(dev, pred, target, w, giou)
        rel = abs(lg.item() - lc.item()) / abs(lc.item())
        g_rel = ((gg - gc).abs().max() / gc.abs().max()).item()
        log(f"  poly_{'giou' if giou else 'iou'}_loss on {len(pred)} pairs, "
            f"CUDA vs CPU: loss relative error {rel:.2e}, gradient "
            f"{g_rel:.2e} of its largest entry (tolerance 1e-5 each)")
        if rel > 1e-5 or g_rel > 1e-5:
            raise AssertionError("poly-IoU loss: CUDA and CPU differ")
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.uniform(-10, 10, (4096, 24, 2)).astype(
        np.float32))
    masks = torch.from_numpy(rng.rand(4096, 24) < 0.6)
    if not torch.equal(convex_sort(pts.to(dev), masks.to(dev)).cpu(),
                       convex_sort(pts, masks)):
        raise AssertionError("convex_sort: CUDA and CPU differ")
    log("  convex_sort on 4,096 sets of 24 points: card equals CPU")


def phase_fcos_task(torch, tmp, kernels, card):
    """``run_net --task train`` then ``--task test`` on
    ``configs/fcos/fcos_obb_r50_fpn_1x_dota.py`` at full width (ResNet-50,
    FPN-256 from C3 with ReLU'd ``on_output`` extra convs, the FCOS head:
    two towers of four GroupNorm convs at 256 channels on 5 levels,
    21,824 points a 1024^2 tile, 15 classes, the poly-IoU loss, f32 as
    written, batch 2): ``FCOS_TILES`` seeded tiles with 42 boxes in 512
    slots, then 4 test tiles at the config's batch 1 with the DOTA merge,
    from the checkpoint with the classifier's prior lifted. No kernel
    launches. Then, on the trained model and a batch of 2 tiles: the
    dense targets against 512 slots, the poly-IoU loss forward and
    backward on the batch's 43,648 points, the head's whole loss; on the
    test task's model ``multiclass_nms_rotated_jit`` on the first test
    tile's candidates.
    Returns (train launches, test launches)."""
    import numpy as np

    from rs_detection_tpu_torch.flagship import normalize
    from rs_detection_tpu_torch.models.losses.poly_iou_loss import \
        poly_iou_loss
    from rs_detection_tpu_torch.ops import box_ops as B
    from rs_detection_tpu_torch.ops.nms_rotated import \
        multiclass_nms_rotated_jit

    n_test = 4
    steps = FCOS_TILES // 2
    config = ("configs", "fcos", "fcos_obb_r50_fpn_1x_dota.py")
    runner, train_launches, t_train, peak, t, cfg, work = train_task(
        torch, tmp, kernels, config, FCOS_TILES, n_test, "fc")
    lift_odm_prior(os.path.join(work, "checkpoints", "ckpt_1.pkl"),
                   "bbox_head.conv_cls.bias")
    tester, test_launches, t_test = test_task(torch, tmp, kernels, cfg)
    none = dict.fromkeys(kernels, 0)
    if train_launches != none or test_launches != none:
        raise AssertionError(f"FCOS launches {train_launches}, "
                             f"{test_launches}; expected none")
    step_ms = check_task_losses(runner, steps, ("loss_bbox",),
                                "FCOS train task")
    log(f"  run_net --task train, FCOS from configs/fcos/"
        f"fcos_obb_r50_fpn_1x_dota.py (ResNet-50, FPN-256 from C3, FCOSHead "
        f"4 + 4 GroupNorm convs, 21,824 points a tile, 15 classes, poly-IoU "
        f"loss, f32 as written; cut: {FCOS_TILES} seeded tiles of {TILE}^2 "
        f"with {MAX_GT} boxes in 512 slots, {steps} steps of batch 2, random "
        f"weights): {t_train:.1f} s whole task; ms/step through the runner, "
        f"median of steps 2-{steps}: {step_ms[len(step_ms) // 2]:.1f} (min "
        f"{step_ms[0]:.1f}, max {step_ms[-1]:.1f}); loader wait "
        f"{runner.train_stats['loader_wait_s']:.2f} s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    n_out = check_test_results(np, tester, work, n_test, "FCOS test task")
    stats = tester.test_stats
    log(f"  run_net --task test from ckpt_1.pkl (classifier prior lifted): "
        f"{n_test} tiles at batch {tester.test_dataset.batch_size} (the "
        f"config's) in {stats['inference_s']:.3f} s = "
        f"{n_test / stats['inference_s']:.2f} tiles/s of inference; merge "
        f"{stats['merge_s']:.3f} s; detections {stats['detections']} in, "
        f"{n_out} after NMS; whole task {t_test:.1f} s; launches "
        f"{train_launches} / {test_launches} [{card}]")
    if stats["detections"] == 0:
        raise AssertionError("FCOS test task: no detection")
    model = runner.model
    head = model.bbox_head
    test_model = tester.model
    del tester
    g = torch.Generator(device="cuda").manual_seed(46)
    x = normalize(torch.randint(0, 256, (2, TILE, TILE, 3), dtype=torch.uint8,
                                device="cuda", generator=g))
    tgt = dict(rboxes=torch.zeros(2, 512, 5, device="cuda"),
               gt_mask=torch.zeros(2, 512, dtype=torch.bool, device="cuda"),
               labels=torch.zeros(2, 512, dtype=torch.long, device="cuda"))
    tgt["rboxes"][:, :MAX_GT] = t["rboxes"][:2].to("cuda")
    tgt["gt_mask"][:, :MAX_GT] = True
    tgt["labels"][:, :MAX_GT] = t["labels"][:2].to("cuda")
    model.train()
    with torch.no_grad():
        outs = head(model.extract_feats(x), train=True)
        sizes = [tuple(c.shape[1:3]) for c in outs[0]]
        points, strides, ranges = head.level_tensors(sizes, "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_tg, (labels, bbox_t) = timed_host(torch, lambda: head.targets(
            points, strides, ranges, tgt["rboxes"], tgt["gt_mask"],
            tgt["labels"]))
        tg_peak = torch.cuda.max_memory_allocated() - base
    reg4 = torch.cat([r.reshape(2, -1, 4) for r in outs[1]], 1) \
        * strides[None, :, None]
    th = torch.cat([r.reshape(2, -1, 1) for r in outs[2]], 1)
    pts = points.repeat(2, 1)
    pos = labels.reshape(-1) < head.num_classes
    tgt_boxes = B.distance2obb(pts, bbox_t.reshape(-1, 5))
    reg = torch.cat([reg4, th], -1).reshape(-1, 5)

    def poly_step():
        p = reg.clone().requires_grad_(True)
        loss = poly_iou_loss(B.distance2obb(pts, p), tgt_boxes,
                             weight=pos.float(), avg_factor=pos.sum())
        loss.backward()
        return loss.detach()

    t_poly, poly_val = timed_host(torch, poly_step)
    outs = [[o.detach().requires_grad_(True) for o in lv] for lv in outs]

    def head_loss():
        losses = head.loss(outs, tgt)
        sum(losses.values()).backward()
        return losses

    t_loss, losses = timed_host(torch, head_loss)
    losses = {k: round(v.item(), 4) for k, v in losses.items()}
    test_model.eval()
    with torch.no_grad():
        images, _, _ = next(iter(runner.test_dataset.batches()))
        xo = torch.as_tensor(images[:1], device="cuda")
        th = test_model.bbox_head
        ev = th(test_model.extract_feats(xo), train=False)
        boxes, scores, ctr = th.candidates(ev, 0, torch.ones(
            (), device="cuda"))

        def nms():
            return multiclass_nms_rotated_jit(
                boxes, scores, head.score_thr, head.nms_iou_thr,
                pre_nms=min(2000, scores.shape[0] * head.num_classes),
                max_num=head.max_per_img, score_factors=ctr)

        kept = int(nms()[2].sum())
        t_nms, _ = timed_host(torch, nms)
    med = step_ms[len(step_ms) // 2]
    log(f"    dense targets at batch 2, 512 slots ({points.shape[0]} points "
        f"a tile, {2 * points.shape[0] * 512 / 1e6:.1f} M point-box pairs): "
        f"{1e3 * t_tg:.1f} ms host, median of 3, "
        f"{100 * 1e3 * t_tg / med:.1f}% of the median step, "
        f"{tg_peak / 2**30:.2f} GiB above its inputs, {int(pos.sum())} "
        f"positives [{card}]")
    log(f"    poly_iou_loss forward + backward on the batch's "
        f"{pts.shape[0]} points ({int(pos.sum())} weighted): "
        f"{1e3 * t_poly:.1f} ms host, median of 3, "
        f"{100 * 1e3 * t_poly / med:.1f}% of the step, loss "
        f"{poly_val.item():.4f}; the head's whole loss forward + backward "
        f"{1e3 * t_loss:.1f} ms, {losses} [{card}]")
    log(f"    multiclass_nms_rotated_jit on the first test tile's "
        f"{boxes.shape[0]} candidates x {head.num_classes} classes, score "
        f"factors the centerness: {1e3 * t_nms:.1f} ms host, median of 3, "
        f"{kept} kept [{card}]")
    if kept == 0 or points.shape[0] != 21824 or not math.isfinite(
            poly_val.item()):
        raise AssertionError(f"FCOS: {kept} kept, {points.shape[0]} points")
    return train_launches, test_launches


def phase_r3det_tiny(torch, dev):
    """The tiny R3Det (``tests/test_torch_r3det_cuda.py``: ResNet-18 with
    running statistics, a 32-wide FPN from C3, a ``RetinaHead`` of 9
    anchors a position, the refine stage built from the first of two
    ``refine_heads`` and ``frm_cfgs``): ``predict`` (the refine classifier
    spread) and two SGD steps on the card against the CPU, f32, one seed,
    axis-aligned boxes; then ``feature_refine`` with 1 and 5 points and
    its backward (autograd's scatter-add) on boxes that span the border
    band, card against CPU."""
    from test_torch_r3det_cuda import (FR_ATOL, LOSS_RTOL, POLY_ATOL,
                                       SCORE_ATOL, compare, fr_fwd_bwd,
                                       fr_inputs, run_tiny, tiny_inputs)

    tiles, targets = tiny_inputs()
    cpu = run_tiny("cpu", tiles, targets)
    gpu = run_tiny(dev, tiles, targets)
    same = (torch.equal(cpu[1]["valid"], gpu[1]["valid"].cpu())
            and torch.equal(cpu[1]["labels"], gpu[1]["labels"].cpu()))
    err = compare(cpu, gpu)
    log(f"  tiny R3Det, CUDA vs CPU: {int(cpu[1]['valid'].sum())} "
        f"detections, slots and labels equal {same}; polys max_abs_err "
        f"{err['polys']:.3e} (atol {POLY_ATOL}), scores {err['scores']:.3e} "
        f"(atol {SCORE_ATOL}); 2 SGD steps, losses worst relative error "
        f"{err['losses']:.2e} (tolerance {LOSS_RTOL}); losses {gpu[2][-1]}")
    if not (same and err["polys"] <= POLY_ATOL
            and err["scores"] <= SCORE_ATOL and err["losses"] <= LOSS_RTOL
            and int(cpu[1]["valid"].sum()) > 4
            and all(math.isfinite(v) for v in gpu[2][-1].values())):
        raise AssertionError("tiny R3Det: CUDA and CPU differ")
    for points in (1, 5):
        feats, boxes = fr_inputs(seed=points)
        oc, gc = fr_fwd_bwd("cpu", feats, boxes, 0.5, points)
        og, gg = fr_fwd_bwd(dev, feats, boxes, 0.5, points)
        e_out = ((og - oc).abs().max() / oc.abs().max()).item()
        e_grad = ((gg - gc).abs().max() / gc.abs().max()).item()
        log(f"  feature_refine, {points} point(s), CUDA vs CPU: output "
            f"{e_out:.2e}, gradient {e_grad:.2e} of the largest entry "
            f"(tolerance {FR_ATOL})")
        if e_out > FR_ATOL or e_grad > FR_ATOL:
            raise AssertionError("feature_refine: CUDA and CPU differ")


def phase_r3det_task(torch, tmp, kernels, card):
    """``run_net --task train`` then ``--task test`` on
    ``projects/r3det/configs/r3det_r50_fpn_1x_dota.py`` at full width
    (ResNet-50, FPN-256 from C3, the ``RRetinaHead`` as a ``RetinaHead``
    of 7 ratios x 3 octave scales = 21 anchors a position, 458,304 a
    1024^2 tile, one refine stage of four convs a branch, the feature
    refine at one point, 15 classes, f32). The config has no dataset,
    optimizer or schedule section: the phase gives it seeded tiles with
    the FCOS recipe's transforms at batch 1 (cut), and both runners train
    it with their default SGD at 0.01; its JDet ``merge_cfg`` keys, which
    neither runner's merge takes, are covered by the DOTA merge.
    ``R3DET_TILES`` tiles with 42 boxes in 512 slots, then 4 test tiles at
    batch 1 from the checkpoint with the refine classifier's prior
    lifted. No kernel launches. Then, on the trained model: one
    first-stage target round at batch 1 against 512 slots (its share of a
    step) and the refine round, and ``feature_refine`` at level 0 (its
    forward, and forward with backward). Returns (train launches, test
    launches)."""
    import numpy as np

    from rs_detection_tpu_torch.models.boxes.anchor_target import \
        anchor_target_single
    from rs_detection_tpu_torch.ops.fr import feature_refine

    n_test = 4
    config = ("projects", "r3det", "configs", "r3det_r50_fpn_1x_dota.py")
    runner, train_launches, t_train, peak, t, cfg, work = train_task(
        torch, tmp, kernels, config, R3DET_TILES, n_test, "r3",
        train=dict(type="DOTADataset", batch_size=1, shuffle=False,
                   filter_empty_gt=False, transforms=R3DET_TRAIN),
        test=dict(type="ImageDataset", dataset_type="DOTA", batch_size=1,
                  transforms=R3DET_TEST),
        merge_cfg=dict(_cover_=True, dataset_type="DOTA"))
    lift_odm_prior(os.path.join(work, "checkpoints", "ckpt_1.pkl"),
                   "refine_head.out_cls.bias")
    tester, test_launches, t_test = test_task(torch, tmp, kernels, cfg)
    none = dict.fromkeys(kernels, 0)
    if train_launches != none or test_launches != none:
        raise AssertionError(f"R3Det launches {train_launches}, "
                             f"{test_launches}; expected none")
    step_ms = check_task_losses(runner, R3DET_TILES, ("loss_bbox",),
                                "R3Det train task")
    model = runner.model
    head = model.bbox_head
    log(f"  run_net --task train, R3Det from projects/r3det/configs/"
        f"r3det_r50_fpn_1x_dota.py (ResNet-50, FPN-256 from C3, RetinaHead "
        f"{head.num_anchors} anchors a position, one refine stage, feature "
        f"refine at 1 point, 15 classes, f32, the runner's default SGD; "
        f"cut: {R3DET_TILES} seeded tiles of {TILE}^2 with {MAX_GT} boxes "
        f"in 512 slots, {R3DET_TILES} steps of batch 1, random weights): "
        f"{t_train:.1f} s whole task; ms/step through the runner, step 2: "
        f"{step_ms[-1]:.1f}; loader wait "
        f"{runner.train_stats['loader_wait_s']:.2f} s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    n_out = check_test_results(np, tester, work, n_test, "R3Det test task")
    stats = tester.test_stats
    log(f"  run_net --task test from ckpt_1.pkl (refine classifier prior "
        f"lifted): {n_test} tiles at batch 1 in {stats['inference_s']:.3f} "
        f"s = {n_test / stats['inference_s']:.2f} tiles/s of inference; "
        f"merge {stats['merge_s']:.3f} s; detections "
        f"{stats['detections']} in, {n_out} after NMS; whole task "
        f"{t_test:.1f} s; launches {train_launches} / {test_launches} "
        f"[{card}]")
    if stats["detections"] == 0:
        raise AssertionError("R3Det test task: no detection")
    images, _, _ = next(iter(tester.test_dataset.batches()))
    del tester
    x = torch.as_tensor(images[:1], device="cuda")
    gt = torch.zeros(1, 512, 5, device="cuda")
    gt[:, :MAX_GT] = t["rboxes"][:1].to("cuda")
    gt_mask = torch.zeros(1, 512, dtype=torch.bool, device="cuda")
    gt_mask[:, :MAX_GT] = True
    labels = torch.zeros(1, 512, dtype=torch.long, device="cuda")
    labels[:, :MAX_GT] = t["labels"][:1].to("cuda")
    model.eval()
    with torch.no_grad():
        feats = model.extract_feats(x)
        outs = head(feats)
        sizes = [tuple(c.shape[1:3]) for c in outs[0]]
        anchors = torch.cat([head.anchors(i, hw, "cuda")
                             for i, hw in enumerate(sizes)])
        inside = torch.ones(anchors.shape[0], dtype=torch.bool,
                            device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sec, res = timed_host(torch, lambda: anchor_target_single(
            anchors, inside, gt, gt_mask, labels, head.assigner,
            head.sampler, head.coder.encode, None), reps=1)
        round_peak = torch.cuda.max_memory_allocated() - base
        refined = model.refined_anchors(outs[1])
        flat = torch.cat([r.reshape(1, -1, 5) for r in refined], 1)
        rh = model.refine_head
        r_sec, r_res = timed_host(torch, lambda: anchor_target_single(
            flat, torch.ones(flat.shape[:2], dtype=torch.bool,
                             device="cuda"), gt, gt_mask, labels,
            rh.assigner, rh.sampler, rh.coder.encode, None), reps=1)
        level0 = torch.randn(feats[0].shape, device="cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(47))
        scale = 1.0 / model.frm.featmap_strides[0]
        fr_ms = cuda_ms(lambda: feature_refine(level0, refined[0], scale),
                        10)

    def fr_step():
        f = level0.clone().requires_grad_(True)
        feature_refine(f, refined[0], scale).sum().backward()
        return f.grad

    fr_bwd_s, _ = timed_host(torch, fr_step)
    pairs = anchors.shape[0] * 512
    log(f"    one first-stage target round at batch 1, 512 slots "
        f"({anchors.shape[0]} anchors, {pairs / 1e6:.1f} M rotated-IoU "
        f"pairs, blocks of 2^21): {1e3 * sec:.1f} ms host, "
        f"{100 * 1e3 * sec / step_ms[-1]:.1f}% of step 2, "
        f"{round_peak / 2**30:.2f} GiB above its inputs, "
        f"{int(res.num_pos.sum())} positives; the refine round "
        f"({flat.shape[1]} refined boxes, "
        f"{flat.shape[1] * 512 / 1e6:.1f} M pairs): {1e3 * r_sec:.1f} ms, "
        f"{int(r_res.num_pos.sum())} positives [{card}]")
    log(f"    feature_refine at level 0 ({list(level0.shape)}, 1 point, "
        f"f32): {fr_ms:.3f} ms forward (CUDA events, mean of 10); forward "
        f"and backward {1e3 * fr_bwd_s:.2f} ms host, median of 3 [{card}]")
    if anchors.shape[0] != 458304 or not math.isfinite(fr_ms):
        raise AssertionError(f"R3Det: {anchors.shape[0]} anchors")
    return train_launches, test_launches


def phase_ssd_tiny(torch, dev):
    """The tiny SSD (``tests/test_torch_ssd_cuda.py``: VGG-16 at its fixed
    widths on 96^2 tiles, the neck padded on every extra level so that
    none is empty, 3 classes): ``predict`` (the classifier spread) and
    two SGD steps on the card against the CPU, f32, one seed; the
    inputs' assignment and hard-negative margins printed (both must
    stand above f32 rounding)."""
    from test_torch_ssd_cuda import (LOSS_RTOL, POLY_ATOL, SCORE_ATOL,
                                     assignment_margin, compare,
                                     mining_margin, run_tiny, tiny_inputs)

    from rs_detection_tpu_torch.flagship import normalize

    tiles, targets = tiny_inputs()
    cpu = run_tiny("cpu", tiles, targets)
    gpu = run_tiny(dev, tiles, targets)
    same = (torch.equal(cpu[1]["valid"], gpu[1]["valid"].cpu())
            and torch.equal(cpu[1]["labels"], gpu[1]["labels"].cpu()))
    err = compare(cpu, gpu)
    model = cpu[0].train()
    head = model.bbox_head
    with torch.no_grad():
        outs = head(model.extract_feats(normalize(tiles)))
    sizes = [tuple(c.shape[1:3]) for c in outs[0]]
    margins = (assignment_margin(head, targets["hboxes"],
                                 targets["gt_mask"], sizes),
               mining_margin(head, outs, targets))
    log(f"  tiny SSD (levels {[s[0] for s in sizes]}), CUDA vs CPU: "
        f"{int(cpu[1]['valid'].sum())} detections, slots and labels equal "
        f"{same}; polys max_abs_err {err['polys']:.3e} (atol {POLY_ATOL}), "
        f"scores {err['scores']:.3e} (atol {SCORE_ATOL}); 2 SGD steps, "
        f"losses worst relative error {err['losses']:.2e} (tolerance "
        f"{LOSS_RTOL}); losses {gpu[2][-1]}; assignment margin "
        f"{margins[0]:.2e}, hard-negative cut margin {margins[1]:.2e} "
        f"(relative)")
    if not (same and err["polys"] <= POLY_ATOL
            and err["scores"] <= SCORE_ATOL and err["losses"] <= LOSS_RTOL
            and int(cpu[1]["valid"].sum()) > 4 and min(margins) > 1e-5
            and all(math.isfinite(v) for v in gpu[2][-1].values())):
        raise AssertionError("tiny SSD: CUDA and CPU differ")


def spread_ssd_classifier(path, levels=6, seed=47):
    """In the checkpoint at ``path``, every level's ``cls_{i}`` bias: the
    background's -10, each class's N(0, 1) (seeded), so that a random
    SSD head scores its best class above the 0.02 threshold (a random
    one's softmax is near 1/81) and its NMS sees a trained head's
    volume."""
    import pickle

    import numpy as np

    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    rng = np.random.RandomState(seed)
    for i in range(levels):
        bias = ckpt["model"][f"bbox_head.cls_{i}.bias"]
        bias[...] = rng.randn(*bias.shape)
        bias[0::SSD_CLASSES + 1] = -10.0
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)


def phase_ssd_task(torch, tmp, kernels, card):
    """``projects/ssd/configs/ssd300_coco.py`` at full width through
    ``run_net``: VGG-16 with L2Norm, the SSD neck, the multibox head (80
    classes and the background, 10,765 anchors at 300^2), f32, SGD at the
    config's batch 32, over ``SSD_TRAIN`` rendered COCO-format 300^2
    images (one step per 32, 512 slots); then ``--task val`` (COCO
    ``evaluate``) over ``SSD_VAL`` images and ``--task test`` over
    ``SSD_TEST``, both at batch 1, from the checkpoint with the
    classifier spread (``spread_ssd_classifier``). The dataset sections
    are covered with the JAX ``COCODataset``'s own keys (the zoo's
    ``anno_file`` / ``root`` reach neither package's class) and
    ``img_size=300`` (the class letterboxes to 640 and ignores the
    transforms); the images are square, so the letterbox is the
    identity. No kernel launches. Then ``ssd300_coco_test.py`` builds and
    takes one step at its batch 1. Then, on the trained model at batch
    32: the target round (its host time and memory), the hard-negative
    mining, and on the test task's model one image's NMS. Returns the
    train, val and test launches."""
    import numpy as np
    from test_torch_ssd_cuda import render_coco

    from rs_detection_tpu_torch.tools import run_net

    config = os.path.join(ROOT, "projects", "ssd", "configs",
                          "ssd300_coco.py")
    sets = {}
    for split, n, seed in (("train", SSD_TRAIN, 47), ("val", SSD_VAL, 48),
                           ("test", SSD_TEST, 49)):
        sets[split] = render_coco(os.path.join(tmp, f"ssd_{split}"), n=n,
                                  size=300, seed=seed, objects=6)
    work = os.path.join(tmp, "ssd_work")

    def section(split, **kw):
        img_dir, ann = sets[split]
        return dict(_cover_=True, type="COCODataset", images_dir=img_dir,
                    annotations_file=ann, img_size=300, **kw)

    cfg = write_config(
        os.path.join(tmp, "ssd_chip.py"), _base_=config,
        allow_random_init=True, max_epoch=1, log_interval=1,
        checkpoint_interval=1, work_dir=work,
        dataset=dict(train=section("train", batch_size=32, shuffle=True),
                     val=section("val", batch_size=1),
                     test=section("test", batch_size=1)))
    cwd = os.getcwd()
    os.chdir(tmp)
    launches, seconds = {}, {}
    try:
        for task in ("train", "val", "test"):
            if task == "val":
                spread_ssd_classifier(os.path.join(work, "checkpoints",
                                                   "ckpt_1.pkl"))
            for fn in kernels.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = run_net.main(["--config-file", cfg, "--task", task])
            seconds[task] = time.perf_counter() - t0
            launches[task] = {k: fn.launches for k, fn in kernels.items()}
            if task == "train":
                runner, peak = out, torch.cuda.max_memory_allocated()
            elif task == "val":
                aps = dict(out.val_aps)
                del out
            else:
                tester = out
    finally:
        os.chdir(cwd)
    none = dict.fromkeys(kernels, 0)
    if any(v != none for v in launches.values()):
        raise AssertionError(f"SSD launches {launches}; expected none")
    model = runner.model
    head = model.bbox_head
    steps = SSD_TRAIN // 32
    step_ms = check_task_losses(runner, steps, ("loss_bbox",),
                                "SSD train task")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  run_net --task train, SSD from projects/ssd/configs/"
        f"ssd300_coco.py (VGG-16 + L2Norm, SSDNeck, SSDHead 81 classes, "
        f"{n_params:,} parameters, f32, SGD; dataset sections covered with "
        f"the JAX COCODataset's keys images_dir / annotations_file and "
        f"img_size=300: the zoo's anno_file / root reach neither class, "
        f"which letterboxes to 640 and ignores the transforms; cut: "
        f"{SSD_TRAIN} rendered COCO-format 300^2 images, 6 boxes each in "
        f"512 slots, {steps} steps of the config's batch 32, random "
        f"weights): {seconds['train']:.1f} s whole task; ms/step through "
        f"the runner, median of steps 2-{steps}: "
        f"{step_ms[len(step_ms) // 2]:.1f} (min {step_ms[0]:.1f}, max "
        f"{step_ms[-1]:.1f}); loader wait "
        f"{runner.train_stats['loader_wait_s']:.2f} s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    if n_params != 39202226:
        raise AssertionError(f"SSD300: {n_params} parameters")
    if not all(math.isfinite(v) for v in aps.values()) or \
            "eval/mAP" not in aps:
        raise AssertionError(f"SSD val task: {aps}")
    log(f"  run_net --task val from ckpt_1.pkl (classifier spread): "
        f"{SSD_VAL} images at batch 1 (cut from 2) through COCODataset."
        f"evaluate in {seconds['val']:.1f} s: mAP {aps['eval/mAP']:.4f}, "
        f"AP50 {aps['eval/AP50']:.4f} (a random head)")
    with open(os.path.join(work, "test", "test_1.pkl"), "rb") as f:
        results = __import__("pickle").load(f)
    stats = tester.test_stats
    if len(results) != SSD_TEST or stats["detections"] == 0 or not all(
            np.isfinite(p).all() and np.isfinite(s).all()
            and ((lab >= 1) & (lab <= 80)).all()
            for (p, s, lab), _ in results):
        raise AssertionError(f"SSD test task: bad results {stats}")
    log(f"  run_net --task test from ckpt_1.pkl: {SSD_TEST} images at batch "
        f"1 in {stats['inference_s']:.3f} s = "
        f"{SSD_TEST / stats['inference_s']:.2f} images/s of inference; "
        f"{stats['detections']} detections, labels 1-80; whole task "
        f"{seconds['test']:.1f} s; launches train / val / test "
        f"{launches['train']} / {launches['val']} / {launches['test']} "
        f"[{card}]")
    # the zoo's test config: its own batch 1, one step
    t0 = time.perf_counter()
    cfg_t = write_config(
        os.path.join(tmp, "ssd_test_chip.py"),
        _base_=os.path.join(ROOT, "projects", "ssd", "configs",
                            "ssd300_coco_test.py"),
        allow_random_init=True, max_epoch=1, max_iter=1, log_interval=1,
        checkpoint_interval=1, work_dir=os.path.join(tmp, "ssd_test_work"),
        dataset=dict(train=section("train", batch_size=1, shuffle=False),
                     val=None, test=None))
    os.chdir(tmp)
    try:
        one = run_net.main(["--config-file", cfg_t, "--task", "train"])
    finally:
        os.chdir(cwd)
    if len(one.history) != 1 or not all(
            math.isfinite(v) for k, v in one.history[0].items()
            if "loss" in k):
        raise AssertionError(f"ssd300_coco_test.py: {one.history}")
    log(f"  ssd300_coco_test.py: built, 1 step at its batch 1 in "
        f"{time.perf_counter() - t0:.1f} s, losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in one.history[0].items()
                    if "loss" in k))
    del one
    # the target round and the mining at batch 32, 512 slots
    images, tg, _ = next(iter(runner.train_dataset.batches(seed=0)))
    x = torch.as_tensor(images, device="cuda")
    tgt = {k: torch.as_tensor(v, device="cuda") for k, v in tg.items()}
    model.train()
    with torch.no_grad():
        outs = head(model.extract_feats(x), train=True)
        sizes = [tuple(c.shape[1:3]) for c in outs[0]]
        anchors = head.anchors(sizes, "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_tg, res = timed_host(torch, lambda: head.targets(anchors, tgt))
        tg_peak = torch.cuda.max_memory_allocated() - base
        cls = torch.cat([c.reshape(32, -1, head.num_classes)
                         for c in outs[0]], 1).float()
        ce = -torch.log_softmax(cls, -1).gather(
            -1, res.labels[..., None])[..., 0]
        pos = res.labels > 0
        num_pos = pos.sum().clamp(min=1).float()
        t_mine, neg = timed_host(torch, lambda: head.hard_negatives(
            ce, pos, res.label_weights, num_pos))
    med = step_ms[len(step_ms) // 2]
    log(f"    target round at batch 32, 512 slots ({anchors.shape[0]} "
        f"anchors an image, {32 * anchors.shape[0] * 512 / 1e6:.1f} M "
        f"anchor-box pairs): {1e3 * t_tg:.1f} ms host, median of 3, "
        f"{100 * 1e3 * t_tg / med:.1f}% of the median step, "
        f"{tg_peak / 2**30:.2f} GiB above its inputs; {int(pos.sum())} "
        f"positives; hard-negative mining over {ce.numel():,} anchors "
        f"({int(neg.sum())} kept): {1e3 * t_mine:.2f} ms host, median of 3 "
        f"[{card}]")
    # one test image's NMS on the test task's model
    tm = tester.model.eval()
    th = tm.bbox_head
    images, _, _ = next(iter(tester.test_dataset.batches()))
    with torch.no_grad():
        cls_s, reg_s = th(tm.extract_feats(torch.as_tensor(
            images, device="cuda")))
        scores = torch.softmax(torch.cat([c[0].reshape(
            -1, th.num_classes) for c in cls_s]).float(), -1)[:, 1:]
        reg = torch.cat([r[0].reshape(-1, 4) for r in reg_s]).float()
        from rs_detection_tpu_torch.ops import box_ops as B
        from rs_detection_tpu_torch.ops.nms import top_k

        _, top_i = top_k(scores.amax(1), th.nms_pre)
        boxes = B.delta2bbox(th.anchors(sizes, "cuda")[top_i], reg[top_i],
                             th.target_means, th.target_stds)
        cand = scores[top_i]
        t_nms, (out_s, _, _) = timed_host(torch, lambda: th.nms(boxes, cand))
    kept = int(torch.isfinite(out_s).sum())
    log(f"    class-aware greedy NMS on one test image's {boxes.shape[0]} "
        f"candidates ({int((cand.amax(1) > th.score_thr).sum())} above "
        f"{th.score_thr}): {1e3 * t_nms:.1f} ms host, median of 3, {kept} "
        f"kept [{card}]")
    if anchors.shape[0] != 10765 or kept == 0:
        raise AssertionError(f"SSD: {anchors.shape[0]} anchors, {kept} kept")
    return launches["train"], launches["val"], launches["test"]


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    if not os.path.isdir(os.path.join(ROOT, "rs_detection_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (rs_detection_tpu_torch/ is missing)")
    sys.path.insert(0, ROOT)
    # phases 25, 28, 31, 32, 35, 38, 40, 42, 44, 46 and 47 share the CPU
    # tests' configs, tiles and datasets
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
    t_run = time.perf_counter()

    def phase_1():
        log(f"  {torch.cuda.get_device_name(0)} ({card}), torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def phase_2():
        t0 = time.perf_counter()
        _build.kernel_library()
        log(f"  build: {time.perf_counter() - t0:.2f} s -> "
            f"{os.path.relpath(_build.library_path(), ROOT)}")

    card = card_line()
    run_phase(torch, 1, "device", phase_1)
    run_phase(torch, 2, "build", phase_2)

    serving = {"van_mlp": vm.van_mlp_cuda,
               "van_mlp_residual": vm.van_mlp_residual_cuda,
               "van_mlp_int8": vm.van_mlp_int8_cuda,
               "van_mlp_residual_int8": vm.van_mlp_residual_int8_cuda,
               "van_attn": va.van_attn_cuda,
               "depthwise_conv2d": dw.depthwise_conv2d_cuda,
               "roi_align_rotated_pyramid": ra.roi_align_rotated_pyramid_cuda}
    training = {"van_mlp": vm.van_mlp_cuda,
                "roi_align_rotated_pyramid": ra.roi_align_rotated_pyramid_cuda,
                "roi_align_rotated_pyramid_bwd":
                    ra.roi_align_rotated_pyramid_bwd_cuda,
                "dw_wgrad": dwc.dw_wgrad_cuda}
    k2 = run_phase(torch, 3, "K2 fused VAN MLP vs plain", lambda: phase_k2(
        torch, vm.van_mlp_cuda, vm.van_mlp_reference, dev))
    k1, k1_step_ms, k1_serving_ms = run_phase(
        torch, 4, "K1 rotated pyramid RoIAlign vs plain and its first design",
        lambda: phase_k1(torch, ra, build_flagship, normalize, dev))
    run_phase(torch, 5, "tiny config predict: CUDA (kernels) vs CPU (plain), "
              "f32", lambda: phase_slice(torch, build_flagship, normalize,
                                         dev))
    modes = {}
    launches, *modes["non-fused"] = run_phase(
        torch, 6, "serving path", lambda: phase_main(
            torch, build_flagship, normalize, serving, dev, card))
    k3, k3_step_ms = run_phase(
        torch, 7, "K3 RoIAlign backward vs plain, bit for bit across "
        "launches, K1/K3 adjointness", lambda: phase_k3(torch, ra, dev))
    k6 = run_phase(torch, 8, "K6 depthwise weight gradient vs plain",
                   lambda: phase_k6(torch, dwc, dev))
    run_phase(torch, 9, "tiny config training step: CUDA (kernels) vs CPU "
              "(plain), f32", lambda: phase_train_tiny(
                  torch, build_flagship, make_targets, train_mod, dev))
    train_launches, phase10_ms = run_phase(
        torch, 10, "training path", lambda: phase_train(
            torch, build_flagship, make_targets, normalize, train_mod,
            training, dev, card))
    (k5, k7), k7_launches = run_phase(
        torch, 11, "K5 depthwise forward (and K7's layout) vs plain",
        lambda: (phase_k5(torch, dw, dev), phase_k7_path(torch, dw, dev)))
    k2r = run_phase(torch, 12, "K2r residual form of the VAN MLP kernel vs "
                    "plain", lambda: phase_k2(
                        torch, vm.van_mlp_residual_cuda,
                        vm.van_mlp_residual_reference, dev, name="K2r"))
    k4 = run_phase(torch, 13, "K4 fused VAN attention half-block vs plain",
                   lambda: phase_k4(torch, va, dev))
    run_phase(torch, 14, "tiny config fused predict: CUDA vs CPU, fused vs "
              "non-fused", lambda: phase_slice(torch, build_flagship,
                                               normalize, dev, fused=True))
    fused_launches, *modes["fused"] = run_phase(
        torch, 15, "fused serving path", lambda: phase_main(
            torch, build_flagship, normalize, serving, dev, card, fused=True))

    def phase_16():
        out = (phase_k2q(torch, vm, dev, residual=False),
               phase_k2q(torch, vm, dev, residual=True))
        phase_k2q_pack(torch, vm, quant, _build.kernel_library(), dev)
        return out

    k2q, k2qr = run_phase(torch, 16, "K2q int8 form of the VAN MLP kernel, "
                          "and its residual form, vs plain", phase_16)
    run_phase(torch, 17, "integer products of the int8 mode: CUDA vs CPU, "
              "bit for bit", lambda: phase_int_products(torch, quant, dev))
    run_phase(torch, 18, "tiny config int8 predict: CUDA vs CPU, int8 vs "
              "float", lambda: [phase_slice_int8(
                  torch, build_flagship, normalize, dev, fused=f)
                  for f in (False, True)])
    int8_launches, *modes["int8 non-fused"] = run_phase(
        torch, 19, "int8 serving path", lambda: phase_main(
            torch, build_flagship, normalize, serving, dev, card, int8=True))
    int8_fused_launches, *modes["int8 fused"] = run_phase(
        torch, 20, "fused int8 serving path", lambda: phase_main(
            torch, build_flagship, normalize, serving, dev, card, fused=True,
            int8=True, n_requests=INT8_REQUESTS_FUSED))
    log("  serving, same run: " + "; ".join(
        f"{mode} {t:.2f} tiles/s, request median {med:.1f} ms, peak "
        f"{peak:.2f} GiB" for mode, (t, peak, med) in modes.items())
        + f" [{card}]")
    both = dict(serving, **training)
    with tempfile.TemporaryDirectory() as tmp:
        run_phase(torch, 21, "tiny config through the runner: CUDA vs CPU",
                  lambda: phase_runner_tiny(torch, dev, tmp))
        test_launches, tile_file_tps = run_phase(
            torch, 22, "run_net --task test at full width",
            lambda: phase_run_net(torch, tmp, serving, card))
        run_phase(torch, 23, "tiny config through the runner's training: "
                  "CUDA vs CPU, resume",
                  lambda: phase_runner_train_tiny(torch, dev, tmp))
        train_task_launches, val_task_launches = run_phase(
            torch, 24, "run_net --task train at full width, get_swa_model, "
            "run_net --task val", lambda: phase_train_task(
                torch, tmp, both, card, phase10_ms))
        run_phase(torch, 25, "tiny ResNet config: predict and 2 SGD steps, "
                  "CUDA vs CPU", lambda: phase_resnet_tiny(torch, dev))
        r50_train, r50_test, k1_r50, k3_r50 = run_phase(
            torch, 26, "run_net --task train and --task test on "
            "orcnn_r50_fpn_1x_dota.py at full width",
            lambda: phase_resnet_train_task(torch, tmp, both, card))
        run_phase(torch, 27, "EQLv2 at full width: orcnn_r101_fpn_ms_flip_"
                  "rotate_bc_le90_eqlv2.py, 2 steps, save, resume",
                  lambda: phase_eqlv2(torch, tmp, card))
        trained = run_phase(torch, 28, "the overfit test on the card: "
                            "per-class APs, float and int8",
                            lambda: phase_overfit(torch, dev, tmp, card))
        scenes = run_phase(torch, 29, "dataset preparation: tools/"
                           "preprocess.py on the card and on the CPU, then 2 "
                           "training steps on its labels",
                           lambda: phase_preprocess(torch, tmp, card))
        scene_launches = run_phase(
            torch, 30, "raw-scene serving at full width: run_net --task "
            "test over a SceneDataset, dense and screened",
            lambda: phase_scene_task(torch, dev, tmp, scenes, serving, card,
                                     tile_file_tps))
        run_phase(torch, 31, "the screened scene: train_screen, dense / "
                  "thresh / budget serving with phase 28's detector",
                  lambda: phase_screened_scene(torch, dev, tmp, card,
                                               *trained))
        trained = None
        run_phase(torch, 32, "tiny RoI-Transformer, KFIoU RoI-Transformer "
                  "and FasterRCNN-OBB: predict and 2 SGD steps, CUDA vs CPU",
                  lambda: phase_roitrans_tiny(torch, dev))
        rt_train, rt_test, k1_rt, k3_rt = run_phase(
            torch, 33, "run_net --task train and --task test on "
            "faster_rcnn_RoITrans_r50_fpn_1x_dota.py at full width",
            lambda: phase_roitrans_task(torch, tmp, both, card))
        run_phase(torch, 34, "faster_rcnn_obb_r50_fpn_1x_dota.py at full "
                  "width: 2 steps, 2 test tiles",
                  lambda: phase_faster_rcnn_obb(torch, tmp, both, card))
        run_phase(torch, 35, "tiny S2ANet: predict and 2 SGD steps, the "
                  "deformable conv, ORN, rotated NMS and IoU, CUDA vs CPU",
                  lambda: phase_s2anet_tiny(torch, dev))
        s2_train, s2_test = run_phase(
            torch, 36, "run_net --task train and --task test on "
            "configs/s2anet_r50_fpn_1x_dota.py at full width",
            lambda: phase_s2anet_task(torch, tmp, dict(
                both, dw_chw=dw.dw_chw_cuda), card))
        run_phase(torch, 37, "s2anet_r50_fpn_1x_dota_bs8.py: 2 steps at "
                  "batch 8, 512 slots", lambda: phase_s2anet_bs8(torch, card))
        run_phase(torch, 38, "tiny Gliding Vertex: predict and 2 SGD steps, "
                  "the GV coders on axis-aligned quads, CUDA vs CPU",
                  lambda: phase_gliding_tiny(torch, dev))
        gv_train, gv_test = run_phase(
            torch, 39, "run_net --task train and --task test on "
            "gliding_r50_fpn_1x_dota_with_flip_rotate_balance_cate.py at full "
            "width", lambda: phase_gliding_task(torch, tmp, dict(
                both, dw_chw=dw.dw_chw_cuda), card))
        run_phase(torch, 40, "tiny RetinaNet, both head forms: predict and "
                  "3 GradMutilpySGD + YangXue steps, CUDA vs CPU",
                  lambda: phase_retina_tiny(torch, dev))
        rn_train, rn_test = run_phase(
            torch, 41, "run_net --task train and --task test on "
            "retinanet_r50v1d_fpn_dota.py at full width",
            lambda: phase_retina_task(torch, tmp, dict(
                both, dw_chw=dw.dw_chw_cuda), card))
        run_phase(torch, 42, "tiny FCOS: predict and 2 SGD steps, the "
                  "poly-IoU losses, convex_sort, CUDA vs CPU",
                  lambda: phase_fcos_tiny(torch, dev))
        fc_train, fc_test = run_phase(
            torch, 43, "run_net --task train and --task test on "
            "configs/fcos/fcos_obb_r50_fpn_1x_dota.py at full width",
            lambda: phase_fcos_task(torch, tmp, dict(
                both, dw_chw=dw.dw_chw_cuda), card))
        run_phase(torch, 44, "tiny R3Det: predict and 2 SGD steps, the "
                  "feature-refine gather, CUDA vs CPU",
                  lambda: phase_r3det_tiny(torch, dev))
        r3_train, r3_test = run_phase(
            torch, 45, "run_net --task train and --task test on "
            "r3det_r50_fpn_1x_dota.py at full width",
            lambda: phase_r3det_task(torch, tmp, dict(
                both, dw_chw=dw.dw_chw_cuda), card))
        run_phase(torch, 46, "tiny SSD: predict and 2 SGD steps, CUDA vs "
                  "CPU", lambda: phase_ssd_tiny(torch, dev))
        ssd_train, ssd_val, ssd_test = run_phase(
            torch, 47, "run_net --task train, val and test on "
            "ssd300_coco.py at full width, one step of ssd300_coco_test.py",
            lambda: phase_ssd_task(torch, tmp, dict(
                both, dw_chw=dw.dw_chw_cuda), card))
    log(f"all 47 phases in {time.perf_counter() - t_run:.1f} s [{card}]")

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
                  "roi_align_rotated_pyramid"],
              roitrans_train_task_launches=rt_train[
                  "roi_align_rotated_pyramid"],
              roitrans_test_task_launches=rt_test[
                  "roi_align_rotated_pyramid"],
              roitrans_ms=k1_rt[0], roitrans_plain_ms=k1_rt[1],
              roitrans_bound_ms=k1_rt[2][0]),
        entry("roi_align_rotated_pyramid_bwd", "roi_align_rotated_bwd.cu",
              jops + "pallas_roi_align.py:721",
              train_launches["roi_align_rotated_pyramid_bwd"], k3,
              step_like_ms=k3_step_ms,
              train_task_launches=train_task_launches[
                  "roi_align_rotated_pyramid_bwd"],
              resnet_train_task_launches=r50_train[
                  "roi_align_rotated_pyramid_bwd"],
              resnet_ms=k3_r50[0], resnet_plain_ms=k3_r50[1],
              resnet_bound_ms=k3_r50[2][0],
              roitrans_train_task_launches=rt_train[
                  "roi_align_rotated_pyramid_bwd"],
              roitrans_test_task_launches=rt_test[
                  "roi_align_rotated_pyramid_bwd"],
              roitrans_ms=k3_rt[0], roitrans_plain_ms=k3_rt[1],
              roitrans_bound_ms=k3_rt[2][0]),
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
    for k in kernels:
        k["s2anet_train_task_launches"] = s2_train[k["name"]]
        k["s2anet_test_task_launches"] = s2_test[k["name"]]
        k["gliding_train_task_launches"] = gv_train[k["name"]]
        k["gliding_test_task_launches"] = gv_test[k["name"]]
        k["retinanet_train_task_launches"] = rn_train[k["name"]]
        k["retinanet_test_task_launches"] = rn_test[k["name"]]
        k["fcos_train_task_launches"] = fc_train[k["name"]]
        k["fcos_test_task_launches"] = fc_test[k["name"]]
        k["r3det_train_task_launches"] = r3_train[k["name"]]
        k["r3det_test_task_launches"] = r3_test[k["name"]]
        k["ssd_train_task_launches"] = ssd_train[k["name"]]
        k["ssd_val_task_launches"] = ssd_val[k["name"]]
        k["ssd_test_task_launches"] = ssd_test[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == [OVERFIT_CHILD]:
        overfit_child(sys.argv[2])
    else:
        main()
