#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rs_detection_tpu_torch``) on one
NVIDIA GPU. Run from the repository root: ``python3 chip_smoke.py``.

Phases, each of which raises (exit code 1) on failure:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off
  2. build: compiles ``rs_detection_tpu_torch/csrc/*.cu`` (nvcc, sm_90a)
  3. K2, the fused VAN MLP kernel, against its plain version at the four
     VAN-b3 stage shapes (batch 8, bf16) and one small f32 shape
  4. K1, the rotated pyramid RoIAlign kernel, against its plain version
     on 16000 seeded rois over the flagship pyramid (bf16) and small f32
  5. the tiny config's ``predict`` on CUDA (kernels) against the CPU
     (plain versions), f32, same seed
  6. the main path: VAN-b3 Oriented R-CNN in bf16 with seeded random
     weights serves 10 batches of 8 uint8 1024^2 tiles (normalize on the
     device, ``predict``); checks shapes, finiteness and that every
     forward went through K2 38 times and K1 once
Then prints one JSON line of per-kernel results, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STAGES = [  # (H = W, C, Ch, blocks) of VAN-b3 at 1024^2 tiles
    (256, 64, 512, 3), (128, 128, 1024, 5), (64, 320, 1280, 27),
    (32, 512, 2048, 3)]
BATCH = 8
TILE = 1024
REQUESTS = 10
# kernel vs plain, as max|diff| / max|plain|: bf16 rounds the hidden
# tensor at other points in the two versions (1-2 bf16 ulps, 2^-8 each,
# of the output's largest values); f32 differs only in summation order
REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


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


def compare(name, kernel, plain, dtype_name):
    """Max abs error of ``kernel`` against ``plain``; raises past the
    stated relative tolerance."""
    err = (kernel.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    tol = REL_TOL[dtype_name] * max(scale, 1e-6)
    ok = err <= tol
    log(f"  {name}: max_abs_err {err:.3e}, max|plain| {scale:.3e}, "
        f"tolerance {tol:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def phase_k2(torch, van_mlp_cuda, van_mlp_reference, dev):
    g = torch.Generator(device=dev).manual_seed(1)

    def inputs(n, h, c, ch, dt):
        def r(*s, scale=1.0):
            return (torch.randn(*s, generator=g, device=dev) * scale).to(dt)
        return (r(n, h, h, c), r(ch, c, scale=c ** -0.5), r(ch, scale=0.1),
                r(ch, 9, scale=1 / 3), r(ch, scale=0.1),
                r(c, ch, scale=ch ** -0.5), r(c, scale=0.1))

    err_max, ms, plain_ms = 0.0, 0.0, 0.0
    for h, c, ch, blocks in STAGES:
        args = inputs(BATCH, h, c, ch, torch.bfloat16)
        err = compare(f"K2 [{BATCH},{h},{h},{c}] Ch={ch} bf16",
                      van_mlp_cuda(*args), van_mlp_reference(*args),
                      "bfloat16")
        t_plain = cuda_ms(lambda: van_mlp_reference(*args), 5)
        t_kernel = cuda_ms(lambda: van_mlp_cuda(*args), 5)
        log(f"    kernel {t_kernel:.3f} ms, plain {t_plain:.3f} ms "
            f"(x{blocks} blocks per forward)")
        err_max = max(err_max, err)
        ms += blocks * t_kernel
        plain_ms += blocks * t_plain
        del args
    args = inputs(2, 21, 32, 96, torch.float32)
    compare("K2 [2,21,21,32] Ch=96 f32", van_mlp_cuda(*args),
            van_mlp_reference(*args), "float32")
    return err_max, ms, plain_ms


def flagship_rois(torch, n, r, img, dev, seed):
    """Rois over every level (sqrt-area 8..900 px before the 1.4x1.2
    inflation), any rotation, centres up to 20% past each border."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi):
        return torch.rand(r, generator=g, device=dev) * (hi - lo) + lo

    scale = torch.exp(u(2.08, 6.8))
    aspect = torch.exp(u(-1.5, 1.5))
    b = torch.randint(0, n, (r,), generator=g, device=dev).float()
    return torch.stack([b, u(-0.2, 1.2) * img, u(-0.2, 1.2) * img,
                        scale * aspect, scale / aspect, u(-3.2, 3.2)], 1)


def phase_k1(torch, roi_cuda, roi_reference, dev):
    g = torch.Generator(device=dev).manual_seed(2)
    sizes = [TILE // s for s in (4, 8, 16, 32)]
    feats = [torch.randn(BATCH, s, s, 256, generator=g, device=dev)
             .to(torch.bfloat16) for s in sizes]
    rois = flagship_rois(torch, BATCH, BATCH * 2000, TILE, dev, 3)
    err = compare(f"K1 {rois.shape[0]} rois, C=256, bf16",
                  roi_cuda(feats, rois), roi_reference(feats, rois),
                  "bfloat16")
    t_plain = cuda_ms(lambda: roi_reference(feats, rois), 3)
    t_kernel = cuda_ms(lambda: roi_cuda(feats, rois), 10)
    log(f"    kernel {t_kernel:.3f} ms, plain {t_plain:.3f} ms")
    small = [torch.randn(2, s, s, 32, generator=g, device=dev)
             for s in (64, 32, 16, 8)]
    small_rois = flagship_rois(torch, 2, 500, 256, dev, 4)
    compare("K1 500 rois, C=32, f32", roi_cuda(small, small_rois),
            roi_reference(small, small_rois), "float32")
    return err, t_kernel, t_plain


def phase_slice(torch, build_flagship, normalize, dev):
    g = torch.Generator().manual_seed(5)
    tiles = torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    cpu = build_flagship(tiny=True).predict(normalize(tiles))
    gpu = build_flagship(tiny=True, device=dev).predict(
        normalize(tiles.to(dev)))
    if not torch.equal(gpu["valid"].cpu(), cpu["valid"]):
        raise AssertionError("tiny config: valid masks differ")
    # f32 with TF32 off on both: cuDNN/cuBLAS and CPU summation orders
    for key, atol in (("polys", 1e-2), ("scores", 1e-5)):
        err = (gpu[key].cpu() - cpu[key]).abs().max().item()
        log(f"  tiny predict {key}: max_abs_err {err:.3e} (atol {atol})")
        if not err <= atol:
            raise AssertionError(f"tiny config: {key} differ by {err}")


def phase_main(torch, build_flagship, normalize, van_mlp_cuda, roi_cuda, dev,
               card):
    model = build_flagship(tiny=False, device=dev, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    rng = torch.Generator().manual_seed(6)
    requests = [torch.randint(0, 256, (BATCH, TILE, TILE, 3), generator=rng,
                              dtype=torch.uint8) for _ in range(REQUESTS + 1)]

    def serve(tiles_u8):
        return model.predict(normalize(tiles_u8.to(dev, non_blocking=True)))

    serve(requests[0])  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    van_mlp_cuda.launches = 0
    roi_cuda.launches = 0
    outs, times = [], []
    for tiles in requests[1:]:
        t0 = time.perf_counter()
        outs.append(serve(tiles))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = sum(times)
    launches = {"van_mlp": van_mlp_cuda.launches,
                "roi_align_rotated_pyramid": roi_cuda.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    n_blocks = sum(s[3] for s in STAGES)
    if launches != {"van_mlp": n_blocks * REQUESTS,
                    "roi_align_rotated_pyramid": REQUESTS}:
        raise AssertionError(f"main path kernel launches {launches}")
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
    tiles_s = REQUESTS * BATCH / dt
    times.sort()
    log(f"  VAN-b3 Oriented R-CNN bf16: {REQUESTS} requests of {BATCH}x"
        f"{TILE}^2 uint8 tiles in {dt:.3f} s = {tiles_s:.2f} tiles/s "
        f"(request ms min {1e3 * times[0]:.1f}, median "
        f"{1e3 * times[len(times) // 2]:.1f}, max {1e3 * times[-1]:.1f}), "
        f"peak memory {peak / 2**30:.2f} GiB, {valid} valid detection "
        f"slots [{card}]")
    log(f"  launches in the timed requests: {launches}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    if not os.path.isdir(os.path.join(ROOT, "rs_detection_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (rs_detection_tpu_torch/ is missing)")
    sys.path.insert(0, ROOT)
    from rs_detection_tpu_torch.flagship import build_flagship, normalize
    from rs_detection_tpu_torch.ops import _build
    from rs_detection_tpu_torch.ops.roi_align import (
        roi_align_rotated_pyramid_cuda, roi_align_rotated_pyramid_reference)
    from rs_detection_tpu_torch.ops.van_mlp import (van_mlp_cuda,
                                                    van_mlp_reference)

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

    log("[3] K2 fused VAN MLP vs plain")
    k2 = phase_k2(torch, van_mlp_cuda, van_mlp_reference, dev)
    log("[4] K1 rotated pyramid RoIAlign vs plain")
    k1 = phase_k1(torch, roi_align_rotated_pyramid_cuda,
                  roi_align_rotated_pyramid_reference, dev)
    log("[5] tiny config predict: CUDA (kernels) vs CPU (plain), f32")
    phase_slice(torch, build_flagship, normalize, dev)
    log("[6] main path")
    launches = phase_main(torch, build_flagship, normalize, van_mlp_cuda,
                          roi_align_rotated_pyramid_cuda, dev, card)

    kernels = [
        {"name": "van_mlp", "route": "cuda",
         "source": "rs_detection_tpu_torch/csrc/van_mlp.cu",
         "replaces": "rs_detection_tpu/ops/pallas_van_mlp.py:68",
         "launches": launches["van_mlp"], "max_abs_err": k2[0],
         "ms": k2[1], "plain_ms": k2[2]},
        {"name": "roi_align_rotated_pyramid", "route": "cuda",
         "source": "rs_detection_tpu_torch/csrc/roi_align_rotated.cu",
         "replaces": "rs_detection_tpu/ops/pallas_roi_align.py:116",
         "launches": launches["roi_align_rotated_pyramid"],
         "max_abs_err": k1[0], "ms": k1[1], "plain_ms": k1[2]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
