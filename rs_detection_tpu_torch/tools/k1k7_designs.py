"""Time K1 (the rotated pyramid RoIAlign forward) and K7's form (the
depthwise forward on ``[N, H, C, W]``) at the shapes of the main path on
one CUDA GPU, through the wrappers of the port found under ``--root``
(default: the checkout that holds this file), so that two trees can be
timed in one call.

Run from anywhere: ``python3 rs_detection_tpu_torch/tools/k1k7_designs.py
[--root DIR] [--phases]``. Prints the card's name and power limit, then
one JSON line of CUDA-event times in ms (a loop of calls, as
``chip_smoke.py`` times every kernel): K1 on 16000 uniform rois
(``k3k5_designs.py:uniform_rois``, the yardstick of ``chip_smoke.py``)
and on 4096 rois like a training step's (``step_rois``), bf16, C = 256,
over the flagship pyramid (batch 8, 1024^2 tiles), and on the features
and rois of one flagship serving request (``serving_rois``), where the
checkout orders the rois also the order's own time and the kernel with
and without it; K7's form at
(k, d) = (5, 1) and (7, 3) on the prototype's [8, 256, 64, 256] bf16
and their sum. Where the checkout has them, the first designs
(``roi_align_rotated_pyramid_first_design``, ``dw_chw_first_design``)
are timed beside the wrappers on the same inputs.

``--phases`` also builds copies of each K1 source under DIR with a phase
cut out or a choice of the design changed (a missing pattern raises),
each compiled on its own by ``nvcc`` with ``-Xptxas -v``, and times them
on the uniform rois, the row design's with its order and with the rois
as given: "geometry only" (no feature loads: each corner adds its weight
and pixel index), "loads without FMAs" (each corner's 16-byte load feeds
one bitwise fold and one add instead of the unpacks and eight FMAs), "no
stores" (the result is stored only if it equals a value it never takes),
"no merging" (every bin loads its 16 corners), two or four blocks an SM.
A variant's output is wrong by construction; only its time means
something. K7's form is timed at 1, 2, 4 and the plan's row segments.
It prints ptxas' registers and spills per variant, ptxas' report of the
depthwise sources, and the SASS instructions by opcode (``cuobjdump
-sass``) of the K1 and K7 kernels of DIR's library (``--sass-out FILE``:
the whole SASS of the row designs' bf16 kernels).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH = 8
TILE = 1024
K7_SHAPE = (BATCH, 256, 64, 256)  # [N, H, C, W] of the prototype

_FMA_FIRST = ("            Vec<T, VEC>::fma(feat + static_cast<size_t>(o[k])"
              " * C + c0,\n                             wt[k], a);")
_FMA_ROWS = "    for (int j = 0; j < N; ++j) fma16<T>(q[j], tw[j], a);"
_LOAD_ONLY = ("{{ const uint4 q_ = {load}; a[0] += __uint_as_float((q_.x ^ "
              "q_.y ^ q_.z ^ q_.w) & 0x3f800000u); }}")
# (source, C entry point, {variant: [(old, new), ...]}) of each K1 design
K1_VARIANTS = [
    ("roi_align_rotated.cu", "rs_roi_align_rotated_pyramid_fwd", {
        "whole": [],
        "geometry only": [(_FMA_FIRST,
                           "            a[0] += wt[k] * o[k];")],
        "loads without FMAs": [(_FMA_FIRST, "            " + _LOAD_ONLY.format(
            load="__ldg(reinterpret_cast<const uint4*>(feat + static_cast"
                 "<size_t>(o[k]) * C + c0))"))],
        "no stores": [("      Vec<T, VEC>::store(\n          out +",
                       "      if (a[0] == 1234.5f) Vec<T, VEC>::store(\n"
                       "          out +")]}),
    ("roi_align_rotated_fwd.cu", "rs_roi_align_rotated_pyramid_fwd_rows", {
        "whole": [],
        "geometry only": [
            ("      q[j] = to[j] >= 0 ? ldg16(feat + static_cast<size_t>"
             "(to[j]) * C + c0)\n"
             "                        : make_uint4(0u, 0u, 0u, 0u);",
             "      q[j] = make_uint4(to[j], 0u, 0u, 0u);"),
            (_FMA_ROWS, "    for (int j = 0; j < N; ++j) "
                        "a[0] += tw[j] * static_cast<int>(q[j].x);")],
        "loads without FMAs": [(_FMA_ROWS, "    for (int j = 0; j < N; ++j) "
                                + _LOAD_ONLY.format(load="q[j]"))],
        "no stores": [("    Vec<T, VEC>::store(out + c0, a);",
                       "    if (a[0] == 1234.5f) Vec<T, VEC>::store(out + c0, "
                       "a);")],
        "no merging": [("constexpr bool MERGE = true;",
                        "constexpr bool MERGE = false;")],
        "2 blocks an SM": [("__launch_bounds__(THREADS, 3)\n    roi_rows",
                            "__launch_bounds__(THREADS, 2)\n    roi_rows")],
        "4 blocks an SM": [("__launch_bounds__(THREADS, 3)\n    roi_rows",
                            "__launch_bounds__(THREADS, 4)\n    roi_rows")]}),
]
# variants of K7's row-streaming design, timed at the prototype's shape
K7_VARIANTS = ("dw_conv_chw.cu", "rs_dw_conv_chw", {"whole": []})
SASS_KERNELS = re.compile(r"roi_align_rotated_pyramid_kernel|roi_rows_kernel|"
                          r"dw_fwd_kernel.*Lb1E|dw_chw_kernel")


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip() \
        .splitlines()[0]


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


def sass_counts(nvcc, lib_path):
    """SASS instructions by opcode of the K1 and K7 kernels in
    ``lib_path``, keyed by mangled name."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if SASS_KERNELS.search(m.group(1)) else None
            if name:
                counts[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     ln)
        if m and name:
            counts[name][m.group(1).split(".")[0]] += 1
    return counts


def serving_rois(torch, build_flagship, normalize, dev):
    """The features and rois that one flagship serving request (batch 8
    of seeded uint8 1024^2 tiles, bf16, seeded random weights) hands the
    RoI extractor, captured at its call."""
    from rs_detection_tpu_torch.models.roi_extractors import \
        oriented_single_level as extractor

    model = build_flagship(tiny=False, device=dev, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    tiles = torch.randint(0, 256, (BATCH, TILE, TILE, 3),
                          generator=torch.Generator().manual_seed(6),
                          dtype=torch.uint8)
    seen = []
    call = extractor.roi_align_rotated_pyramid

    def capture(feats, rois, *args, **kwargs):
        seen.append(([f.clone() for f in feats], rois.clone()))
        return call(feats, rois, *args, **kwargs)

    extractor.roi_align_rotated_pyramid = capture
    try:
        with torch.no_grad():
            model.predict(normalize(tiles.to(dev)))
    finally:
        extractor.roi_align_rotated_pyramid = call
    del model
    torch.cuda.empty_cache()
    if len(seen) != 1:
        raise AssertionError(f"a request called the RoI extractor "
                             f"{len(seen)} times")
    return seen[0]


def build_variants(build, csrc, workdir):
    """Compile each K1 and K7 variant of the sources present under
    ``csrc`` (all nvcc started together); returns {(source, variant): C
    entry} and prints ptxas' registers and spills of each."""
    procs = {}
    for source, entry, variants in K1_VARIANTS + [K7_VARIANTS]:
        if not (csrc / source).exists():
            continue
        text0 = (csrc / source).read_text()
        for i, (name, edits) in enumerate(variants.items()):
            text = text0
            for old, new in edits:
                if text.count(old) != 1:
                    raise ValueError(f"{source} has {text.count(old)} "
                                     f"copies of {old!r}, not one")
                text = text.replace(old, new)
            d = Path(workdir) / f"{Path(source).stem}_{i}"
            shutil.copytree(csrc, d)
            (d / source).write_text(text)
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                   "-shared", "-o", str(d / "lib.so"), str(d / source)]
            procs[(source, name)] = (entry, d / "lib.so", subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    fns = {}
    for key, (entry, path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        lines = out.splitlines()
        regs = [ln.split("Used ")[1].split(" ")[0] for ln in lines
                if "Used" in ln]
        spills = [ln.strip() for ln in lines
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        print(f"{key[0]}, {key[1]}: registers {', '.join(regs)}; spills "
              f"{spills}", flush=True)
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes, fn.restype = build.SIGNATURES[entry]
        fns[key] = fn
    return fns


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=ROOT)
    parser.add_argument("--phases", action="store_true")
    parser.add_argument("--sass-out", default=None,
                        help="with --phases: write the SASS of the row "
                             "designs' bf16 kernels to this file")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1k7_designs: needs a CUDA GPU")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from rs_detection_tpu_torch.flagship import (build_flagship,
                                                 make_targets, normalize)
    from rs_detection_tpu_torch.ops import _build
    from rs_detection_tpu_torch.ops import dwconv as dw
    from rs_detection_tpu_torch.ops import roi_align as ra
    from rs_detection_tpu_torch.ops.rotated_iou import box_iou_rotated
    from rs_detection_tpu_torch.tools.k3k5_designs import (step_rois,
                                                           uniform_rois)

    card = card_line()
    print(f"{root}: {card}", flush=True)
    lib_path = _build.build()
    _build.kernel_library()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    bf16 = torch.bfloat16
    out = {"root": root, "card": card, "K1": {}, "K7": {}}

    # K1: the inputs of chip_smoke.py's phase 4 and phase 7
    g = torch.Generator(device=dev).manual_seed(2)
    feats = [torch.randn(BATCH, TILE // s, TILE // s, 256, generator=g,
                         device=dev).to(bf16) for s in (4, 8, 16, 32)]
    rois = {"uniform": uniform_rois(torch, BATCH, BATCH * 2000, TILE, dev, 3),
            "step-like": step_rois(torch, make_targets, box_iou_rotated,
                                   BATCH, TILE, dev, 20)[0]}
    serving = serving_rois(torch, build_flagship, normalize, dev)
    first_k1 = getattr(ra, "roi_align_rotated_pyramid_first_design", None)
    for name, r in rois.items():
        out["K1"][name] = cuda_ms(
            torch, lambda: ra.roi_align_rotated_pyramid_cuda(feats, r), 20)
        if first_k1 is not None:
            out["K1"][f"{name}, first design"] = cuda_ms(
                torch, lambda: first_k1(feats, r), 20)
    out["K1"]["serving"] = cuda_ms(
        torch, lambda: ra.roi_align_rotated_pyramid_cuda(*serving), 20)
    if hasattr(ra, "_k1_order"):  # the order's own cost on each set
        lib = _build.kernel_library()
        stream = torch.cuda.current_stream().cuda_stream
        for name, (fs, r) in (("uniform", (feats, rois["uniform"])),
                              ("step-like", (feats, rois["step-like"])),
                              ("serving", serving)):
            hw = [v for f in fs for v in f.shape[1:3]]
            out["K1"][f"{name}, order"] = cuda_ms(
                torch, lambda: ra._k1_order(lib, fs, BATCH, hw,
                                            [4.0, 8.0, 16.0, 32.0], r, 56.0,
                                            stream), 20)
            order = ra._k1_order(lib, fs, BATCH, hw, [4.0, 8.0, 16.0, 32.0],
                                 r, 56.0, stream)
            y = torch.empty(r.shape[0], 7, 7, 256, dtype=bf16, device=dev)
            for label, o in (("sorted", order), ("as given", None)):
                def rows(o=o):
                    err = lib.rs_roi_align_rotated_pyramid_fwd_rows(
                        *[f.data_ptr() for f in fs], 4, BATCH, 256, *hw,
                        4.0, 8.0, 16.0, 32.0, r.data_ptr(),
                        None if o is None else o.data_ptr(), r.shape[0], 7,
                        2, 56.0, y.data_ptr(), 1, 8, stream)
                    if err != 0:
                        raise RuntimeError(f"K1 rows: CUDA error {err}")
                out["K1"][f"{name}, kernel alone, rois {label}"] = cuda_ms(
                    torch, rows, 20)
    if first_k1 is not None:
        out["K1"]["serving, first design"] = cuda_ms(
            torch, lambda: first_k1(*serving), 20)
    del serving
    k7_fns = {}
    if args.phases:
        stream = torch.cuda.current_stream().cuda_stream
        r = rois["uniform"]
        y = torch.empty(r.shape[0], 7, 7, 256, dtype=bf16, device=dev)
        head = ([f.data_ptr() for f in feats] + [4, BATCH, 256]
                + [v for f in feats for v in f.shape[1:3]]
                + [4.0, 8.0, 16.0, 32.0, r.data_ptr()])
        tail = [r.shape[0], 7, 2, 56.0, y.data_ptr(), 1, 8, stream]
        keys = getattr(ra, "_k1_order", None)
        order = None if keys is None else keys(
            _build.kernel_library(), feats, BATCH, head[7:15], head[15:19], r,
            56.0, stream)
        with tempfile.TemporaryDirectory() as workdir:
            fns = build_variants(_build, _build.CSRC, workdir)
            k7_fns = {name: fn for (source, name), fn in fns.items()
                      if source == K7_VARIANTS[0]}
            for (source, name), fn in fns.items():
                if source == K7_VARIANTS[0]:
                    continue
                rows = source == "roi_align_rotated_fwd.cu"
                orders = [("", order), (", rois as given", None)] \
                    if rows else [("", order)]
                for label, o in orders:
                    call = head + ([None if o is None else o.data_ptr()]
                                   if rows else []) + tail

                    def launch(fn=fn, call=call):
                        err = fn(*call)
                        if err != 0:
                            raise RuntimeError(f"{source} {name}: CUDA "
                                               f"error {err}")
                    out["K1"][f"{source}, {name}{label}"] = cuda_ms(
                        torch, launch, 20)
        from rs_detection_tpu_torch.tools.fused_block_stages import \
            ptxas_report
        for src in ("dw_conv_fwd.cu", "dw_conv_chw.cu"):
            if (_build.CSRC / src).exists():
                ptxas_report(src)
        if args.sass_out:
            dump = subprocess.run(
                [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
                 str(lib_path)], capture_output=True, text=True,
                check=True).stdout
            keep, lines = False, []
            for ln in dump.splitlines():
                if "Function :" in ln:
                    keep = bool(re.search(r"roi_rows_kernelI13__nv_bfloat16"
                                          r"Li2E|dw_chw_kernelILi[57]E", ln))
                if keep:
                    lines.append(ln)
            Path(args.sass_out).write_text("\n".join(lines))
        for kernel, counts in sass_counts(_build._nvcc(), lib_path).items():
            print(f"{kernel}: {sum(counts.values())} SASS instructions: "
                  + ", ".join(f"{op} {n}" for op, n in
                              counts.most_common(14)), flush=True)
    del feats, rois

    # K7's form at the prototype's shape, taps [C, k*k]
    first_k7 = getattr(dw, "dw_chw_first_design", None)
    x = torch.randn(*K7_SHAPE, generator=g, device=dev).to(bf16)
    total = total_first = 0.0
    for k, d in ((5, 1), (7, 3)):
        wts = (torch.randn(K7_SHAPE[2], k * k, generator=g, device=dev)
               / k).to(bf16)
        ms = cuda_ms(torch, lambda: dw.dw_chw_cuda(x, wts, k, d), 20)
        out["K7"][f"k{k}d{d}"] = ms
        total += ms
        if first_k7 is not None:
            ms = cuda_ms(torch, lambda: first_k7(x, wts, k, d), 20)
            out["K7"][f"k{k}d{d}, first design"] = ms
            total_first += ms
    if args.phases and k7_fns:
        stream = torch.cuda.current_stream().cuda_stream
        y = torch.empty_like(x)
        for k, d in ((5, 1), (7, 3)):
            wts = (torch.randn(K7_SHAPE[2], k * k, generator=g, device=dev)
                   / k).to(bf16)
            plan = dw.dw_plan(k, d, K7_SHAPE[1], K7_SHAPE[3], K7_SHAPE[2],
                              bf16, n=BATCH, hcw=True)
            rows = -(-K7_SHAPE[1] // d)
            segs = sorted({plan["segs"], 1, 2, 4})
            for (name, fn), sg in ((v, sg) for v in k7_fns.items()
                                   for sg in segs):
                def launch(fn=fn, sg=sg):
                    err = fn(x.data_ptr(), wts.data_ptr(), None, y.data_ptr(),
                             BATCH, K7_SHAPE[1], K7_SHAPE[3], K7_SHAPE[2], k,
                             d, 1, k * k, sg, -(-rows // sg), stream)
                    if err != 0:
                        raise RuntimeError(f"K7 {name}: CUDA error {err}")
                out["K7"][f"k{k}d{d}, {name}, {sg} segments"] = cuda_ms(
                    torch, launch, 20)
    out["K7"]["pair"] = total
    if first_k7 is not None:
        out["K7"]["pair, first design"] = total_first
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
