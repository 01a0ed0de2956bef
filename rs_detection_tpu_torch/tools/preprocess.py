"""Dataset preparation (counterpart of ``tools/preprocess.py``):
conversion, tiling and ``labels.pkl``, driven by a preprocess config with
``type`` (DOTA / FAIR / SSDD...), ``source_dataset_path``,
``target_dataset_path``, ``tasks`` (each a ``label`` and a ``config`` of
``subsize`` / ``gap`` / ``rates`` / ``num_process`` / ``yx_style``),
``convert_type``, ``angle_version``, ``fair1m_mapping`` and ``yx_style``:

    python -m rs_detection_tpu_torch.tools.preprocess \\
        --config-file configs/preprocess/fair1m_1_5_ms.py \\
        [--set key=value ...] [--cpu]

It reads the config exactly as the JAX tool does, keys and defaults
alike. The JDet keys of most of ``configs/preprocess/`` (``overlap_size``,
``subimage_size``, ``multi_scale``, ``type = "FAIR1M_1_5"``,
``convert_tasks``, ``source_fair_dataset_path``) are not among them: the
JAX tool tiles such a config at 1024 / 200 and rate 1.0 with the DOTA
class table, and so does this one (``ROADMAP.md``, Queue 3). The resize
runs on the CUDA card (an error where there is none) unless ``--cpu`` is
passed; the tiles, labels and PNGs are cut and written by host threads.
"""

from __future__ import annotations

import argparse
import os

from ..data.devkits import convert_data_to_mmdet as convert_mod
from ..data.devkits import fair_to_dota as fair_mod
from ..data.devkits import img_split


def run(cfg, device=None):
    """Every task of ``cfg``; returns the tiled directories. ``device``:
    where the resize runs (None: the card)."""
    src = cfg.source_dataset_path
    tgt = cfg.target_dataset_path
    dtype = cfg.type or "DOTA"
    os.makedirs(tgt, exist_ok=True)

    outs = []
    for task in (cfg.tasks or []):
        label = task.get("label", "trainval")
        tcfg = task.get("config", {})
        task_src = os.path.join(src, label)
        if dtype == "FAIR":
            dota_dir = os.path.join(tgt, label + "_dota")
            if not os.path.exists(dota_dir):
                fair_mod.fair_to_dota(task_src, dota_dir)
            task_src = dota_dir
        elif dtype.startswith("SSDD"):
            dota_dir = os.path.join(tgt, label + "_dota")
            if not os.path.exists(dota_dir):
                fair_mod.ssdd_to_dota(task_src, dota_dir)
            task_src = dota_dir

        out = img_split.process(
            task_src, os.path.join(tgt, label),
            gap=tcfg.get("gap", 200),
            subsize=tcfg.get("subsize", 1024),
            rates=tcfg.get("rates", [1.0]),
            num_process=tcfg.get("num_process", 8),
            # the reference tiler reads cfg.yx_style
            # (ImgSplit_multi_process.py:191)
            yx_style=bool(cfg.yx_style or tcfg.get("yx_style", False)),
            device=device)
        if label != "test":
            convert = (convert_mod.convert_data_to_mmdet_mapping
                       if cfg.get("fair1m_mapping")
                       else convert_mod.convert_data_to_mmdet)
            convert(out, os.path.join(out, "labels.pkl"),
                    type=cfg.convert_type or "DOTA",
                    angle_version=cfg.angle_version or "le135")
        print("done:", out, flush=True)
        outs.append(out)
    return outs


def main(argv=None):
    """Parse the command line and ``run``; returns its directories."""
    ap = argparse.ArgumentParser(
        description="rs_detection_tpu_torch dataset preparation")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--set", dest="overrides", nargs="*", default=[],
                    help="key=value config overrides")
    ap.add_argument("--cpu", action="store_true",
                    help="resize on the host CPU")
    args = ap.parse_args(argv)
    from ..config import init_cfg

    cfg = init_cfg(args.config_file)
    for kv in args.overrides:
        k, v = kv.split("=", 1)
        cfg[k] = v
    return run(cfg, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
