"""The serving half of the train/eval engine (counterpart of
``rs_detection_tpu/runner/runner.py``): builds the model, the optimizers
and schedulers and the test dataset from the global config, resumes from
the newest checkpoint of the JAX runner's pickle format, and runs
``test`` (tile inference with optional flip-TTA -> results pickle ->
tile merge -> submission), ``test_time`` and ``run_on_images`` on the
card (or on the CPU when the caller asks for it).

``train``, ``run``, ``val`` and ``save`` raise: the training half comes
in a later slice (ROADMAP.md, item 9). So do the train and val datasets,
which the test task does not read.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict

import numpy as np
import torch

from ..config import get_cfg, save_cfg
from ..data import image as _image  # noqa: F401  (registers ImageDataset)
from ..data.collate import collate_batch
from ..flagship import init_weights, resolve_device
from ..models.networks import rcnn as _rcnn  # noqa: F401  (registers models)
from ..optims import lr_scheduler as _sched  # noqa: F401  (SCHEDULERS)
from ..optims import optimizer as _optim  # noqa: F401  (OPTIMS)
from ..utils.general import build_file, search_ckpt
from ..utils.jax_weights import load_jax_checkpoint, load_jax_variables
from ..utils.logger import RunLogger
from ..utils.registry import (DATASETS, MODELS, OPTIMS, SCHEDULERS,
                              build_from_cfg)

_TRAINING = ("is not ported yet: training through the runner comes with its "
             "training half (ROADMAP.md, Queue 1, item 9)")


class Runner:
    def __init__(self, device=None):
        """``device``: where the model runs; None is the CUDA card (an
        error where there is none)."""
        cfg = get_cfg()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.work_dir = os.path.abspath(cfg.work_dir or "work_dirs/run")
        self.max_epoch = cfg.max_epoch or 12
        self.max_iter = cfg.max_iter
        self.checkpoint_interval = cfg.checkpoint_interval or 1
        self.eval_interval = cfg.eval_interval
        self.log_interval = cfg.log_interval or 50
        self.swa_start_epoch = cfg.swa_start_epoch

        os.makedirs(self.work_dir, exist_ok=True)
        save_cfg(os.path.join(self.work_dir, "config.yaml"))
        self.logger = RunLogger(self.work_dir)

        # the weights are drawn on the CPU from the config's seed, so one
        # config gives the same model on every device
        self.model = build_from_cfg(cfg.model, MODELS)
        init_weights(self.model, torch.Generator().manual_seed(cfg.seed or 0))
        self.model.to(self.device)
        self.test_dataset = build_from_cfg(
            cfg.dataset and cfg.dataset.get("test"), DATASETS)
        self.epoch = 0
        self.iter = 0
        self._eval_ready = False
        self.test_stats: Dict[str, float] = {}

        self._build_optimizers()

        # auto-resume
        ckpt = search_ckpt(self.work_dir)
        if cfg.resume_path:
            self.load(cfg.resume_path, model_only=False)
        elif ckpt:
            self.load(ckpt, model_only=False)
        elif cfg.pretrained_weights:
            self.load(cfg.pretrained_weights, model_only=True)
        else:
            self._check_pretrained_request()

    def _check_pretrained_request(self):
        """``pretrained=True`` (on the backbone or the model) is never
        silently dropped: this environment cannot download published
        weights, so without a checkpoint it raises, unless the config
        sets ``allow_random_init`` (or RS_ALLOW_RANDOM_INIT is set). A
        path to a local checkpoint is loaded."""
        cfg = self.cfg
        mc = cfg.model if isinstance(cfg.model, dict) else {}
        bb = mc.get("backbone")
        # any truthy value is a request: True, "modelzoo://..." URLs and
        # paths all appear in the configs; only False / None are not
        pv = bb.get("pretrained") if isinstance(bb, dict) else None
        if not pv:
            pv = mc.get("pretrained")
        if not pv:
            return
        if isinstance(pv, str) and os.path.isfile(pv):
            self.load(pv, model_only=True)
            return
        if cfg.allow_random_init or os.environ.get("RS_ALLOW_RANDOM_INIT"):
            return
        bb_type = (bb or {}).get("type", mc.get("type", "model"))
        raise RuntimeError(
            f"config requests pretrained weights for backbone "
            f"'{bb_type}' (pretrained={pv!r}) but no usable checkpoint "
            "was found and this environment cannot download published "
            "weights. Either (a) set pretrained_weights=<path> in the "
            "config to a checkpoint pickle of the JAX runner or a flax "
            "variables pickle (tools/convert_checkpoint.py converts a "
            "torch/jittor checkpoint), or (b) opt into random "
            "initialization explicitly with allow_random_init=True in the "
            "config (or RS_ALLOW_RANDOM_INIT=1).")

    def _build_optimizers(self):
        """The optimizer and schedule, and the SWA pair when the config
        sets ``optimizer_swa`` (the JAX runner's default optimizer, SGD,
        is not ported and raises)."""
        cfg = self.cfg
        if cfg.parameter_groups_generator is not None:
            raise NotImplementedError(
                f"parameter_groups_generator {_TRAINING}")
        params = list(self.model.parameters())
        self.optimizer = build_from_cfg(
            dict(cfg.optimizer or dict(type="SGD", lr=0.01)), OPTIMS,
            params=params)
        self.scheduler = build_from_cfg(cfg.scheduler, SCHEDULERS)
        self.optimizer_swa = self.scheduler_swa = None
        if cfg.optimizer_swa is not None:
            self.optimizer_swa = build_from_cfg(dict(cfg.optimizer_swa),
                                                OPTIMS, params=params)
            self.scheduler_swa = build_from_cfg(cfg.scheduler_swa, SCHEDULERS)

    def _ensure_state(self):
        """Eval mode, with the parameters in the model's compute dtype (as
        ``build_flagship`` serves)."""
        if self._eval_ready:
            return
        dtype = self.model.compute_dtype
        if dtype is not None:
            self.model.to(dtype=dtype)
        self.model.eval()
        self._eval_ready = True

    # ------------------------------------------------------------------

    def run(self):
        raise NotImplementedError(f"Runner.run {_TRAINING}")

    def train(self):
        raise NotImplementedError(f"Runner.train {_TRAINING}")

    def val(self):
        raise NotImplementedError(f"Runner.val (with voc_eval) {_TRAINING}")

    def save(self):
        raise NotImplementedError(f"Runner.save {_TRAINING}")

    # ------------------------------------------------------------------

    def predict(self, images: np.ndarray, targets: Dict) -> Dict:
        """Dense detections of one collated batch (normalized NHWC
        ``images``, ``targets["scale_factor"]``) as numpy: polys
        [B, P, 8], scores [B, P, C], valid [B, P]."""
        self._ensure_state()
        out = self.model.predict(
            torch.from_numpy(images).to(self.device),
            torch.from_numpy(targets["scale_factor"]).to(self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    @staticmethod
    def postprocess_dense(out: Dict, metas, score_thresh=0.05):
        """Dense outputs -> per-image (polys, scores, labels) lists of
        the detections above ``score_thresh`` (labels 1-based); padding
        images (meta None) are skipped."""
        polys = np.asarray(out["polys"])
        scores = np.asarray(out["scores"])
        valid = np.asarray(out["valid"])
        results = []
        for i, meta in enumerate(metas):
            if meta is None:
                continue
            p, s, v = polys[i], scores[i], valid[i]
            keep = v[:, None] & (s > score_thresh)      # [P, C]
            ri, ci = np.nonzero(keep)
            results.append((p[ri], s[ri, ci], ci + 1))
        return results

    def test(self, flip_test=False):
        """Tile inference (+ flip TTA) -> ``test/test_{epoch}.pkl`` ->
        tile merge and submission when the config sets ``merge_cfg``.
        Records the tiles served, the seconds of inference and of the
        merge, and the detections, in ``test_stats``."""
        if self.test_dataset is None:
            raise ValueError("the config has no dataset.test")
        self._ensure_state()
        results = []
        modes = [None] + (["H", "V", "HV"] if flip_test else [])
        n_tiles, t0 = 0, time.perf_counter()
        for mode in modes:
            for images, targets, metas in self.test_dataset.batches(
                    flip_mode=mode):
                dets = self.postprocess_dense(self.predict(images, targets),
                                              metas)
                live = [m for m in metas if m]
                n_tiles += len(live)
                for det, meta in zip(dets, live):
                    results.append((det, meta))
        infer_s = time.perf_counter() - t0
        save_file = build_file(self.work_dir, f"test/test_{self.epoch}.pkl")
        with open(save_file, "wb") as f:
            pickle.dump(results, f)
        self.test_stats = dict(tiles=n_tiles, inference_s=infer_s,
                               detections=sum(len(d[1]) for d, _ in results))
        self.logger.print_log({"msg": f"test results -> {save_file}",
                               **self.test_stats})
        if self.cfg.dataset and self.cfg.dataset.get("test") and \
                self.cfg.merge_cfg is not None:
            from ..data.devkits.data_merge import data_merge_result
            merge_kw = dict(self.cfg.merge_cfg)
            if self.cfg.merge_nms_threshold_type is not None:
                merge_kw.setdefault("nms_threshold_type",
                                    self.cfg.merge_nms_threshold_type)
            t0 = time.perf_counter()
            data_merge_result(save_file, self.work_dir, self.epoch,
                              self.cfg.name or "run", **merge_kw)
            self.test_stats["merge_s"] = time.perf_counter() - t0
            self.logger.print_log({"msg": "merged",
                                   "merge_s": self.test_stats["merge_s"]})
        return results

    def run_on_images(self, image_files, save_dir=None):
        """Detections on raw (unnormalized, as in the JAX runner) RGB
        images, drawn into ``save_dir`` when given."""
        from ..data.io import load_rgb_array
        from ..utils.visualization import visualize_results

        outputs = []
        for path in image_files:
            arr = load_rgb_array(path).astype(np.float32)
            images, targets = collate_batch([(arr, dict(scale_factor=1.0))])
            dets = self.postprocess_dense(self.predict(images, targets),
                                          [dict()])[0]
            outputs.append((path, dets))
            if save_dir:
                visualize_results([dets], None, [path], save_dir)
        return outputs

    def test_time(self, iters=100, warmup=10):
        """Tiles per second of the model on the test dataset's first
        batch, over ``iters`` forwards after ``warmup``."""
        if self.test_dataset is None:
            raise ValueError("the config has no dataset.test")
        self._ensure_state()
        images, targets, _ = next(iter(self.test_dataset.batches()))
        x = torch.from_numpy(images).to(self.device)
        sf = torch.from_numpy(targets["scale_factor"]).to(self.device)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda: None)
        for _ in range(warmup):
            self.model.predict(x, sf)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            self.model.predict(x, sf)
        sync()
        fps = iters * images.shape[0] / (time.perf_counter() - t0)
        self.logger.print_log({"FPS": fps})
        return fps

    # ------------------------------------------------------------------

    def load(self, path, model_only=False):
        """Load a checkpoint pickle of the JAX runner (``{"meta", "model",
        "opt_state", "ema"}``, ``model`` a flax ``{"params",
        "batch_stats"}`` tree) or a bare flax variables pickle into the
        model. A resume (``model_only=False``) takes the epoch and
        iteration from ``meta`` and serves the EMA weights where the
        checkpoint has them, as the JAX runner evaluates; the optimizer
        state waits for the training half."""
        if os.path.isdir(path):
            raise RuntimeError(
                f"{path} is an orbax checkpoint directory; orbax is JAX-only. "
                f"Save the checkpoint as a pickle with the JAX runner "
                f"(use_orbax unset) to serve it here")
        data = load_jax_checkpoint(path)
        if isinstance(data, dict) and "model" in data:
            variables = data["model"]
            meta = data.get("meta") or {}
        else:
            variables, meta = data, {}
        if not model_only and meta:
            self.epoch = int(meta.get("epoch", 0))
            self.iter = int(meta.get("iter", 0))
            if data.get("ema") is not None:
                variables = dict(variables, params=data["ema"])
        load_jax_variables(self.model, variables)
        self.logger.print_log({"msg": f"loaded {path}"})
