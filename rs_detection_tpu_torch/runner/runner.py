"""The train/eval engine (counterpart of
``rs_detection_tpu/runner/runner.py``): builds the model, the optimizers
and schedulers and the train / val / test datasets from the global
config, and runs on the card (or on the CPU when the caller asks for it):

* ``run``: the epoch loop of ``train``, ``val`` every ``eval_interval``
  epochs, a checkpoint every ``checkpoint_interval`` epochs, and the SWA
  switch-over at ``swa_start_epoch`` (a fresh ``optimizer_swa`` state
  and the ``scheduler_swa`` schedule from its step 0);
* ``val``: ``predict`` -> ``postprocess_dense`` -> the dataset's
  mAP (VOC-style oriented; SSD's ``COCODataset``'s, COCO-style hbb), on
  the f32 master weights (the activations in the model's compute
  dtype), leaving training as it was;
* ``test`` (tile inference with optional flip-TTA -> results pickle ->
  tile merge -> submission), ``test_time`` and ``run_on_images``;
* ``save`` / ``load``: the port's checkpoint pickle
  (``utils/checkpoint.py``), and resume (auto, or ``resume_path``) from
  it or from the JAX runner's, with the epoch, the iteration and the
  optimizer's state (AdamW's moments or SGD's momentum).

The learning rate of a step is the schedule at the optimizer's own step
count and that count in epochs, as the JAX runner's optax schedule reads
it. Step ``i`` samples with a generator seeded from (``seed``, i), and
epoch ``e`` draws its augmentations from Python's and numpy's global
generators seeded from (``seed``, e) (``seed_host_rngs``), so a resumed
run trains as an unbroken one.
"""

from __future__ import annotations

import os
import pickle
import random
import time
from typing import Dict

import numpy as np
import torch

from ..config import get_cfg, save_cfg
from ..data import dota as _dota  # noqa: F401  (registers the datasets)
from ..data import image as _image  # noqa: F401  (registers ImageDataset)
from ..data import yolo as _yolo  # noqa: F401  (registers COCODataset)
from ..data.scene import SceneDataset
from ..data.collate import collate_batch
from ..flagship import init_weights, resolve_device
from ..models import param_generators as _pg  # noqa: F401  (MODELS too)
from ..models.networks import gliding_vertex as _gv  # noqa: F401  (as well)
from ..models.networks import rcnn as _rcnn  # noqa: F401  (registers models)
from ..models.networks import r3det as _r3det  # noqa: F401  (as well)
from ..models.networks import roi_transformer as _rt  # noqa: F401  (as well)
from ..models.networks import single_stage as _ss  # noqa: F401  (as well)
from ..optims import lr_scheduler as _sched  # noqa: F401  (SCHEDULERS)
from ..optims import optimizer as _optim  # noqa: F401  (OPTIMS)
from ..parallel.train_step import train_step
from ..utils.checkpoint import (FORMAT, load_model_arrays,
                                load_optimizer_arrays, model_arrays,
                                optimizer_arrays, read_checkpoint)
from ..utils.general import build_file, check_interval, search_ckpt
from ..utils.jax_weights import loss_state_names
from ..utils.logger import RunLogger
from ..utils.registry import (DATASETS, MODELS, OPTIMS, SCHEDULERS,
                              build_from_cfg)


def constant_lr(base_lr, step, epoch):
    """The schedule of a config without one."""
    return base_lr


def seed_of(*keys: int) -> int:
    """A 32-bit seed drawn from the integers ``keys``."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1)[0])


def seed_host_rngs(seed: int, epoch: int) -> None:
    """Seed Python's ``random`` and ``np.random``, from which the
    transforms draw, for epoch ``epoch`` of a run seeded ``seed``."""
    s = seed_of(seed, epoch)
    random.seed(s)
    np.random.seed(s)


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
        if (cfg.model or {}).get("ema"):
            raise NotImplementedError(
                "model.ema (the per-step EMA of the YOLO configs) is not "
                "ported yet (ROADMAP.md, Queue 1, item 11)")

        os.makedirs(self.work_dir, exist_ok=True)
        save_cfg(os.path.join(self.work_dir, "config.yaml"))
        self.logger = RunLogger(self.work_dir)

        # the weights are drawn on the CPU from the config's seed, so one
        # config gives the same model on every device
        self.model = build_from_cfg(cfg.model, MODELS)
        init_weights(self.model, torch.Generator().manual_seed(cfg.seed or 0))
        self.model.to(self.device)
        datasets = cfg.dataset or {}
        self.train_dataset = build_from_cfg(datasets.get("train"), DATASETS)
        self.val_dataset = build_from_cfg(datasets.get("val"), DATASETS)
        self.test_dataset = build_from_cfg(datasets.get("test"), DATASETS)
        # a raw-scene dataset tiles on the runner's device unless its
        # config names one
        if isinstance(self.test_dataset, SceneDataset) and \
                self.test_dataset.device is None:
            self.test_dataset.device = self.device
        self.steps_per_epoch = 1 if self.train_dataset is None else max(
            1, len(self.train_dataset) // self.train_dataset.batch_size)
        self.epoch = 0
        self.iter = 0
        self._swa_active = False
        self._serving_cast = False
        self._profiler = None
        self.test_stats: Dict[str, float] = {}
        # host seconds of each training step (from the end of the one
        # before) and seconds the loop waited for a batch; the records
        # logged every log_interval steps; the last val's APs
        self.train_stats = dict(step_s=[], loader_wait_s=0.0)
        self.history = []
        self.val_aps: Dict[str, float] = {}

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
            "config to a checkpoint pickle of the port or of the JAX "
            "runner, or a flax variables pickle "
            "(tools/convert_checkpoint.py converts a "
            "torch/jittor checkpoint), or (b) opt into random "
            "initialization explicitly with allow_random_init=True in the "
            "config (or RS_ALLOW_RANDOM_INIT=1).")

    def _build_optimizers(self):
        """The optimizer and schedule, and the SWA pair when the config
        sets ``optimizer_swa`` (its learning rate defaults to the main
        one's). A config without an optimizer trains with SGD at rate
        0.01, the JAX runner's default. ``parameter_groups_generator``
        links its groups into the main optimizer (not the SWA one), with
        the optimizer's ``weight_decay`` as the base, as the JAX runner
        wraps ``tx``."""
        cfg = self.cfg
        params = list(self.model.named_parameters())
        opt_cfg = dict(cfg.optimizer or dict(type="SGD"))
        opt_cfg.setdefault("lr", 0.01)
        self.optimizer = build_from_cfg(opt_cfg, OPTIMS, params=params)
        pg = cfg.parameter_groups_generator
        if isinstance(pg, dict) and pg.get("type"):
            wrap = build_from_cfg(dict(pg), MODELS)
            self.optimizer = wrap(self.optimizer, base_weight_decay=float(
                opt_cfg.get("weight_decay", 0.0) or 0.0))
        self.scheduler = build_from_cfg(cfg.scheduler, SCHEDULERS) \
            or constant_lr
        self.optimizer_swa, self.scheduler_swa = None, constant_lr
        if cfg.optimizer_swa is not None:
            swa_cfg = dict(cfg.optimizer_swa)
            swa_cfg.setdefault("lr", opt_cfg["lr"])
            self.optimizer_swa = build_from_cfg(swa_cfg, OPTIMS, params=params)
            self.scheduler_swa = build_from_cfg(cfg.scheduler_swa,
                                                SCHEDULERS) or constant_lr

    def _adopt_swa(self):
        """Train on with the SWA optimizer (its state fresh unless a
        checkpoint's is loaded into it) and the SWA schedule."""
        self._swa_active = True
        self.optimizer, self.scheduler = self.optimizer_swa, self.scheduler_swa

    def _ensure_state(self):
        """Eval mode, with the parameters cast once to the model's compute
        dtype (as ``build_flagship`` serves); training raises after."""
        dtype = self.model.compute_dtype
        if dtype is not None and next(self.model.parameters()).dtype != dtype:
            self.model.to(dtype=dtype)
            self._serving_cast = True
        self.model.eval()

    # ------------------------------------------------------------------

    @property
    def finish(self):
        if self.max_iter is not None:
            return self.iter >= self.max_iter
        return self.epoch >= self.max_epoch

    def run(self):
        """Train to ``max_epoch`` (or ``max_iter``) with the intervals'
        val and checkpoints; a last checkpoint and val at the end."""
        self.logger.print_log({"msg": "start running"})
        saved_epoch = validated_epoch = -1
        while not self.finish:
            self.train()
            if check_interval(self.epoch - 1, self.eval_interval):
                self.val()
                validated_epoch = self.epoch
            if check_interval(self.epoch - 1, self.checkpoint_interval):
                self.save()
                saved_epoch = self.epoch
        if saved_epoch != self.epoch:
            self.save()
        if self.val_dataset is not None and validated_epoch != self.epoch:
            self.val()

    def train(self):
        """One epoch (or up to ``max_iter``) of training steps over the
        train dataset, prefetched by a background thread. The losses
        become host numbers only every ``log_interval`` steps.
        ``profile_step`` traces that step and the next two with
        ``torch.profiler`` into ``work_dir/profile``."""
        if self.train_dataset is None:
            raise ValueError("the config has no dataset.train")
        if self._serving_cast:
            raise RuntimeError(
                "the parameters were cast to the compute dtype to serve; "
                "training needs the f32 master weights: build a new Runner")
        if (self.swa_start_epoch is not None and self.optimizer_swa is not None
                and self.epoch >= self.swa_start_epoch
                and not self._swa_active):
            self._adopt_swa()
        seed = self.cfg.seed or 0
        seed_host_rngs(seed, self.epoch)
        self.model.train()
        profile_at = self.cfg.profile_step
        t_start, first_iter, n_imgs = time.time(), self.iter, 0
        batches = self.train_dataset.prefetch(seed=self.epoch)
        t_last = time.perf_counter()
        try:
            while True:
                t0 = time.perf_counter()
                item = next(batches, None)
                self.train_stats["loader_wait_s"] += time.perf_counter() - t0
                if item is None:
                    break
                images, targets, _ = item
                x = self._to_device(images)
                tgt = {k: self._to_device(v) for k, v in targets.items()}
                gen = torch.Generator(device=self.device).manual_seed(
                    seed_of(seed, self.iter))
                if profile_at is not None and self.iter == profile_at:
                    self._start_profile()
                losses = train_step(
                    self.model, self.optimizer, self.scheduler, x, tgt, gen,
                    epoch=self.optimizer.iterations / self.steps_per_epoch)
                lr = self.optimizer.param_groups[0]["lr"]
                self.iter += 1
                n_imgs += images.shape[0]
                if self._profiler is not None and self.iter == profile_at + 3:
                    self._stop_profile()
                if check_interval(self.iter - 1, self.log_interval):
                    dt = time.time() - t_start
                    remaining = (self.max_epoch * self.steps_per_epoch
                                 - self.iter)
                    record = dict(
                        name=self.cfg.name or "run", epoch=self.epoch,
                        iter=self.iter, lr=lr,
                        fps=round(n_imgs / max(dt, 1e-9), 2),
                        eta_s=int(remaining * dt
                                  / max(self.iter - first_iter, 1)),
                        **{k: float(v) for k, v in losses.items()})
                    self.logger.log(record)
                    self.history.append(record)
                now = time.perf_counter()
                self.train_stats["step_s"].append(now - t_last)
                t_last = now
                if self.finish:
                    break
        finally:
            batches.close()
        self.epoch += 1
        if self._profiler is not None and self.finish:
            self._stop_profile()

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the model's device; to the card through pinned
        memory, so that the copy does not wait for the step before."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()

    def _stop_profile(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        path = build_file(self.work_dir, "profile/trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        self.logger.print_log({"msg": f"profiler trace -> {path}"})

    def val(self):
        """mAP of the val dataset (``evaluate``'s dict, also logged; its
        scalars in ``val_aps``). The model serves its f32 master weights
        in eval mode, its activations in the compute dtype, and goes back
        to the mode it was in. ``evaluate`` is handed one (detections,
        meta) pair an image, in the dataset's order."""
        if self.val_dataset is None:
            self.logger.print_log({"msg": "no val dataset, skip"})
            return {}
        training = self.model.training
        self.model.eval()
        results = []
        try:
            for images, targets, metas in self.val_dataset.batches():
                dets = self.postprocess_dense(self._forward(images, targets),
                                              metas)
                for det, meta in zip(dets, [m for m in metas if m]):
                    results.append((det, meta))
        finally:
            self.model.train(training)
        aps = self.val_dataset.evaluate(results, self.work_dir, self.epoch,
                                        self.logger)
        self.val_aps = {k: float(v) for k, v in aps.items()
                        if not isinstance(v, list)}
        self.logger.log(self.val_aps)
        return aps

    # ------------------------------------------------------------------

    def predict(self, images, targets: Dict) -> Dict:
        """Dense detections of one collated batch (normalized NHWC
        ``images``, numpy or a tensor already on the device, and
        ``targets["scale_factor"]``) as numpy: polys [B, P, 8], scores
        [B, P, C], valid [B, P]."""
        self._ensure_state()
        return self._forward(images, targets)

    def _forward(self, images, targets: Dict) -> Dict:
        out = self.model.predict(
            torch.as_tensor(images, device=self.device),
            torch.as_tensor(targets["scale_factor"], device=self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    @staticmethod
    def postprocess_dense(out: Dict, metas, score_thresh=0.05):
        """Dense outputs -> per-image (polys, scores, labels) lists of
        the detections above ``score_thresh`` (labels 1-based); padding
        images (meta None) are skipped. Scores [B, P, C] (a score a class)
        or, with "labels" [B, P] (0-based, the single-stage heads'), [B,
        P] (one a detection). The JAX runner reads only the first form
        and raises on the second (ROADMAP.md, Queue 3). A meta's
        ``letterbox`` (r, dw, dh), the resize and pad that a
        ``YoloDataset`` gave the image, is undone on the polygons: they
        come out in the image's own frame (where the JAX runner leaves
        them in the letterboxed one)."""
        polys = np.asarray(out["polys"])
        scores = np.asarray(out["scores"])
        valid = np.asarray(out["valid"])
        labels = out.get("labels")
        results = []
        for i, meta in enumerate(metas):
            if meta is None:
                continue
            p, s, v = polys[i], scores[i], valid[i]
            if meta.get("letterbox") is not None:
                r, dw, dh = meta["letterbox"]
                p = ((p - np.asarray([dw, dh] * 4, p.dtype))
                     / np.asarray(r, p.dtype))
            if labels is not None:
                keep = v & (s > score_thresh)
                results.append((p[keep], s[keep],
                                np.asarray(labels[i])[keep] + 1))
                continue
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
        x = torch.as_tensor(images, device=self.device)
        sf = torch.as_tensor(targets["scale_factor"], device=self.device)
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

    def save(self):
        """``checkpoints/ckpt_{epoch}.pkl`` in the port's format
        (``utils/checkpoint.py``); returns its path."""
        if self.cfg.use_orbax:
            raise NotImplementedError(
                "use_orbax: orbax checkpoints are JAX-only; the port saves "
                "its own pickle (leave use_orbax unset)")
        path = build_file(self.work_dir, f"checkpoints/ckpt_{self.epoch}.pkl")
        data = dict(
            meta=dict(format=FORMAT, epoch=self.epoch, iter=self.iter,
                      max_epoch=self.max_epoch, swa_active=self._swa_active,
                      save_time=time.time(), config=self.cfg.dump()),
            model=model_arrays(self.model),
            opt_state=optimizer_arrays(self.optimizer, self.model),
            ema=None)
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        self.logger.print_log({"msg": f"saved {path}"})
        return path

    def load(self, path, model_only=False):
        """Load a checkpoint of the port, one of the JAX runner (read
        without jax) or a bare flax variables pickle into the model. A
        resume (``model_only=False``) also takes the epoch and iteration
        from ``meta``, adopts the SWA optimizer when the checkpoint was
        saved in the SWA phase, loads the optimizer state into the
        optimizer in use, and serves the EMA weights where the
        checkpoint has them, as the JAX runner evaluates."""
        if os.path.isdir(path):
            raise RuntimeError(
                f"{path} is an orbax checkpoint directory; orbax is JAX-only. "
                f"Save the checkpoint as a pickle with the JAX runner "
                f"(use_orbax unset) to load it here")
        meta, arrays, opt_state, ema = read_checkpoint(path)
        if not model_only and meta:
            self.epoch = int(meta.get("epoch", 0))
            self.iter = int(meta.get("iter", 0))
            if ema is not None:
                arrays = dict(arrays, **ema)
            if meta.get("swa_active") and self.optimizer_swa is not None:
                self._adopt_swa()
            if opt_state is not None:
                load_optimizer_arrays(self.optimizer, self.model, opt_state)
        # a JAX tree may lack the heads' loss states: they keep theirs
        load_model_arrays(self.model, arrays, optional=() if
                          meta.get("format") == FORMAT else
                          loss_state_names(self.model))
        self.logger.print_log({"msg": f"loaded {path}"})
