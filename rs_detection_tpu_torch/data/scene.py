"""Raw-scene test dataset, tiled on the device (counterpart of
``rs_detection_tpu/data/scene.py``): each scene is decoded on the host
and moved to the device once as uint8, resized there per rate
(``rates``), cut into the overlapping tile grid (``device_tiler``),
normalized and flipped there. It yields the ``(images, targets, metas)``
of ``ImageDataset`` with the splitter's tile names
(``name__rate__left___up``), so ``Runner.test``, its flip-TTA and the
tile merge work on it unchanged.

Three resizes, each its JAX counterpart's (``ROADMAP.md``, Queue 3):

* ``rates=[...]``: ``device_resize.resize_cubic`` with the JAX package's
  ``in / out`` tables; the resized tiles stay f32;
* ``rate=r`` (one rate): Pillow's ``BICUBIC`` on the host (Keys a =
  -0.5), as the JAX dataset does;
* the splitter (``devkits/img_split.py``) follows cv2's ``fx = rate``.

``screen=dict(checkpoint=..., thresh=t | budget=K, model=...,
allow_random_init=...)`` scores each scene-variant's unflipped tiles
with a ``TileScreen`` (its count padded to a multiple of 8) and serves
only the tiles it keeps: ``budget`` the top K logits (numpy's argsort on
the host, as in JAX), ``thresh`` those whose sigmoid reaches ``t``;
``screen_stats`` counts the tiles scored and kept. A checkpoint of the
JAX ``tools/train_screen.py`` (a pickle of jax arrays) or of the port's
loads without jax.

``device`` is where the tiling, normalize, flips and screen run: the
runner's device when a ``Runner`` serves the dataset and ``device`` is
None, else the CUDA card (an error where there is none).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

from ..flagship import resolve_device
from ..models.networks.tile_screen import TileScreen  # noqa: F401
from ..utils.general import list_images
from ..utils.jax_weights import load_jax_checkpoint, load_jax_variables
from ..utils.registry import DATASETS, MODELS, build_from_cfg
from .device_resize import resize_cubic
from .device_tiler import tile_scene
from .io import load_rgb


def normalize_tiles(tiles: torch.Tensor, mean: torch.Tensor,
                    std: torch.Tensor, to_bgr: bool,
                    flip_mode: Optional[str]) -> torch.Tensor:
    """[N, S, S, 3] tiles -> normalized f32, flipped for flip-TTA (H on
    the W axis, V on the H axis), on the tiles' device."""
    t = tiles.float()
    if to_bgr:
        t = t.flip(-1)
    t = (t - mean) / std
    if flip_mode:
        if "H" in flip_mode:
            t = t.flip(2)
        if "V" in flip_mode:
            t = t.flip(1)
    return t


@DATASETS.register_module()
class SceneDataset:
    def __init__(self, images_dir=None, images_file=None,
                 subsize: int = 1024, gap: int = 200, rate: float = 1.0,
                 rates=None, dataset_type: str = "DOTA",
                 batch_size: int = 1,
                 mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375), to_bgr: bool = False,
                 num_workers: int = 0, shuffle: bool = False,
                 max_gt: int = 1, screen=None, device=None, **kw):
        self.images = (list_images(images_dir) if images_dir
                       else list(images_file))
        self.subsize = subsize
        self.gap = gap
        self.rate = rate
        self.rates = [float(r) for r in rates] if rates else None
        self.dataset_type = dataset_type
        self.batch_size = batch_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_bgr = to_bgr
        self.total_len = len(self.images)
        self.device = device
        self.screen = dict(screen) if screen else None
        if self.screen and ("thresh" not in self.screen
                            and "budget" not in self.screen):
            raise ValueError(
                "SceneDataset screen= needs 'thresh' or 'budget'")
        self._screen_model = None
        self.screen_stats = dict(total=0, kept=0)

    def _screen_setup(self, device):
        """Build and load the screen net (at the first scored tiles)."""
        cfg = dict(self.screen.get("model") or {"type": "TileScreen"})
        model = build_from_cfg(cfg, MODELS)
        ckpt = self.screen.get("checkpoint")
        if ckpt:
            data = load_jax_checkpoint(ckpt)
            sd = data.get("model", data) if isinstance(data, dict) \
                else data
            load_jax_variables(model, sd)
        elif not self.screen.get("allow_random_init"):
            raise ValueError(
                "SceneDataset screen= without checkpoint= would "
                "screen with random weights; train one with "
                "rs_detection_tpu_torch/tools/train_screen.py or set "
                "allow_random_init=True (tests/benchmarks only)")
        self._screen_model = model.to(device).eval()

    def _screen_select(self, tiles: torch.Tensor) -> np.ndarray:
        """Score a scene-variant's tiles; return the kept tile indices
        (ascending)."""
        if self._screen_model is None:
            self._screen_setup(tiles.device)
        n = tiles.shape[0]
        pad = (-n) % 8
        t = torch.cat([tiles, tiles.new_zeros((pad,) + tiles.shape[1:])]) \
            if pad else tiles
        with torch.no_grad():
            logits = self._screen_model(t)[:n].cpu().numpy()
        if "budget" in self.screen:
            k = min(int(self.screen["budget"]), n)
            idx = np.sort(np.argsort(-logits)[:k])
        else:
            p = 1.0 / (1.0 + np.exp(-logits))
            idx = np.nonzero(p >= float(self.screen["thresh"]))[0]
        self.screen_stats["total"] += n
        self.screen_stats["kept"] += len(idx)
        return idx

    def __len__(self):
        return self.total_len

    def _load_scene(self, path: str) -> np.ndarray:
        """The scene as uint8 RGB; resized by Pillow's bicubic on the
        host when ``rate`` is not 1."""
        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None  # DOTA scenes exceed PIL default
        img = load_rgb(path)
        if self.rate != 1.0:
            img = img.resize((int(round(img.width * self.rate)),
                              int(round(img.height * self.rate))),
                             Image.BICUBIC)
        return np.array(img, np.uint8)

    def _variants(self, path: str, device):
        """(rate, scene tensor) of one scene, one at a time: the uint8
        scene and, per other rate, its f32 resize."""
        if not self.rates:
            yield float(self.rate), torch.from_numpy(
                self._load_scene(path)).to(device)
            return
        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None
        full = torch.from_numpy(np.array(load_rgb(path), np.uint8)).to(
            device)
        for r in self.rates:
            if r == 1.0:
                yield r, full
            else:
                yield r, resize_cubic(full, int(round(full.shape[0] * r)),
                                      int(round(full.shape[1] * r)))

    def batches(self, flip_mode: Optional[str] = None) -> Iterator:
        """Yield (images [B, S, S, 3] f32 on the device, targets (the
        ``collate_batch`` schema, numpy, no ground truth), metas).

        Tiles stream across scene boundaries: a batch may hold the tail
        of one scene and the head of the next, so only the dataset's last
        batch is padded (its padding's metas are None)."""
        device = resolve_device(self.device)
        mean = torch.as_tensor(self.mean, device=device)
        std = torch.as_tensor(self.std, device=device)
        s = self.subsize
        bs = self.batch_size
        rate_tag = str(float(self.rate))     # ImgSplit names use "1.0"
        targets = dict(
            rboxes=np.zeros((bs, 1, 5), np.float32),
            hboxes=np.zeros((bs, 1, 4), np.float32),
            polys=np.zeros((bs, 1, 8), np.float32),
            labels=np.zeros((bs, 1), np.int32),
            gt_mask=np.zeros((bs, 1), bool),
            img_hw=np.full((bs, 2), float(s), np.float32),
            scale_factor=np.ones((bs,), np.float32))

        pend_tiles = None                    # [n, S, S, 3] f32
        pend_metas: list = []
        for path in self.images:
            stem = os.path.splitext(os.path.basename(path))[0]
            for r, scene in self._variants(path, device):
                tiles_u8, offsets = tile_scene(scene, s, self.gap)
                del scene
                tiles = normalize_tiles(tiles_u8, mean, std, self.to_bgr,
                                        flip_mode)
                if self.screen is not None:
                    # the unflipped tiles, so that every flip-TTA pass
                    # keeps the same tiles
                    screen_in = tiles if not flip_mode else normalize_tiles(
                        tiles_u8, mean, std, self.to_bgr, None)
                    keep = self._screen_select(screen_in)
                    if len(keep) == 0:
                        continue
                    tiles = tiles[torch.as_tensor(keep, device=device)]
                    offsets = offsets[keep]
                del tiles_u8
                rtag = str(r) if self.rates else rate_tag
                for lf, up in offsets:
                    tile_name = f"{stem}__{rtag}__{lf}___{up}.png"
                    pend_metas.append(dict(
                        filename=tile_name,
                        # the merge parses the tile offsets from the
                        # img_file basename (data_merge.py prepare_data)
                        img_file=tile_name,
                        scene_file=path,
                        img_size=(s, s), ori_img_size=(s, s),
                        scale_factor=1.0,
                        **(dict(flip_mode=flip_mode)
                           if flip_mode else {})))
                pend_tiles = (tiles if pend_tiles is None
                              else torch.cat([pend_tiles, tiles]))
                while pend_tiles.shape[0] >= bs:
                    # a fresh dict a batch: consumers may add keys
                    yield (pend_tiles[:bs], dict(targets),
                           pend_metas[:bs])
                    pend_tiles = pend_tiles[bs:]
                    pend_metas = pend_metas[bs:]
        n_left = 0 if pend_tiles is None else pend_tiles.shape[0]
        if n_left:
            batch = torch.cat([pend_tiles, pend_tiles.new_zeros(
                (bs - n_left,) + pend_tiles.shape[1:])])
            yield (batch, dict(targets),
                   pend_metas + [None] * (bs - n_left))
