"""Eigen-CAM inspection of a detector (counterpart of
``tools/analysis_tools/detection_cam.py``): one feature level's
activations projected onto their first principal component, overlaid on
the image as a heat map; no gradients, any backbone.

The model comes from a config through the port's registry, its weights
from ``--checkpoint``: a pickle of the port's or the JAX runner's
(``utils/checkpoint.py:read_checkpoint``) or a reference (JDet) state
dict, which goes through the port's converter and audit
(``tools/parity_check.py:load_and_audit``). Without one the config's
seeded init. As in the JAX tool the features are taken of the raw
pixels. The heat map is OpenCV's JET colour map and its bilinear resize,
computed with numpy (``overlay``): the card's machine has no OpenCV.

Usage:
  python -m rs_detection_tpu_torch.tools.detection_cam --config-file CFG \\
      --image tile.png [--checkpoint ckpt.pkl] [--level 0] [--out cam.png]
      [--cpu]
"""

import argparse

import numpy as np

# OpenCV's COLORMAP_JET (RGB) is piecewise linear in the 8-bit index:
# each channel's (index, value) knots, interpolated exactly
_JET_KNOTS = (
    ((0, 0), (95, 0), (96, 2), (159, 254), (160, 255), (223, 255),
     (224, 252), (255, 128)),
    ((0, 0), (32, 0), (95, 252), (96, 255), (159, 255), (160, 252),
     (223, 0), (255, 0)),
    ((0, 128), (31, 252), (32, 255), (95, 255), (96, 254), (158, 6),
     (159, 1), (160, 0), (255, 0)),
)


def jet_lut() -> np.ndarray:
    """[256, 3] uint8 RGB: ``cv2.applyColorMap(i, cv2.COLORMAP_JET)``
    of each index, channels reversed."""
    i = np.arange(256)
    return np.stack([np.round(np.interp(i, *zip(*k))) for k in _JET_KNOTS],
                    -1).astype(np.uint8)


def eigen_cam(feat: np.ndarray) -> np.ndarray:
    """[H, W, C] feature map -> [H, W] first-principal-component map."""
    h, w, c = feat.shape
    flat = feat.reshape(-1, c)
    flat = flat - flat.mean(0, keepdims=True)
    # power iteration for the top right-singular vector
    v = np.ones((c,)) / np.sqrt(c)
    for _ in range(16):
        v = flat.T @ (flat @ v)
        v /= (np.linalg.norm(v) + 1e-12)
    cam = (flat @ v).reshape(h, w)
    cam = np.maximum(cam, 0)
    cam = cam / (cam.max() + 1e-12)
    return cam


def overlay(image: np.ndarray, cam: np.ndarray, alpha=0.5):
    """``cam`` [h, w] in [0, 1] as a JET heat map resized (bilinear) to
    the uint8 RGB ``image`` and blended: OpenCV's pixels."""
    from ..data.cv_ops import resize_linear

    heat = jet_lut()[(cam * 255).astype(np.uint8)]
    heat = resize_linear(heat, (image.shape[1], image.shape[0]))
    return (alpha * heat + (1 - alpha) * image).astype(np.uint8)


def load_weights(model, path):
    """A runner checkpoint (the port's or the JAX runner's) or a
    reference state dict (flat dotted names) into ``model``."""
    from ..utils.checkpoint import (FORMAT, load_model_arrays,
                                    read_checkpoint)
    from ..utils.jax_weights import load_jax_checkpoint, loss_state_names
    from . import parity_check as pc

    data = load_jax_checkpoint(path)
    port = (data.get("meta") or {}).get("format") == FORMAT
    state = data.get("model", data.get("state_dict", data))
    if not port and not any(isinstance(v, dict) for v in state.values()):
        return pc.load_and_audit(model, path)
    _, arrays, _, _ = read_checkpoint(path)
    return load_model_arrays(model, arrays, optional=loss_state_names(model))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--image", required=True)
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--out", default="cam.png")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from ..flagship import init_weights, resolve_device
    from . import parity_check as pc

    device = resolve_device("cpu" if args.cpu else None)
    model, cfg = pc.build_model(args.config_file)
    init_weights(model, torch.Generator().manual_seed(cfg.seed or 0))
    if args.checkpoint:
        load_weights(model, args.checkpoint)
    model.to(device).eval()
    with Image.open(args.image) as im:
        img = np.asarray(im.convert("RGB"))
    with torch.no_grad():
        feats = model.extract_feats(
            torch.from_numpy(img.astype(np.float32))[None].to(device))
    cam = eigen_cam(feats[args.level][0].float().cpu().numpy())
    Image.fromarray(overlay(img, cam)).save(args.out)
    print("saved", args.out)
    return cam


if __name__ == "__main__":
    main()
