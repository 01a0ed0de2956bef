"""Swin Transformer backbone (counterpart of
``rs_detection_tpu/models/backbones/swin.py``): patch embed, windowed
multi-head self-attention with a relative position bias, shifted windows
in every second block, patch merging between stages; ``swin_tiny``,
``swin_small`` and ``swin_base``.

NHWC throughout, as the JAX module. Attention is plain PyTorch
(``matmul`` and ``softmax``), as JAX computes it outside any kernel. As
in JAX:

* every LayerNorm takes flax's epsilon, 1e-6;
* a block zero-pads its normed input to a multiple of the window, rolls
  it by -shift, attends with -100 between the regions of the padded grid
  (``shift_attn_mask``), rolls back by +shift and crops; a stage whose
  map is no larger than the window takes no shift;
* patch merging concatenates each 2x2 in (row, column) order
  (``[x00, x01, x10, x11]``; the official Swin interleaves it in the
  other order), padding an odd side first;
* ``drop_path_rate`` defaults to 0.2.

Flax creates a block's ``relative_position_bias_table`` at the window the
block meets: ``min(window_size, H, W)``, smaller than ``window_size``
only where a stage's map is (late stages of small inputs: Swin-L-384's
stage 4 at 256^2). The port holds the table of the whole window, as every
input of at least 32 x ``window_size`` pixels makes it in JAX, and a
smaller window reads the table's central rows (``relative_position_index``
with ``table_ws``); ``utils/jax_weights.py`` puts a smaller JAX table at
those rows.

Submodule names follow the flax tree (``patch_embed``, ``patch_norm``,
``block{i}_{j}`` with ``norm1``, ``attn.qkv``,
``attn.relative_position_bias_table``, ``attn.proj``, ``norm2``, ``fc1``,
``fc2``; ``out_norm{i}``, ``merge_norm{i}``, ``merge{i}``).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.activations import exact_gelu
from ...utils.registry import BACKBONES
from ..utils.modules import DropPath, conv2d, layer_norm, linear


def window_partition(x, ws: int):
    """[B, H, W, C] -> [B * H/ws * W/ws, ws * ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    """The inverse of ``window_partition``."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


@functools.lru_cache(maxsize=None)
def relative_position_index(ws: int, table_ws: int = 0) -> np.ndarray:
    """[ws^2, ws^2] rows of a ``table_ws`` window's bias table (``ws`` by
    default) for each (query, key) pair of a ``ws`` window: the offsets
    (dy, dx) in [1 - ws, ws - 1]^2 at row (dy + T - 1) * (2T - 1) + dx +
    T - 1 of the table of T = ``table_ws``."""
    t = table_ws or ws
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + t - 1
    return rel[:, :, 0] * (2 * t - 1) + rel[:, :, 1]


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """[windows, ws^2, ws^2]: 0 within a region of the rolled grid, -100
    across regions."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3) \
        .reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        """x: [windows * B, N, C]; mask: [windows, N, N] or None."""
        bw, n, c = x.shape
        heads = self.num_heads
        ws = int(round(n ** 0.5))
        qkv = linear(self.qkv, x).reshape(bw, n, 3, heads, c // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul(q * (c // heads) ** -0.5, k.transpose(-2, -1))
        rpi = torch.from_numpy(relative_position_index(
            ws, self.window_size).reshape(-1)).to(x.device)
        bias = self.relative_position_bias_table[rpi].to(x.dtype)
        attn = attn + bias.reshape(n, n, heads).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, heads, n, n)
                    + mask[None, :, None]).reshape(bw, heads, n, n)
        out = torch.matmul(attn.softmax(dim=-1), v)
        return linear(self.proj, out.transpose(1, 2).reshape(bw, n, c))


class SwinBlock(nn.Module):

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        """x: NHWC -> NHWC."""
        b, h, w, c = x.shape
        ws = min(self.window_size, h, w)
        shift = self.shift if ws < min(h, w) else 0
        y = layer_norm(self.norm1, x)
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        if hp != h or wp != w:
            y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(shift_attn_mask(hp, wp, ws, shift)).to(
                device=x.device, dtype=x.dtype)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, hp,
                           wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.drop_path(y[:, :h, :w])
        y = linear(self.fc2, exact_gelu(linear(self.fc1,
                                               layer_norm(self.norm2, x))))
        return x + self.drop_path(y)


@BACKBONES.register_module()
class Swin(nn.Module):
    """The JAX Swin's fields."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, drop_path_rate: float = 0.2,
                 out_indices: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, 4)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=1e-6)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        dim, cur = embed_dim, 0
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            for j in range(depth):
                self.add_module(f"block{i}_{j}", SwinBlock(
                    dim, heads, window_size,
                    shift=0 if j % 2 == 0 else window_size // 2,
                    drop_path=float(dpr[cur + j])))
            cur += depth
            if i in self.out_indices:
                self.add_module(f"out_norm{i}", nn.LayerNorm(dim, eps=1e-6))
            if i < len(depths) - 1:
                self.add_module(f"merge_norm{i}",
                                nn.LayerNorm(4 * dim, eps=1e-6))
                self.add_module(f"merge{i}",
                                nn.Linear(4 * dim, 2 * dim, bias=False))
                dim *= 2

    def forward(self, images):
        """images: NHWC [B, H, W, 3] -> the NHWC outputs of the stages in
        ``out_indices``."""
        x = conv2d(self.patch_embed, images.permute(0, 3, 1, 2))
        x = layer_norm(self.patch_norm, x.permute(0, 2, 3, 1))
        outs = []
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                x = getattr(self, f"block{i}_{j}")(x)
            if i in self.out_indices:
                outs.append(layer_norm(getattr(self, f"out_norm{i}"), x))
            if i < len(self.depths) - 1:
                b, h, w, c = x.shape
                if h % 2 or w % 2:
                    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
                    b, h, w, c = x.shape
                x = x.reshape(b, h // 2, 2, w // 2, 2, c) \
                    .permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2,
                                                       4 * c)
                m = getattr(self, f"merge{i}")
                x = F.linear(layer_norm(getattr(self, f"merge_norm{i}"), x),
                             m.weight.to(x.dtype))
        return tuple(outs)


def _swin(**arch):
    def ctor(pretrained=False, **kw):
        return Swin(**arch, **kw)
    return ctor


BACKBONES.register_module(name="swin_tiny", module=_swin(
    embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)))
BACKBONES.register_module(name="swin_small", module=_swin(
    embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)))
BACKBONES.register_module(name="swin_base", module=_swin(
    embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)))
