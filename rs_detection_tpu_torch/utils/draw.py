"""Matplotlib drawing primitives for detection visualization
(counterpart of ``rs_detection_tpu/utils/draw.py``): axes-level box and
polygon renderers for the CAM tool and notebook-style inspection, and
the colour helpers. matplotlib is imported inside each function: the
card's machine has none, and nothing else of the port needs it.
Pillow-based whole-image rendering is ``utils/visualization.py``.
"""

from __future__ import annotations

import numpy as np


def single_color_val(color):
    """One color spec -> matplotlib RGB tuple. Accepts a named color,
    a '#rrggbb' hex string, a 0-255 int/sequence, or a 0-1 float
    sequence."""
    import matplotlib.colors as mcolors

    if isinstance(color, str):
        return mcolors.to_rgb(color)
    if np.isscalar(color):
        v = float(color)
        v = v / 255.0 if v > 1 else v
        return (v, v, v)
    c = np.asarray(color, np.float64)
    if (c > 1).any():
        c = c / 255.0
    return tuple(np.clip(c[:3], 0, 1))


def colors_val(colors):
    """List of color specs -> list of RGB tuples."""
    if isinstance(colors, (list, tuple)) and not np.isscalar(colors[0]) \
            or (isinstance(colors, (list, tuple))
                and isinstance(colors[0], str)):
        return [single_color_val(c) for c in colors]
    return [single_color_val(colors)]


def random_colors(num, cmap=None):
    """``num`` distinct colors, optionally from a named colormap."""
    if cmap is None:
        rng = np.random.RandomState(97)
        return [tuple(rng.rand(3) * 0.8 + 0.1) for _ in range(num)]
    import matplotlib

    m = matplotlib.colormaps[cmap]
    return [tuple(m(i / max(num - 1, 1))[:3]) for i in range(num)]


def plt_init(width, height, dpi=100):
    """Axes covering the full figure at the image's pixel size."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(width / dpi, height / dpi), dpi=dpi)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_xlim(0, width)
    ax.set_ylim(height, 0)
    ax.axis("off")
    return fig, ax


def get_img_from_fig(fig, width, height):
    """Rasterize a figure to an RGB uint8 array."""
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return np.ascontiguousarray(buf)


def _add_text(ax, x, y, text, color, font_size):
    ax.text(x, y, text,
            bbox={"alpha": 0.5, "pad": 0.7, "facecolor": color,
                  "edgecolor": "none"},
            color="white", fontsize=font_size,
            verticalalignment="bottom", horizontalalignment="left")


def draw_hbb(ax, bboxes, texts, color, thickness=1.0, font_size=10):
    """Axis-aligned [N, 4] (xmin, ymin, xmax, ymax) boxes."""
    from matplotlib.collections import PatchCollection
    from matplotlib.patches import Rectangle

    color = single_color_val(color)
    if texts is not None:
        assert len(texts) == len(bboxes)
    patches = []
    for i, (x1, y1, x2, y2) in enumerate(np.asarray(bboxes)):
        if texts is not None:
            _add_text(ax, x1, y1, texts[i], color, font_size)
        patches.append(Rectangle((x1, y1), x2 - x1, y2 - y1))
    if patches:
        ax.add_collection(PatchCollection(
            patches, facecolors="none", edgecolors=[color] * len(patches),
            linewidths=thickness))


def draw_obb(ax, obbs, texts, color, thickness=1.0, font_size=10):
    """Oriented [N, 5] (cx, cy, w, h, theta) boxes rendered as their
    corner polygons."""
    obbs = np.asarray(obbs, np.float64)
    cx, cy, w, h, t = (obbs[:, i] for i in range(5))
    c, s = np.cos(t), np.sin(t)
    dx, dy = w / 2, h / 2
    polys = np.stack([
        c * -dx - s * -dy + cx, s * -dx + c * -dy + cy,
        c * dx - s * -dy + cx, s * dx + c * -dy + cy,
        c * dx - s * dy + cx, s * dx + c * dy + cy,
        c * -dx - s * dy + cx, s * -dx + c * dy + cy,
    ], axis=1)
    draw_poly(ax, polys, texts, color, thickness, font_size)


def draw_poly(ax, polys, texts, color, thickness=1.0, font_size=10):
    """Quadrilateral [N, 8] polygons."""
    from matplotlib.collections import PatchCollection
    from matplotlib.patches import Polygon

    color = single_color_val(color)
    if texts is not None:
        assert len(texts) == len(polys)
    patches = []
    for i, p in enumerate(np.asarray(polys)):
        pts = np.asarray(p, np.float64).reshape(-1, 2)
        if texts is not None:
            _add_text(ax, pts[:, 0].min(), pts[:, 1].min(), texts[i],
                      color, font_size)
        patches.append(Polygon(pts, closed=True))
    if patches:
        ax.add_collection(PatchCollection(
            patches, facecolors="none", edgecolors=[color] * len(patches),
            linewidths=thickness))
