"""FAIR XML annotations -> DOTA labelTxt + renamed PNGs (counterpart of
``rs_detection_tpu/data/devkits/fair_to_dota.py``): image renaming
``<n>.tif -> P<n:04>.png``, XML points into 8-coordinate polygons with
class names underscored, the split-list variant
(``fair_to_dota_select``), and the SSDD VOC-XML variant the preprocess
tool calls (``ssdd_to_dota(in, out)``).

Pillow decodes and encodes in place of cv2's ``imread(path, 1)`` /
``imwrite``, on 8 threads: ``convert("RGB")`` gives cv2's pixels for
8-bit RGB and grey sources. A source of 16 bits a sample is read at full
depth and brought to 8 bits as cv2 brings it: a grey one by its high
byte (``v >> 8``), repeated in three channels; an RGB(A) one, which
Pillow itself cuts to its high bytes, by ``round(v / 257)`` a channel,
alpha dropped (``read_samples16``). Any other mode of more than 8 bits a
sample (32-bit integer or float) raises ``NotImplementedError`` naming
the file.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
import re
import sys
from typing import List, Optional

import numpy as np
from PIL import Image

# Pillow modes of more than 8 bits a sample
_WIDE_MODES = ("I", "F", "I;16", "I;16B", "I;16L", "I;16N")
_GREY16 = ("I;16", "I;16B", "I;16L", "I;16N")
# the raw modes of 16-bit colour, which Pillow unpacks to their high bytes
_COLOR16 = re.compile(r"^(RGBA?);16([NBL])$")


def _byte_plane(src: str, rawmode: str) -> np.ndarray:
    """The image at ``src`` decoded with its tiles' raw mode replaced by
    ``rawmode`` (a 16-bit unpacker keeps one byte of each sample)."""
    with Image.open(src) as img:
        img.tile = [t._replace(args=(rawmode,) + tuple(t.args[1:]))
                    for t in img.tile]
        img.load()
        return np.asarray(img)


def read_samples16(src: str) -> Optional[np.ndarray]:
    """The samples of a 16-bit grey ([H, W]) or RGB(A) ([H, W, 3 | 4])
    image at full depth as uint16, or None for any other image. Pillow
    opens 16-bit colour as 8-bit RGB(A); its unpacker of the samples'
    byte order keeps their high bytes, that of the other order their low
    bytes, so the image is decoded once with each."""
    with Image.open(src) as img:
        if img.mode in _GREY16:
            return np.asarray(img).astype(np.uint16)
        raw = img.tile[0].args[0] if img.tile else ""
    m = _COLOR16.match(raw)
    if m is None:
        return None
    order = m.group(2)
    if order == "N":
        order = "L" if sys.byteorder == "little" else "B"
    other = "B" if order == "L" else "L"
    hi = _byte_plane(src, f"{m.group(1)};16{order}").astype(np.uint16)
    lo = _byte_plane(src, f"{m.group(1)};16{other}").astype(np.uint16)
    return (hi << 8) | lo


def to_8bit_rgb(samples: np.ndarray) -> np.ndarray:
    """16-bit samples -> uint8 RGB [H, W, 3], as ``cv2.imread(path, 1)``
    reads them: grey by the high byte into three channels, colour by
    ``round(v / 257)`` (never a tie: 2 v + 257 is odd) without alpha."""
    if samples.ndim == 2:
        return np.repeat((samples >> 8).astype(np.uint8)[..., None], 3, -1)
    v = samples[..., :3].astype(np.uint32)
    return ((2 * v + 257) // 514).astype(np.uint8)


def convert_image(src: str, tar: str):
    """Rewrite one image as an 8-bit RGB PNG (cv2's default speed,
    ``compress_level=1``)."""
    samples = read_samples16(src)
    if samples is not None:
        Image.fromarray(to_8bit_rgb(samples)).save(tar, compress_level=1)
        return
    with Image.open(src) as img:
        if img.mode in _WIDE_MODES:
            raise NotImplementedError(
                f"{src}: a {img.mode} image has more than 8 bits a sample "
                f"and not 16; cv2's reading of it is not ported")
        img.convert("RGB").save(tar, compress_level=1)


def solve_xml(src: str, tar: str):
    """Parse one FAIR labelXml into DOTA txt lines."""
    tree = ET.parse(src)
    root = tree.getroot()
    lines = []
    for obj in root.iter("object"):
        name_el = obj.find("possibleresult/name")
        if name_el is None:
            continue
        name = (name_el.text or "").strip().replace(" ", "_")
        pts: List[float] = []
        for pt in obj.iter("point"):
            x, y = (pt.text or "0,0").split(",")
            pts += [float(x), float(y)]
        # points are closed (first repeated last) — keep the first 4
        if len(pts) >= 8:
            coords = pts[:8]
            lines.append(" ".join(str(c) for c in coords)
                         + f" {name} 0\n")
    with open(tar, "w") as f:
        f.writelines(lines)


def fair_to_dota(in_path: str, out_path: str,
                 file_names: Optional[List[str]] = None):
    os.makedirs(os.path.join(out_path, "images"), exist_ok=True)
    img_dir = os.path.join(in_path, "images")
    names = file_names if file_names is not None else sorted(
        os.path.splitext(f)[0] for f in os.listdir(img_dir))
    jobs = []
    for n in names:
        for ext in (".tif", ".png", ".jpg"):
            src = os.path.join(img_dir, n + ext)
            if os.path.exists(src):
                break
        else:
            continue
        jobs.append((src, os.path.join(out_path, "images",
                                       "P" + n.zfill(4) + ".png")))
    # Pillow decodes and encodes off the interpreter lock; list() reads
    # every result, so a failed conversion raises here
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: convert_image(*job), jobs))
    xml_dir = os.path.join(in_path, "labelXml")
    if os.path.isdir(xml_dir):
        os.makedirs(os.path.join(out_path, "labelTxt"), exist_ok=True)
        for n in names:
            src = os.path.join(xml_dir, n + ".xml")
            if not os.path.exists(src):
                continue
            tar = os.path.join(out_path, "labelTxt",
                               "P" + n.zfill(4) + ".txt")
            solve_xml(src, tar)
    return out_path


def fair_to_dota_select(in_path: str, out_path: str, split_path: str):
    with open(split_path) as f:
        names = [n for n in f.read().split("\n") if n]
    return fair_to_dota(in_path, out_path, file_names=names)


def ssdd_to_dota(in_path: str, out_path: str):
    """SSDD VOC-XML -> DOTA txt: horizontal xmin/ymin/xmax/ymax boxes
    become 4-corner polygons of class ``ship``."""
    os.makedirs(os.path.join(out_path, "labelTxt"), exist_ok=True)
    os.makedirs(os.path.join(out_path, "images"), exist_ok=True)
    xml_dir = os.path.join(in_path, "Annotations")
    img_dir = os.path.join(in_path, "JPEGImages")
    for f in sorted(os.listdir(xml_dir)):
        if not f.endswith(".xml"):
            continue
        tree = ET.parse(os.path.join(xml_dir, f))
        lines = []
        for obj in tree.getroot().iter("object"):
            bb = obj.find("bndbox")
            if bb is None:
                continue
            x1 = float(bb.findtext("xmin", "0"))
            y1 = float(bb.findtext("ymin", "0"))
            x2 = float(bb.findtext("xmax", "0"))
            y2 = float(bb.findtext("ymax", "0"))
            lines.append(f"{x1} {y1} {x2} {y1} {x2} {y2} {x1} {y2} "
                         "ship 0\n")
        name = os.path.splitext(f)[0]
        with open(os.path.join(out_path, "labelTxt", name + ".txt"),
                  "w") as out:
            out.writelines(lines)
        src_img = os.path.join(img_dir, name + ".jpg")
        if os.path.exists(src_img):
            convert_image(src_img,
                          os.path.join(out_path, "images", name + ".png"))
    return out_path
