"""FAIR XML annotations -> DOTA labelTxt + renamed PNGs (counterpart of
``rs_detection_tpu/data/devkits/fair_to_dota.py``): image renaming
``<n>.tif -> P<n:04>.png``, XML points into 8-coordinate polygons with
class names underscored, the split-list variant
(``fair_to_dota_select``), and the SSDD VOC-XML variant the preprocess
tool calls (``ssdd_to_dota(in, out)``).

Pillow decodes and encodes in place of cv2's ``imread(path, 1)`` /
``imwrite``, on 8 threads: ``convert("RGB")`` gives cv2's pixels for
8-bit RGB and grey sources. cv2 rescales a 16-bit image to 8 bits;
nothing here does, and such a file raises ``NotImplementedError`` naming
it.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from PIL import Image

# Pillow modes of more than 8 bits a sample
_WIDE_MODES = ("I", "F", "I;16", "I;16B", "I;16L", "I;16N")


def convert_image(src: str, tar: str):
    """Rewrite one 8-bit image as an RGB PNG (cv2's default speed,
    ``compress_level=1``)."""
    with Image.open(src) as img:
        if img.mode in _WIDE_MODES:
            raise NotImplementedError(
                f"{src}: a {img.mode} image has more than 8 bits a sample; "
                f"cv2 rescales it to 8 bits, the port does not convert it")
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
