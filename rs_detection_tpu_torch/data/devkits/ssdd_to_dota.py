"""SSDD / SSDD+ VOC-XML -> DOTA labelTxt converter (counterpart of
``rs_detection_tpu/data/devkits/ssdd_to_dota.py``): each VOC XML becomes
a DOTA polygon line per object. SSDD+ ("plus") XMLs carry a
``rotated_bndbox`` with four explicit corners; plain SSDD's axis-aligned
``bndbox`` becomes four corners. Images are resized to ``resize`` x
``resize`` PNGs (Pillow bilinear) and the coordinates rescaled to match.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from PIL import Image


def xml_to_dota_lines(xml_path: str, rescale, plus: bool):
    root = ET.parse(xml_path).getroot()
    rx, ry = rescale
    lines = []
    for ob in root.findall("object"):
        if plus:
            box = ob.find("rotated_bndbox")
            pts = [float(box.find(k).text) for k in
                   ("x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4")]
        else:
            box = ob.find("bndbox")
            x0, y0, x1, y1 = [float(box.find(k).text) for k in
                              ("xmin", "ymin", "xmax", "ymax")]
            pts = [x0, y0, x0, y1, x1, y1, x1, y0]
        pts = [v * (rx if i % 2 == 0 else ry)
               for i, v in enumerate(pts)]
        name = ob.find("name").text
        diff = ob.find("difficult").text if ob.find(
            "difficult") is not None else "0"
        lines.append(" ".join(f"{v:.1f}" for v in pts)
                     + f" {name} {diff}\n")
    return lines


def ssdd_to_dota(img_path: str, anno_path: str, target_path: str,
                 resize: int = 640, plus: bool = True):
    """Convert an SSDD(+) split to DOTA layout at ``target_path``."""
    out_img = os.path.join(target_path, "images")
    out_txt = os.path.join(target_path, "labelTxt")
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_txt, exist_ok=True)
    for fname in sorted(os.listdir(img_path)):
        stem, ext = os.path.splitext(fname)
        if ext.lower() not in (".jpg", ".jpeg", ".png"):
            continue
        with Image.open(os.path.join(img_path, fname)) as im:
            img = im.convert("RGB")
        w, h = img.size
        img.resize((resize, resize), Image.BILINEAR).save(
            os.path.join(out_img, stem + ".png"))
        xml = os.path.join(anno_path, stem + ".xml")
        if not os.path.exists(xml):
            continue
        lines = xml_to_dota_lines(
            xml, (resize / w, resize / h), plus)
        with open(os.path.join(out_txt, stem + ".txt"), "w") as f:
            f.writelines(lines)
