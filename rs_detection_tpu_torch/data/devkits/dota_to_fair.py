"""DOTA-format detections -> FAIR submission formats (counterpart of
``rs_detection_tpu/data/devkits/dota_to_fair.py``): ``dota_to_fair``
(one XML per image in the FAIR GF2/GF3 annotation schema) and
``dota_to_fair1m_1_5`` (one CSV)."""

from __future__ import annotations

import os
from typing import Dict, List

_XML_HEAD = """<?xml version="1.0" encoding="utf-8"?>
<annotation>
    <source>
    <filename>{filename}</filename>
    <origin>GF2/GF3</origin>
    </source>
    <research>
        <version>4.0</version>
        <provider>placeholder_affiliation</provider>
        <author>placeholder_authorname</author>
        <pluginname>placeholder_direction</pluginname>
        <pluginclass>placeholder_suject</pluginclass>
        <time>2020-07-2020-11</time>
    </research>
    <size>
        <width>{width}</width>
        <height>{height}</height>
        <depth>3</depth>
    </size>
    <objects>
"""

_XML_OBJ = """        <object>
            <coordinate>pixel</coordinate>
            <type>rectangle</type>
            <description>None</description>
            <possibleresult>
                <name>{cls}</name>
                <probability>{prob}</probability>
            </possibleresult>
            <points>
                <point>{p0}</point>
                <point>{p1}</point>
                <point>{p2}</point>
                <point>{p3}</point>
                <point>{p0}</point>
            </points>
        </object>
"""

_XML_TAIL = """    </objects>
</annotation>
"""


def pick_res(path: str, images_dir: str,
             keep_underline: bool = False) -> Dict[str, List]:
    """Group the merged per-class detection txt files by original
    image."""
    res: Dict[str, List] = {}
    if images_dir and os.path.isdir(images_dir):
        for root, _, files in os.walk(images_dir):
            for f in files:
                if f.endswith(".png"):
                    res[f.split("__")[0]] = []
    for root, _, files in os.walk(path):
        for f in files:
            if not f.endswith(".txt"):
                continue
            cls = f[:-4] if keep_underline else f[:-4].replace("_", " ")
            with open(os.path.join(root, f)) as fh:
                for line in fh:
                    parts = line.strip().split(" ")
                    if len(parts) < 10:
                        continue
                    box = [float(v) for v in parts[2:10]]
                    res.setdefault(parts[0], []).append(
                        dict(cls=cls, p=float(parts[1]), box=box))
    return res


def dota_to_fair(src_path: str, tar_path: str, images_dir: str = ""):
    data = pick_res(src_path, images_dir)
    os.makedirs(tar_path, exist_ok=True)
    for img, objs in data.items():
        num = str(int(img[1:])) if img[1:].isdigit() else img
        xml = _XML_HEAD.format(filename=num + ".tif", width=1000,
                               height=1000)
        for o in objs:
            b = o["box"]
            xml += _XML_OBJ.format(
                cls=o["cls"], prob=o["p"],
                p0=f"{b[0]}, {b[1]}", p1=f"{b[2]}, {b[3]}",
                p2=f"{b[4]}, {b[5]}", p3=f"{b[6]}, {b[7]}")
        xml += _XML_TAIL
        with open(os.path.join(tar_path, num + ".xml"), "w") as f:
            f.write(xml)
    return tar_path


def dota_to_fair1m_1_5(src_path: str, tar_path: str,
                       images_dir: str = "", name: str = "submission"):
    data = pick_res(src_path, images_dir, keep_underline=True)
    os.makedirs(tar_path, exist_ok=True)
    lines = []
    for img, objs in data.items():
        num = str(int(img[1:])) if img[1:].isdigit() else img
        for o in objs:
            b = o["box"]
            lines.append(
                "{},{},{:.4f},".format(num + ".tif", o["cls"], o["p"])
                + ",".join(f"{v:.4f}" for v in b) + "\n")
    csv_path = os.path.join(tar_path, name + ".csv")
    with open(csv_path, "w") as f:
        f.writelines(lines)
    return csv_path
