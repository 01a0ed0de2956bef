"""Dataset preparation and the ensemble merge of the port against the JAX
package, on the CPU: ``resize_cubic_rate`` against ``cv2.resize(fx=...)``
and ``resize_cubic`` against the JAX package's;
the whole preprocess tool (FAIR XML -> DOTA -> multi-rate tiles ->
``labels.pkl``) against the JAX tool on the same rendered scenes; the
converters; the devkit calls of both tools for every config under
``configs/preprocess/``; ``merge_results``; and the preprocess tool plus
a scene test task in a process where jax, flax, optax and cv2 cannot be
imported. Scenes are rendered from
seeds by ``chip_smoke.render_fair_split`` (phase 29 renders its own with
it)."""

import glob
import importlib.util
import os
import pickle
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch
from PIL import Image

import cv2
from chip_smoke import render_fair_split
from rs_detection_tpu.config import init_cfg as jinit_cfg
from rs_detection_tpu.data import device_resize as jresize
from rs_detection_tpu.data.devkits import convert_data_to_mmdet as jconvert
from rs_detection_tpu.data.devkits import fair_to_dota as jfair
from rs_detection_tpu.data.devkits import img_split as jsplit
from rs_detection_tpu.data.devkits import ssdd_to_dota as jssdd
from rs_detection_tpu_torch.config import init_cfg
from rs_detection_tpu_torch.data.device_resize import (resize_cubic,
                                                       resize_cubic_rate)
from rs_detection_tpu_torch.data.devkits import convert_data_to_mmdet as convert
from rs_detection_tpu_torch.data.devkits import fair_to_dota as fair
from rs_detection_tpu_torch.data.devkits import img_split
from rs_detection_tpu_torch.data.devkits import ssdd_to_dota as ssdd
from rs_detection_tpu_torch.tools import merge_results, preprocess
from torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREPROCESS_CONFIGS = sorted(
    os.path.basename(p)
    for p in glob.glob(os.path.join(REPO, "configs", "preprocess", "*.py")))


def _jax_tool(name):
    """``tools/<name>.py`` of the JAX package, as its own module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.int16)


def _files(root, sub):
    d = os.path.join(root, sub)
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def assert_tiles_match(got_root, ref_root):
    """Same tile and label names, byte-equal labelTxt files, tile pixels
    equal at rate 1.0 and within 1 LSB elsewhere; returns the share of
    differing pixels of the resized tiles."""
    names = _files(ref_root, "images")
    assert names and _files(got_root, "images") == names
    labels = _files(ref_root, "labelTxt")
    assert _files(got_root, "labelTxt") == labels
    for n in labels:
        with open(os.path.join(got_root, "labelTxt", n), "rb") as a, \
                open(os.path.join(ref_root, "labelTxt", n), "rb") as b:
            assert a.read() == b.read(), n
    differ = total = 0
    for n in names:
        d = np.abs(_png(os.path.join(got_root, "images", n))
                   - _png(os.path.join(ref_root, "images", n)))
        if "__1.0__" in n:
            assert d.max() == 0, n
        else:
            assert d.max() <= 1, n
            differ += int((d > 0).sum())
            total += d.size
    return differ / max(total, 1)


def assert_infos_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if k == "ann":
                assert g[k].keys() == r[k].keys()
                for key in r[k]:
                    np.testing.assert_array_equal(g[k][key], r[k][key])
                    assert g[k][key].dtype == r[k][key].dtype
            else:
                assert g[k] == r[k]


@pytest.mark.parametrize("shape", [(301, 457), (300, 456)])
@pytest.mark.parametrize("rate", [0.5, 0.75, 1.0, 1.5])
def test_resize_cubic_rate_matches_cv2(shape, rate):
    """cv2's ``fx = rate`` resize of a uint8 scene: equal at rate 1.0,
    within 1 LSB on a few pixels in 1e3 elsewhere, odd and even sides."""
    img = np.random.RandomState(0).randint(0, 256, shape + (3,)).astype(
        np.uint8)
    ref = cv2.resize(img, None, fx=rate, fy=rate,
                     interpolation=cv2.INTER_CUBIC)
    got = resize_cubic_rate(torch.from_numpy(img), rate).numpy()
    assert got.shape == ref.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - ref)
    if rate == 1.0:
        assert d.max() == 0
    else:
        assert d.max() <= 1 and (d > 0).mean() < 2e-3


@pytest.mark.parametrize("rate", [0.5, 0.75, 1.5])
@pytest.mark.parametrize("shape", [(97, 113), (96, 112)])
def test_resize_cubic_matches_jax(rate, shape):
    """The ``in / out`` tables of ``SceneDataset(rates=...)``, uint8 in,
    f32 out, at 1e-4."""
    img = np.random.RandomState(1).randint(0, 256, shape + (3,)).astype(
        np.uint8)
    oh, ow = int(round(shape[0] * rate)), int(round(shape[1] * rate))
    ref = np.asarray(jresize.resize_cubic(img, oh, ow))
    got = resize_cubic(torch.from_numpy(img), oh, ow).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


def _write_preprocess_config(path, root, num_process):
    with open(path, "w") as f:
        f.write(f"type = 'FAIR'\nsource_dataset_path = '{root}/src'\n"
                f"target_dataset_path = '{root}/out'\n"
                "convert_type = 'FAIR1M_1_5'\nangle_version = 'le90'\n"
                "fair1m_mapping = True\ntasks = [dict(label='trainval', "
                "config=dict(subsize=128, gap=32, rates=[0.5, 1.0, 1.5], "
                f"num_process={num_process}))]\n")
    return str(path)


def test_preprocess_tool_matches_jax(tmp_path, monkeypatch):
    """FAIR scenes (odd and even sides) through both tools at rates 0.5 /
    1.0 / 1.5 with the FAIR1M mapping: the converted DOTA split, the tile
    names, labelTxt bytes and ``labels.pkl`` equal, tile pixels as
    ``assert_tiles_match`` holds them. The port cuts with 3 threads, the
    JAX tool in one process (no fork of a process running jax)."""
    render_fair_split(str(tmp_path / "src" / "trainval"), ["1", "2"], 461,
                      12, seed=3)
    render_fair_split(str(tmp_path / "src" / "trainval"), ["3"], 300, 12,
                      seed=4)
    monkeypatch.chdir(tmp_path)
    jtool = _jax_tool("preprocess")
    jcfg = jinit_cfg(_write_preprocess_config(
        tmp_path / "jax_cfg.py", tmp_path / "jax", 1))
    jcfg.source_dataset_path = str(tmp_path / "src")
    jtool.run(jcfg)
    outs = preprocess.main([
        "--config-file", _write_preprocess_config(
            tmp_path / "port_cfg.py", tmp_path / "port", 3),
        "--set", f"source_dataset_path={tmp_path / 'src'}", "--cpu"])
    out = str(tmp_path / "port" / "out" / "trainval_128_32_0.5-1.0-1.5")
    ref = str(tmp_path / "jax" / "out" / "trainval_128_32_0.5-1.0-1.5")
    assert outs == [out]
    dota = [str(tmp_path / d / "out" / "trainval_dota")
            for d in ("port", "jax")]
    assert _files(dota[0], "images") == ["P0001.png", "P0002.png",
                                         "P0003.png"]
    for sub in ("images", "labelTxt"):
        assert _files(dota[0], sub) == _files(dota[1], sub)
    for n in _files(dota[0], "images"):
        np.testing.assert_array_equal(
            _png(os.path.join(dota[0], "images", n)),
            _png(os.path.join(dota[1], "images", n)))
    share = assert_tiles_match(out, ref)
    assert share < 2e-3
    with open(os.path.join(out, "labels.pkl"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(ref, "labels.pkl"), "rb") as f:
        want = pickle.load(f)
    assert_infos_equal(got, want)
    assert sum(len(i["ann"]["bboxes"]) for i in got) > 20


def test_fair_to_dota_grey_jpg_and_wide_tiff(tmp_path):
    """8-bit grey TIFF and JPEG sources convert to cv2's pixels (RGB
    PNGs), the select variant takes its list; a 16-bit grey TIFF converts
    to cv2's pixels too, and a 32-bit float TIFF, which the port does not
    read, raises naming the file."""
    src = tmp_path / "src"
    render_fair_split(str(src), ["1"], 120, 3, seed=5)
    rng = np.random.RandomState(6)
    Image.fromarray(rng.randint(0, 256, (90, 70)).astype(np.uint8)).save(
        src / "images" / "2.tif")
    Image.fromarray(rng.randint(0, 256, (64, 80, 3)).astype(np.uint8)).save(
        src / "images" / "3.jpg", quality=90)
    for mod, out in ((fair, "port"), (jfair, "jax")):
        mod.fair_to_dota(str(src), str(tmp_path / out))
    for n in ("P0001.png", "P0002.png", "P0003.png"):
        np.testing.assert_array_equal(
            _png(tmp_path / "port" / "images" / n),
            _png(tmp_path / "jax" / "images" / n))
    assert (tmp_path / "port" / "labelTxt" / "P0001.txt").read_bytes() == \
        (tmp_path / "jax" / "labelTxt" / "P0001.txt").read_bytes()
    (tmp_path / "list.txt").write_text("3\n1\n")
    fair.fair_to_dota_select(str(src), str(tmp_path / "sel"),
                             str(tmp_path / "list.txt"))
    assert _files(tmp_path / "sel", "images") == ["P0001.png", "P0003.png"]
    wide = tmp_path / "wide"
    (wide / "images").mkdir(parents=True)
    Image.fromarray(rng.randint(0, 65535, (16, 16)).astype(np.uint16)).save(
        wide / "images" / "9.tif")
    for mod, out in ((fair, "wide_port"), (jfair, "wide_jax")):
        mod.fair_to_dota(str(wide), str(tmp_path / out))
    np.testing.assert_array_equal(
        _png(tmp_path / "wide_port" / "images" / "P0009.png"),
        _png(tmp_path / "wide_jax" / "images" / "P0009.png"))
    Image.fromarray(rng.rand(16, 16).astype(np.float32)).save(
        wide / "images" / "8.tif")
    with pytest.raises(NotImplementedError, match="8.tif"):
        fair.fair_to_dota(str(wide), str(tmp_path / "wide_out"))


def _voc_xml(path, boxes, plus):
    root = ET.Element("annotation")
    for k, (x0, y0, x1, y1) in enumerate(boxes):
        ob = ET.SubElement(root, "object")
        ET.SubElement(ob, "name").text = "ship"
        ET.SubElement(ob, "difficult").text = str(k % 2)
        bb = ET.SubElement(ob, "bndbox")
        for key, v in zip(("xmin", "ymin", "xmax", "ymax"), (x0, y0, x1, y1)):
            ET.SubElement(bb, key).text = str(v)
        if plus:
            rb = ET.SubElement(ob, "rotated_bndbox")
            for i, v in enumerate((x0, y0, x1, y0 + 2, x1 - 1, y1, x0 + 1,
                                   y1 - 3)):
                ET.SubElement(rb, ("x", "y")[i % 2] + str(i // 2 + 1)).text = \
                    str(v)
    ET.ElementTree(root).write(path)


def test_ssdd_converters_match_jax(tmp_path):
    """Both SSDD converters: the two-argument one of ``fair_to_dota``
    (the preprocess tool's) and ``ssdd_to_dota.ssdd_to_dota`` (plain and
    plus): byte-equal labelTxt files and equal PNG pixels."""
    voc = tmp_path / "voc"
    (voc / "Annotations").mkdir(parents=True)
    (voc / "JPEGImages").mkdir()
    rng = np.random.RandomState(7)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (50 + 7 * i, 60, 3)).astype(
            np.uint8)).save(voc / "JPEGImages" / f"{i:06d}.jpg")
        _voc_xml(voc / "Annotations" / f"{i:06d}.xml",
                 [(3, 4, 20 + i, 30), (10.5, 11, 40, 33.25)], plus=True)
    runs = [((fair.ssdd_to_dota, jfair.ssdd_to_dota), (str(voc),), {})]
    for plus in (False, True):
        runs.append(((ssdd.ssdd_to_dota, jssdd.ssdd_to_dota),
                     (str(voc / "JPEGImages"), str(voc / "Annotations")),
                     dict(resize=48, plus=plus)))
    for k, ((port_fn, jax_fn), args, kw) in enumerate(runs):
        got, ref = tmp_path / f"port{k}", tmp_path / f"jax{k}"
        port_fn(*args, str(got), **kw)
        jax_fn(*args, str(ref), **kw)
        labels = _files(ref, "labelTxt")
        assert labels and _files(got, "labelTxt") == labels
        for n in labels:
            assert (got / "labelTxt" / n).read_bytes() == \
                (ref / "labelTxt" / n).read_bytes()
        for n in _files(ref, "images"):
            np.testing.assert_array_equal(_png(got / "images" / n),
                                          _png(ref / "images" / n))


def test_convert_data_to_mmdet_matches_jax(tmp_path):
    """``labels.pkl`` of both converters on a DOTA split with difficult
    0 / 1 / 2 and an empty label file, with and without the FAIR1M
    mapping, le90 and le135."""
    rng = np.random.RandomState(8)
    split = tmp_path / "split"
    (split / "images").mkdir(parents=True)
    (split / "labelTxt").mkdir()
    classes = ["Boeing737", "Small_Car", "Bridge", "Tugboat"]
    for i in range(3):
        Image.fromarray(np.zeros((20 + i, 30, 3), np.uint8)).save(
            split / "images" / f"t{i}.png")
        lines = []
        for j in range(4 * i):
            cx, cy, w, h, th = *rng.uniform(5, 25, 2), *rng.uniform(2, 9, 2), \
                rng.uniform(-1.5, 1.5)
            c, s = np.cos(th), np.sin(th)
            pts = [(cx + a * c - b * s, cy + a * s + b * c) for a, b in
                   ((-w, -h), (w, -h), (w, h), (-w, h))]
            lines.append(" ".join(f"{v:.1f}" for p in pts for v in p)
                         + f" {classes[j % 4]} {j % 3}\n")
        (split / "labelTxt" / f"t{i}.txt").write_text("".join(lines))
    for kw in (dict(type="FAIR1M_1_5", angle_version="le90",
                    mapping="fair"),
               dict(type="FAIR", angle_version="le135"),
               dict(type="FAIR", angle_version="le90",
                    filter_empty_gt=False)):
        out = {}
        for name, mod in (("port", convert), ("jax", jconvert)):
            path = str(tmp_path / f"{name}.pkl")
            if kw.get("mapping"):
                mod.convert_data_to_mmdet_mapping(
                    str(split), path, **{k: v for k, v in kw.items()
                                         if k != "mapping"})
            else:
                mod.convert_data_to_mmdet(str(split), path, **kw)
            with open(path, "rb") as f:
                out[name] = pickle.load(f)
        assert_infos_equal(out["port"], out["jax"])


@pytest.mark.parametrize("config", PREPROCESS_CONFIGS)
def test_preprocess_makes_the_jax_tools_devkit_calls(config, tmp_path,
                                                     monkeypatch):
    """For every preprocess config of the zoo, the port's ``run`` and the
    JAX tool's make the same devkit calls with the same arguments (both
    read the config's keys the same way, the JDet keys of most configs
    not at all); the port also names the resize's device."""
    jtool = _jax_tool("preprocess")
    calls = {"port": [], "jax": []}

    def recorder(side, name):
        def fn(*args, **kw):
            calls[side].append((name, args, kw))
            if name == "process":
                return args[1] + "_tiles"
        return fn

    devkits = {
        "port": [(fair, "fair_to_dota"), (fair, "ssdd_to_dota"),
                 (img_split, "process"), (convert, "convert_data_to_mmdet"),
                 (convert, "convert_data_to_mmdet_mapping")],
        "jax": [(jfair, "fair_to_dota"), (jfair, "ssdd_to_dota"),
                (jsplit, "process"), (jconvert, "convert_data_to_mmdet"),
                (jconvert, "convert_data_to_mmdet_mapping")]}
    for side, entries in devkits.items():
        for mod, name in entries:
            monkeypatch.setattr(mod, name, recorder(side, name))
    path = os.path.join(REPO, "configs", "preprocess", config)
    overrides = dict(source_dataset_path=str(tmp_path / "src"),
                     target_dataset_path=str(tmp_path / "tgt"))
    jcfg = jinit_cfg(path)
    jcfg.update(overrides)
    jtool.run(jcfg)
    cfg = init_cfg(path)
    cfg.update(overrides)
    assert preprocess.run(cfg, device="cpu") == [
        args[1] + "_tiles" for name, args, _ in calls["port"]
        if name == "process"]
    for name, _, kw in calls["port"]:
        if name == "process":
            assert kw.pop("device") == "cpu"
    assert calls["port"] == calls["jax"]


def _write_csv(path, rng, n, classes):
    with open(path, "w") as f:
        for _ in range(n):
            img = rng.randint(1, 4)
            x, y = rng.uniform(0, 200, 2)
            w, h, th = rng.uniform(5, 40), rng.uniform(5, 20), \
                rng.uniform(-1.5, 1.5)
            c, s = np.cos(th), np.sin(th)
            pts = [(x + a * c - b * s, y + a * s + b * c) for a, b in
                   ((-w, -h), (w, -h), (w, h), (-w, h))]
            f.write(f"{img}.tif,{classes[rng.randint(len(classes))]},"
                    f"{rng.uniform(0.05, 1):.4f},"
                    + ",".join(f"{v:.4f}" for p in pts for v in p) + "\n")


def test_merge_results_matches_jax(tmp_path, monkeypatch):
    """The CSV ensemble (hbb NMS, a per-class threshold dict, soft-NMS,
    the command line) and the det-txt merge write byte-equal files."""
    jtool = _jax_tool("merge_results")
    rng = np.random.RandomState(9)
    classes = merge_results.FAIR1M_1_5_CLASSES[:4]
    csvs = [str(tmp_path / f"m{k}.csv") for k in range(3)]
    for p in csvs:
        _write_csv(p, rng, 60, classes)
    data = [merge_results.read_csv_to_numpy(p) for p in csvs]
    for p, d in zip(csvs, data):
        np.testing.assert_array_equal(d, jtool.read_csv_to_numpy(p))
    per_class = {c: 0.3 + 0.1 * k
                 for k, c in enumerate(merge_results.FAIR1M_1_5_CLASSES)}
    for kw in (dict(thresh=0.625), dict(thresh=per_class),
               dict(use_soft=True)):
        got = merge_results.merge_csv_with_class(data, **kw)
        ref = jtool.merge_csv_with_class(data, **kw)
        assert 0 < len(got) < 180
        np.testing.assert_array_equal(got, ref)
        merge_results.save_to_csv(got, str(tmp_path / "a" / "m.csv"))
        jtool.save_to_csv(ref, str(tmp_path / "b" / "m.csv"))
        assert (tmp_path / "a" / "m.csv").read_bytes() == \
            (tmp_path / "b" / "m.csv").read_bytes()
    merge_results.main(["--csvs", *csvs, "--out", str(tmp_path / "cli.csv")])
    monkeypatch.setattr("sys.argv", ["merge_results", "--csvs", *csvs,
                                     "--out", str(tmp_path / "jcli.csv")])
    jtool.main()
    assert (tmp_path / "cli.csv").read_bytes() == \
        (tmp_path / "jcli.csv").read_bytes()

    dirs = []
    for k in range(2):
        d = tmp_path / f"dets{k}"
        d.mkdir()
        dirs.append(str(d))
        for cls in classes[:3]:
            with open(d / f"{cls}.txt", "w") as f:
                for _ in range(25):
                    img = f"P{rng.randint(1, 3):04d}"
                    x, y = rng.uniform(0, 100, 2)
                    w, h = rng.uniform(5, 30, 2)
                    f.write(f"{img} {rng.uniform(0.05, 1):.4f} {x} {y} "
                            f"{x + w} {y} {x + w} {y + h} {x} {y + h}\n")
    merge_results.merge_det_txt_dirs(dirs, str(tmp_path / "dg"), 0.1)
    jtool.merge_det_txt_dirs(dirs, str(tmp_path / "dj"), 0.1)
    names = _files(tmp_path, "dj")
    assert len(names) == 3 and _files(tmp_path, "dg") == names
    for n in names:
        assert (tmp_path / "dg" / n).read_bytes() == \
            (tmp_path / "dj" / n).read_bytes()


def _repr_config(cfg):
    return "".join(f"{k} = {v!r}\n" for k, v in cfg.items())


def test_preprocess_and_scene_task_import_no_jax_or_cv2(tmp_path):
    """In a process where ``import jax``, ``flax``, ``optax`` and ``cv2``
    fail, the port's preprocess tool (FAIR scenes -> tiles ->
    ``labels.pkl``, on the CPU) and a ``run_net --task test`` over a
    ``SceneDataset`` with a random-init screen run to the end, and no
    module of the JAX package is loaded."""
    from rs_detection_tpu_torch.flagship import flagship_cfg

    render_fair_split(str(tmp_path / "src" / "trainval"), ["1"], 200, 6,
                      seed=10)
    pre = tmp_path / "pre.py"
    pre.write_text(_repr_config(dict(
        type="FAIR", source_dataset_path=str(tmp_path / "src"),
        target_dataset_path=str(tmp_path / "out"),
        convert_type="FAIR1M_1_5", angle_version="le90", fair1m_mapping=True,
        tasks=[dict(label="trainval", config=dict(
            subsize=128, gap=32, rates=[0.5, 1.0], num_process=2))])))
    test = tmp_path / "test.py"
    test.write_text(_repr_config(dict(
        name="scene_task", work_dir=str(tmp_path / "work"), seed=1,
        model=flagship_cfg(tiny=True),
        dataset=dict(test=dict(
            type="SceneDataset", images_dir=str(tmp_path / "src"
                                                / "trainval" / "images"),
            subsize=128, gap=32, rates=[0.5, 1.0], batch_size=2,
            screen=dict(budget=2, allow_random_init=True))),
        merge_cfg=dict(dataset_type="FAIR1M_1_5"))))
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "from rs_detection_tpu_torch.tools import preprocess, run_net\n"
        f"out = preprocess.main(['--config-file', {str(pre)!r}, '--cpu'])\n"
        "import pickle, os\n"
        "infos = pickle.load(open(os.path.join(out[0], 'labels.pkl'), 'rb'))\n"
        "assert infos and all('ann' in i for i in infos), infos\n"
        f"r = run_net.main(['--config-file', {str(test)!r}, '--task', "
        "'test', '--cpu'])\n"
        "assert r.test_stats['tiles'] == 3, r.test_stats\n"
        "assert r.test_dataset.screen_stats == dict(total=5, kept=3)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] == "
        "'rs_detection_tpu']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert (tmp_path / "submit_zips" / "scene_task.csv").exists()
