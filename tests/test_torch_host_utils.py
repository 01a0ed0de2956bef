"""The port's host utilities and tools against their JAX twins on the
CPU, on the same seeded inputs: ``utils/general.py`` (``multi_apply``,
``parse_losses``, ``set_random_seed``, ``sync``, ``to_np``, ``unmap``),
``utils/check_diff.py``, ``utils/draw.py`` (the rendered arrays equal),
``utils/visualization.py:visualize_dota`` (the drawn PNGs equal),
``tools/detection_cam.py`` (the CAM of the tiny flagship to 1e-4 of the
JAX tool's, f32 features; its heat map OpenCV's pixels), the three host
tools (``get_map_str``, ``longtail_stats``, ``md5``: each runs without
jax and prints the JAX tool's output), and ``fair_to_dota`` on 16-bit
TIFFs written by OpenCV (the PNGs' pixels bit for bit)."""

import os
import pickle
import random
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from rs_detection_tpu.data.devkits import fair_to_dota as jfair
from rs_detection_tpu.utils import check_diff as jcd
from rs_detection_tpu.utils import draw as jdraw
from rs_detection_tpu.utils import general as jgen
from rs_detection_tpu.utils import visualization as jvis
from rs_detection_tpu_torch.data.devkits import fair_to_dota as tfair
from rs_detection_tpu_torch.tools import detection_cam as tcam
from rs_detection_tpu_torch.utils import check_diff as tcd
from rs_detection_tpu_torch.utils import draw as tdraw
from rs_detection_tpu_torch.utils import general as tgen
from rs_detection_tpu_torch.utils import visualization as tvis
from torch_one_thread import _one_thread  # noqa: F401

matplotlib.use("Agg")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools", "analysis_tools"))
import detection_cam as jcam  # noqa: E402


# ----------------------------------------------------------- general.py

def test_general_helpers_match_jax():
    """Each helper gives the JAX one's value; ``unmap`` keeps a tensor
    on its device and dtype, ``set_random_seed`` also seeds torch."""
    def f(a, b, k=0):
        return a + b + k, a * b

    assert tgen.multi_apply(f, [1, 2], [3, 4], k=1) == \
        jgen.multi_apply(f, [1, 2], [3, 4], k=1)
    rng = np.random.RandomState(0)
    arrays = {"loss_a": rng.rand(3).astype(np.float32),
              "b_loss": rng.rand(2, 2).astype(np.float32),
              "acc": np.float32(5.0)}
    assert tgen.parse_losses({k: torch.from_numpy(np.atleast_1d(v))
                              for k, v in arrays.items()}) == \
        jgen.parse_losses({k: jnp.asarray(v) for k, v in arrays.items()})
    tgen.set_random_seed(7)
    got = (random.random(), np.random.rand(), torch.rand(2))
    jgen.set_random_seed(7)
    assert (random.random(), np.random.rand()) == got[:2]
    torch.manual_seed(7)
    assert torch.equal(torch.rand(2), got[2])
    data = {"a": torch.tensor(2.5), "b": [torch.arange(3), (np.ones(2),)],
            "c": "text"}
    want = jgen.sync({"a": jnp.asarray(2.5), "b": [jnp.arange(3),
                                                   (np.ones(2),)],
                      "c": "text"})
    got = tgen.sync(data)
    assert got["a"] == want["a"] and isinstance(got["a"], float)
    np.testing.assert_array_equal(got["b"][0], want["b"][0])
    assert isinstance(got["b"][1], tuple) and got["c"] == "text"
    x = torch.randn(3, requires_grad=True)
    np.testing.assert_array_equal(tgen.to_np(x * 2),
                                  jgen.to_np(x.detach().numpy() * 2))
    rows = rng.rand(3, 2).astype(np.float32)
    inds = np.array([4, 0, 2])
    want = np.asarray(jgen.unmap(jnp.asarray(rows), 6, jnp.asarray(inds),
                                 fill=-1))
    np.testing.assert_array_equal(tgen.unmap(rows, 6, inds, fill=-1), want)
    np.testing.assert_array_equal(jgen.unmap(rows, 6, inds, fill=-1), want)
    t = tgen.unmap(torch.from_numpy(rows).double(), 6, torch.from_numpy(inds),
                   fill=-1)
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), want)


# --------------------------------------------------------- check_diff.py

def test_check_diff_matches_jax(tmp_path, capsys):
    """The recorders hook the same torch module and record the same tree
    alike; the reports (with the NCHW <-> NHWC alignment), their text
    and ``check_diff``'s verdict and printout equal the JAX module's."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(),
                              torch.nn.Conv2d(4, 2, 1))
    x = torch.randn(1, 3, 8, 8)
    recs = []
    for mod in (tcd, jcd):
        rec = mod.ActivationRecorder()
        rec.hook_torch(net, prefix="net")
        net(x)
        rec.unhook()
        net(x)
        rec.record_tree("tree", {"a": [np.ones(2), None],
                                 "b": {"c": torch.full((2,), 3.0)}})
        recs.append(rec.data)
    assert recs[0].keys() == recs[1].keys()
    assert set(recs[0]) >= {"net.0", "net.1", "net.2", "tree.a.0",
                            "tree.b.c"}
    for k in recs[0]:
        np.testing.assert_array_equal(recs[0][k], recs[1][k])
    a = dict(recs[0])
    b = {k: v.transpose(0, 2, 3, 1) if v.ndim == 4 else v
         for k, v in a.items()}
    b["net.2"] = b["net.2"] + 1e-3
    b.pop("tree.a.0")
    b["only_b"] = np.zeros(1)
    for auto in (True, False):
        got = tcd.compare_recordings(a, b, auto_layout=auto)
        assert got == jcd.compare_recordings(a, b, auto_layout=auto)
    got = tcd.compare_recordings(a, b)
    assert got["net.0"]["ok"] and not got["net.2"]["ok"]
    assert got["tree.a.0"]["error"] == "missing in B"
    for only in (True, False):
        assert tcd.format_report(got, only) == jcd.format_report(got, only)
    pa, pb = str(tmp_path / "a.pkl"), str(tmp_path / "b.pkl")
    for path, data in ((pa, a), (pb, b)):
        rec = tcd.ActivationRecorder()
        rec.data = data
        rec.save(path)
        assert tcd.ActivationRecorder.load(path).keys() == data.keys()
    assert tcd.compare_data(pa, pb) == jcd.compare_data(pa, pb)
    capsys.readouterr()
    verdict = tcd.check_diff(pa, pb)
    printed = capsys.readouterr().out
    assert verdict == jcd.check_diff(pa, pb) is False
    assert printed == capsys.readouterr().out
    assert tcd.check_diff(pa, pa) is True


# --------------------------------------------------------------- draw.py

def _render(mod):
    fig, ax = mod.plt_init(96, 64)
    mod.draw_hbb(ax, np.array([[5, 5, 40, 30]]), ["car 0.9"], "red")
    mod.draw_obb(ax, np.array([[60, 30, 30, 12, 0.5]]), ["ship"],
                 (0, 255, 0))
    mod.draw_poly(ax, np.array([[10, 40, 40, 40, 40, 60, 10, 60]]), None,
                  "#0000ff", thickness=2.0)
    return mod.get_img_from_fig(fig, 96, 64)


def test_draw_matches_jax():
    """The same figure drawn by either module rasterizes to the same
    array; the colour helpers agree."""
    got, want = _render(tdraw), _render(jdraw)
    assert got.shape == (64, 96, 3) and got.dtype == np.uint8
    assert (got < 250).any()
    np.testing.assert_array_equal(got, want)
    for c in ("red", "#00ff00", 128, 0.5, (255, 0, 0), (0.1, 0.2, 0.3)):
        assert tdraw.single_color_val(c) == jdraw.single_color_val(c)
    for cs in (["red", "#00ff00"], [(255, 0, 0), (0, 1, 0)], "blue"):
        assert tdraw.colors_val(cs) == jdraw.colors_val(cs)
    assert tdraw.random_colors(5) == jdraw.random_colors(5)
    np.testing.assert_array_equal(tdraw.random_colors(4, "viridis"),
                                  jdraw.random_colors(4, "viridis"))


def test_visualize_dota_matches_jax(tmp_path):
    """Per-class DOTA detection files drawn on their images: the PNGs
    equal the JAX function's; an image without a file is skipped."""
    det = tmp_path / "det"
    imgs = tmp_path / "imgs"
    det.mkdir()
    imgs.mkdir()
    rng = np.random.RandomState(1)
    for name in ("P0001", "P0002"):
        Image.fromarray(rng.randint(0, 256, (80, 90, 3)).astype(
            np.uint8)).save(imgs / f"{name}.png")
    lines = {"plane": ["P0001 0.9 10 10 40 12 38 30 8 28",
                       "P0002 0.2 5 5 20 5 20 20 5 20",
                       "P0003 0.8 1 1 2 1 2 2 1 2"],
             "ship": ["P0001 0.5 50 50 70 52 68 70 48 68", "bad line"]}
    for cls, ls in lines.items():
        (det / f"{cls}.txt").write_text("\n".join(ls) + "\n")
    tvis.visualize_dota(str(det), str(imgs), str(tmp_path / "port"))
    jvis.visualize_dota(str(det), str(imgs), str(tmp_path / "jax"))
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == [
        "P0001.png", "P0002.png"]
    for f in files:
        got = np.asarray(Image.open(tmp_path / "port" / f))
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(tmp_path / "jax" / f)))
    assert (got != np.asarray(Image.open(imgs / "P0002.png"))).sum() == 0


# ------------------------------------------------------- detection_cam.py

def test_detection_cam_matches_jax(tmp_path):
    """``eigen_cam`` equals the JAX tool's; the heat map is OpenCV's
    (``overlay`` bit for bit with the JAX tool's cv2 one); the tool's
    ``main`` on the tiny flagship with a JAX variables pickle gives the
    CAM of the JAX model's features to 1e-4."""
    import __graft_entry__ as ge
    import rs_detection_tpu.models  # noqa: F401  (fills the registries)
    from rs_detection_tpu.utils import registry as jreg
    from rs_detection_tpu_torch.flagship import flagship_cfg

    rng = np.random.RandomState(3)
    feat = rng.randn(9, 11, 16).astype(np.float32)
    np.testing.assert_array_equal(tcam.eigen_cam(feat), jcam.eigen_cam(feat))
    img = rng.randint(0, 256, (64, 80, 3)).astype(np.uint8)
    cam = tcam.eigen_cam(feat)
    np.testing.assert_array_equal(tcam.overlay(img, cam),
                                  jcam.overlay(img, cam))
    np.testing.assert_array_equal(
        tcam.jet_lut(), cv2.applyColorMap(np.arange(256, dtype=np.uint8)[
            :, None], cv2.COLORMAP_JET)[:, 0, ::-1])

    model = jreg.build_from_cfg(flagship_cfg(tiny=True), jreg.MODELS)
    x = jnp.asarray(img[None, :64, :64].astype(np.float32))
    v = jax.jit(lambda i: model.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        i, ge._dummy_targets(1, 64)))(x)
    feats = jax.jit(lambda v, i: model.apply(
        v, i, method=lambda m, im: m.extract_feats(im)))(v, x)
    want = jcam.eigen_cam(np.asarray(feats[0][0], np.float32))
    ck = tmp_path / "vars.pkl"
    with open(ck, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, v), f)
    cfg = tmp_path / "tiny.py"
    cfg.write_text(f"model = {flagship_cfg(tiny=True)!r}\n")
    Image.fromarray(img[:64, :64]).save(tmp_path / "tile.png")
    got = tcam.main(["--config-file", str(cfg), "--checkpoint", str(ck),
                     "--image", str(tmp_path / "tile.png"), "--out",
                     str(tmp_path / "cam.png"), "--cpu"])
    assert got.shape == want.shape == (16, 16) and abs(want.max() - 1) < 1e-9
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.asarray(Image.open(tmp_path / "cam.png")).shape == (64, 64, 3)


# ------------------------------------------------------------ host tools

def _run(argv, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


_NO_JAX = ("import runpy, sys\n"
           "sys.argv = [{mod!r}] + {args!r}\n"
           "runpy.run_module({mod!r}, run_name='__main__')\n"
           "bad = [m for m in sys.modules if m.split('.')[0] in\n"
           "       ('jax', 'flax', 'optax', 'cv2', 'rs_detection_tpu')]\n"
           "assert not bad, bad\n")


@pytest.mark.parametrize("tool", ["get_map_str", "longtail_stats", "md5"])
def test_host_tool_matches_jax_without_jax(tool, tmp_path):
    """The port's tool runs with no jax (nor the JAX package, nor cv2)
    loaded and prints what the JAX tool prints on the same input."""
    if tool == "get_map_str":
        args = ["Vehicle_AP:0.5123 Ship_AP:0.25 Bridge_AP:0.125 "
                "Airplane_AP:0.9 meanAP:0.4468", "--dataset", "FAIR1M_1_5"]
        jax_tool = os.path.join("tools", "analysis_tools", "get_map_str.py")
    elif tool == "longtail_stats":
        infos = [dict(ann=dict(labels=np.array([1, 1, 3]))),
                 dict(ann=dict(labels=np.array([2, 1]))), dict(ann={})]
        with open(tmp_path / "labels.pkl", "wb") as f:
            pickle.dump(infos, f)
        args = ["--labels", str(tmp_path / "labels.pkl"), "--classes",
                "DOTA"]
        jax_tool = os.path.join("tools", "analysis_tools",
                                "longtail_stats.py")
    else:
        (tmp_path / "a.bin").write_bytes(os.urandom(3 << 20))
        args = [str(tmp_path / "a.bin"), str(tmp_path / "missing.bin")]
        jax_tool = os.path.join("tools", "md5.py")
    mod = f"rs_detection_tpu_torch.tools.{tool}"
    got = _run([sys.executable, "-c", _NO_JAX.format(mod=mod, args=args)])
    want = _run([sys.executable, jax_tool] + args,
                dict(JAX_PLATFORMS="cpu"))
    assert got.returncode == 0, got.stderr
    assert want.returncode == 0, want.stderr
    assert got.stdout == want.stdout and got.stdout.strip()


# ------------------------------------------------------- 16-bit fair_to_dota

def test_fair_to_dota_16_bit_tiffs_match_cv2(tmp_path):
    """16-bit grey, RGB and RGBA TIFFs written by OpenCV (LZW) become the
    JAX function's PNGs bit for bit: grey by its high byte in three
    channels, colour by round(v / 257), alpha dropped; the samples read
    at full depth equal what was written."""
    src = tmp_path / "src" / "images"
    src.mkdir(parents=True)
    rng = np.random.RandomState(9)
    written = {
        "1": rng.randint(0, 65536, (37, 29)).astype(np.uint16),
        "2": rng.randint(0, 65536, (31, 40, 3)).astype(np.uint16),
        "3": rng.randint(0, 65536, (16, 24, 4)).astype(np.uint16)}
    # the rounding edges of both rules
    written["2"][0, :8, 0] = [0, 127, 128, 128 + 257, 255, 256, 384, 65535]
    for name, arr in written.items():
        assert cv2.imwrite(str(src / f"{name}.tif"), arr)
    for mod, out in ((tfair, "port"), (jfair, "jax")):
        mod.fair_to_dota(str(tmp_path / "src"), str(tmp_path / out))
    for name, arr in written.items():
        png = f"P{name.zfill(4)}.png"
        got = np.asarray(Image.open(tmp_path / "port" / "images" / png))
        want = np.asarray(Image.open(tmp_path / "jax" / "images" / png))
        assert got.shape == arr.shape[:2] + (3,) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=name)
        samples = tfair.read_samples16(str(src / f"{name}.tif"))
        bgr_to_rgb = arr if arr.ndim == 2 else np.concatenate(
            [arr[..., 2::-1], arr[..., 3:]], -1)
        np.testing.assert_array_equal(samples, bgr_to_rgb, err_msg=name)
