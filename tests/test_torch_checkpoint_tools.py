"""The port's checkpoint tools against their JAX twins on the CPU:
``utils/checkpoint_convert.py`` (trees bit-equal to the JAX module's on
the same state dict), ``tools/convert_checkpoint.py`` (the same pickle as
the JAX tool's; with ``--config`` a JDet state dict remapped, audited and
read by the port's ``read_checkpoint``), and ``tools/parity_check.py``
(its remap equals the JAX tool's, its audit reports every mismatch and
exits 2, its selftest passes, and the ``--config --ckpt --images
--record / --ref-dets`` path serves a JDet-style pickle of a seeded tiny
flagship with exactly the original module's detections)."""

import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from rs_detection_tpu.utils import checkpoint_convert as jconv
from rs_detection_tpu_torch.flagship import build_flagship, flagship_cfg
from rs_detection_tpu_torch.tools import convert_checkpoint as conv
from rs_detection_tpu_torch.tools import parity_check as pc
from rs_detection_tpu_torch.utils import checkpoint_convert as tconv
from rs_detection_tpu_torch.utils.checkpoint import (load_model_arrays,
                                                     read_checkpoint)
from torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import parity_check as jpc  # noqa: E402

FC = {"bbox_head.shared_fc0": (32, 7, 7)}   # the tiny flagship's head


def _model(seed):
    return build_flagship(tiny=True, device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def _jdet_state(seed=3):
    """The tiny flagship's seeded weights in the reference's style (JDet
    names, torch layouts, the first shared FC over (C, P, P)), with a
    BN counter and torch tensors among the numpy arrays."""
    state = pc.export_reference_style(_model(seed), FC)
    state["backbone.block1.0.norm1.num_batches_tracked"] = np.array(7)
    conv4 = next(k for k, v in state.items() if k.startswith("neck.")
                 and np.ndim(v) == 4)
    state[conv4] = torch.from_numpy(state[conv4])
    return state


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
        return
    assert isinstance(a, dict) == isinstance(b, dict), path
    if not isinstance(a, dict):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
        return
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        _assert_trees_equal(a[k], b[k], f"{path}/{k}")


def test_converter_trees_equal_jax(tmp_path):
    """``torch_state_to_flax`` (with and without ``fc_spatial``),
    ``convert_tensor``, ``load_reference_checkpoint`` and
    ``compare_trees`` / ``check_diff`` give the JAX module's results bit
    for bit."""
    state = pc.remap_reference_names(_jdet_state())
    for fc in (None, FC):
        _assert_trees_equal(tconv.torch_state_to_flax(state, fc),
                            jconv.torch_state_to_flax(state, fc))
    w = np.random.RandomState(0).randn(4, 3, 2, 5).astype(np.float32)
    for name, v in (("a.weight", w), ("fc.weight", w[0, 0]),
                    ("bn.running_var", w[0, 0]), ("x.bias", w[0, 0, 0])):
        np.testing.assert_array_equal(tconv.convert_tensor(name, v),
                                      jconv.convert_tensor(name, v))
    ck = tmp_path / "ref.pkl"
    with open(ck, "wb") as f:
        pickle.dump({"meta": {}, "model": state}, f)
    _assert_trees_equal(tconv.load_reference_checkpoint(str(ck)),
                        jconv.load_reference_checkpoint(str(ck)))
    params, _ = tconv.torch_state_to_flax(state)
    other = copy.deepcopy(params)
    other.pop("neck")
    other["extra"] = np.zeros(2)
    other["bbox_head"]["fc_cls"]["kernel"] = np.zeros(3)
    rep = tconv.compare_trees(params, other)
    assert rep == jconv.compare_trees(params, other)
    assert rep["neck"] == "missing in B" and rep["extra"] == "missing in A"
    assert rep["bbox_head/fc_cls/kernel"].startswith("shape")
    for i, tree in enumerate((params, other)):
        with open(tmp_path / f"t{i}.pkl", "wb") as f:
            pickle.dump(tree, f)
    a, b = str(tmp_path / "t0.pkl"), str(tmp_path / "t1.pkl")
    assert tconv.check_diff(a, b) == jconv.check_diff(a, b) == rep


def test_remap_and_audit_equal_jax():
    """The remap of a JDet-style dict (VAN blocks, the LKA's spatial
    gating unit, the conv-MLP's inner dwconv, the shared FCs, a ResNet
    downsample, BN leaves) equals the JAX tool's, and the audit reports
    every mismatch as the JAX tool's does."""
    state = _jdet_state()
    state.update({"backbone.layer1.0.downsample.0.weight": np.zeros(
        (64, 64, 1, 1)), "backbone.layer1.0.downsample.1.running_var":
        np.zeros(64)})
    assert "backbone.block1.0.attn.spatial_gating_unit.conv0.weight" in state
    assert "backbone.block1.0.mlp.dwconv.dwconv.weight" in state
    assert "bbox_head.shared_fcs.0.weight" in state
    got, want = pc.remap_reference_names(state), jpc.remap_reference_names(
        state)
    assert list(got) == list(want)
    assert all(got[k] is want[k] for k in got)
    assert "backbone.block1_0.norm1.BatchNorm_0.weight" in got
    assert "backbone.layer1.0.downsample_bn.running_var" in got
    have = {"a": {"kernel": np.zeros((3, 4))}, "x": np.zeros(2)}
    need = {"a": {"kernel": np.zeros((4, 4))}, "y": np.zeros(2)}
    problems = pc.audit(have, need, "params")
    assert problems == jpc.audit(have, need, "params") and len(problems) == 3


def test_parity_selftest_round_trip():
    """The port's selftest: the tiny flagship exported in the reference's
    style and reloaded through remap + convert + audit into a model of
    other weights gives identical detections."""
    ref, got = pc.selftest()
    assert sum(len(d[1]) for d in ref) > 0
    for (rp, rs, rl), (gp, gs, gl) in zip(ref, got):
        np.testing.assert_array_equal(rp, gp)
        np.testing.assert_array_equal(rs, gs)
        np.testing.assert_array_equal(rl, gl)


def _config_and_tiles(tmp_path):
    cfg = tmp_path / "tiny_flagship.py"
    cfg.write_text(f"model = {flagship_cfg(tiny=True)!r}\n")
    tiles = tmp_path / "tiles"
    tiles.mkdir()
    from PIL import Image
    rng = np.random.RandomState(5)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(
            np.uint8)).save(tiles / f"t{i}.png")
    return str(cfg), str(tiles)


def test_parity_check_config_path(tmp_path, capsys):
    """A JDet-style pickle of a seeded tiny flagship through the config
    path: an exact audit, ``--record`` of the port's detections equal to
    the original module's, ``--ref-dets`` against them passing at the
    selftest's bar (exact counts, IoU 0.99, score MAE 1e-5); a checkpoint
    with a missing and a misshapen entry exits 2 naming both."""
    cfg, tiles = _config_and_tiles(tmp_path)
    original = _model(3)
    ck = tmp_path / "jdet.pkl"
    with open(ck, "wb") as f:
        pickle.dump({"meta": {}, "model": _jdet_state(3)}, f)
    _, images = pc.read_images(tiles)
    ref = pc.run_inference(original, images)
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump({"dets": ref}, f)
    argv = ["--config", cfg, "--ckpt", str(ck), "--images", tiles, "--cpu"]
    rec = tmp_path / "rec.pkl"
    pc.main(argv + ["--record", str(rec)])
    with open(rec, "rb") as f:
        recorded = pickle.load(f)
    assert recorded["files"] == ["t0.png", "t1.png"]
    assert sum(len(d[1]) for d in ref) > 0
    for (rp, rs, rl), (gp, gs, gl) in zip(ref, recorded["dets"]):
        np.testing.assert_array_equal(rp, gp)
        np.testing.assert_array_equal(rs, gs)
        np.testing.assert_array_equal(rl, gl)
    pc.main(argv + ["--ref-dets", str(tmp_path / "ref.pkl"), "--iou-thr",
                    "0.99", "--score-tol", "1e-5", "--count-tol", "0"])
    out = capsys.readouterr().out
    assert "checkpoint audit OK" in out and "PARITY OK" in out
    bad = _jdet_state(3)
    bad.pop("bbox_head.fc_cls.bias")
    bad["bbox_head.fc_reg.weight"] = bad["bbox_head.fc_reg.weight"][:, :8]
    with open(ck, "wb") as f:
        pickle.dump({"model": bad}, f)
    with pytest.raises(SystemExit) as e:
        pc.main(argv + ["--record", str(rec)])
    assert e.value.code == 2
    out = capsys.readouterr().out
    assert "MISSING  state_dict/bbox_head.fc_cls.bias" in out
    assert "SHAPE    state_dict/bbox_head.fc_reg.weight" in out


def test_convert_checkpoint_tool_equals_jax(tmp_path):
    """A torch file: the port's tool writes the JAX tool's pickle (trees
    bit for bit). With ``--config`` a JDet-style pickle is remapped and
    audited, and the port's ``read_checkpoint`` loads it into a fresh
    model as the original module's weights; a bad one exits 2."""
    state = {"backbone.conv1.weight": torch.randn(8, 3, 3, 3),
             "backbone.bn1.weight": torch.rand(8),
             "backbone.bn1.bias": torch.randn(8),
             "backbone.bn1.running_mean": torch.randn(8),
             "backbone.bn1.running_var": torch.rand(8),
             "backbone.bn1.num_batches_tracked": torch.tensor(3),
             "head.fc.weight": torch.randn(4, 8),
             "head.fc.bias": torch.randn(4)}
    src = tmp_path / "w.pth"
    torch.save({"state_dict": state}, src)
    conv.main(["--src", str(src), "--out", str(tmp_path / "port.pkl")])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "convert_checkpoint.py"),
                    "--src", str(src), "--out", str(tmp_path / "jax.pkl")],
                   check=True, env=env, capture_output=True, timeout=300)
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    assert got["meta"] == want["meta"]
    _assert_trees_equal(got["model"], want["model"])

    cfg, _ = _config_and_tiles(tmp_path)
    jdet = tmp_path / "jdet.pkl"
    with open(jdet, "wb") as f:
        pickle.dump({"meta": {}, "model": _jdet_state(3)}, f)
    out = tmp_path / "converted.pkl"
    conv.main(["--src", str(jdet), "--out", str(out), "--config", cfg])
    _, arrays, _, _ = read_checkpoint(str(out))
    loaded = load_model_arrays(_model(4), arrays)
    for k, v in _model(3).state_dict().items():
        np.testing.assert_array_equal(loaded.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)
    bad = _jdet_state(3)
    bad["bbox_head.extra.weight"] = np.zeros((2, 2))
    with open(jdet, "wb") as f:
        pickle.dump(bad, f)
    with pytest.raises(SystemExit) as e:
        conv.main(["--src", str(jdet), "--out", str(out), "--config", cfg])
    assert e.value.code == 2
