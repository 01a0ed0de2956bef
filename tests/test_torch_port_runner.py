"""The port's runner and CLI against the JAX runner: the JAX ``Runner``
serves a tiny VAN Oriented R-CNN config (perturbed weights) with flip
TTA on 2 tiles of 128^2 and saves a checkpoint; the port's
``Runner(device="cpu")`` resumes from that pickle and serves the same
tiles. Dense outputs, the results pickles and the merged submission
agree; plus the runner's loud errors, ``test_time``, ``run_on_images``
and ``run_net`` as a subprocess that imports no jax. CPU, f32."""

import copy
import os
import pickle
import shutil
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rs_detection_tpu.config import get_cfg as jget_cfg
from rs_detection_tpu.data.devkits import data_merge as jdata_merge
from rs_detection_tpu.data.devkits import result_merge as jresult_merge
from rs_detection_tpu.runner.runner import Runner as JRunner
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.flagship import flagship_cfg
from rs_detection_tpu_torch.runner import Runner
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILES = ["P0007__1.0__0___0.png", "P0007__1.0__72___0.png"]
NORM = dict(type="Normalize", mean=[123.675, 116.28, 103.53],
            std=[58.395, 57.12, 57.375], to_bgr=False)


def tiny_config(images_dir, work_dir, **extra):
    """The tiny flagship as a config: test tiles of 128^2 at batch 1, the
    FAIR1M-1.5 merge with its per-class thresholds."""
    cfg = dict(
        name="tiny_runner", work_dir=work_dir, seed=3,
        model=flagship_cfg(tiny=True),
        dataset=dict(test=dict(
            type="ImageDataset", images_dir=images_dir,
            dataset_type="FAIR1M_1_5", batch_size=1,
            transforms=[dict(type="RotatedResize", min_size=128,
                             max_size=128),
                        dict(type="Pad", size_divisor=32), NORM])),
        optimizer=dict(type="AdamW", lr=1e-4, weight_decay=0.05),
        scheduler=dict(type="StepLR", warmup="linear", warmup_iters=500,
                       warmup_ratio=1.0 / 3, milestones=[7, 10]),
        optimizer_swa=dict(type="AdamW", lr=1e-4, weight_decay=0.05),
        scheduler_swa=dict(type="CosineAnnealingLR", max_steps=1,
                           min_lr_ratio=0.01),
        merge_cfg=dict(dataset_type="FAIR1M_1_5"),
        merge_nms_threshold_type=1)
    cfg.update(extra)
    return cfg


def write_config(path, cfg):
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    return path


def _use(getter, cfg):
    c = getter()
    c.clear()
    c.update(copy.deepcopy(cfg))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both runners' test task on the same tiles and weights."""
    root = tmp_path_factory.mktemp("runner")
    images = root / "tiles"
    images.mkdir()
    rng = np.random.RandomState(21)
    for name in TILES:
        Image.fromarray(rng.randint(0, 256, (128, 128, 3)).astype(
            np.uint8)).save(images / name)
    cwd = os.getcwd()
    mp = pytest.MonkeyPatch()
    try:
        # the JAX merge in-process: no fork of a process running jax
        mp.setattr(jdata_merge, "mergebypoly",
                   partial(jresult_merge.mergebypoly, num_process=1))
        (root / "jax").mkdir()
        os.chdir(root / "jax")
        _use(jget_cfg, tiny_config(str(images), str(root / "jax" / "work")))
        jr = JRunner()
        jr._ensure_state()
        v = jax.tree_util.tree_map(jnp.asarray,
                                   perturb(jr._variables(), seed=3))
        jr.state = jr.state._replace(
            params=v["params"],
            batch_stats={k: t for k, t in v.items() if k != "params"})
        jr.test(flip_test=True)
        ckpt = jr.save()

        port_work = root / "port" / "work"
        (port_work / "checkpoints").mkdir(parents=True)
        shutil.copy(ckpt, port_work / "checkpoints" / "ckpt_0.pkl")
        os.chdir(root / "port")
        _use(get_cfg, tiny_config(str(images), str(port_work)))
        pr = Runner(device="cpu")   # resumes from the JAX checkpoint
        pr.test(flip_test=True)
    finally:
        os.chdir(cwd)
        mp.undo()
    return dict(root=root, images=str(images), jr=jr, pr=pr, ckpt=ckpt,
                jax_pkl=root / "jax" / "work" / "test" / "test_0.pkl",
                port_pkl=port_work / "test" / "test_0.pkl")


@pytest.mark.parametrize("flip_mode", [None, "H", "V", "HV"])
def test_dense_outputs_match_jax(served, flip_mode):
    """Each batch's dense outputs before the score threshold. Tolerances
    of ``test_torch_port_slice.py:test_tiny_predict_matches_jax``: atol
    2e-6 on scores, 1e-3 px on polys (f32 on both sides)."""
    jr, pr = served["jr"], served["pr"]
    step = jr._get_eval_step()
    n = 0
    for images, targets, _ in pr.test_dataset.batches(flip_mode):
        got = pr.predict(images, targets)
        ref = step(jr._variables(), jnp.asarray(images),
                   jax.tree_util.tree_map(jnp.asarray, targets))
        valid = np.asarray(ref["valid"])
        assert valid.sum() > 16
        np.testing.assert_array_equal(got["valid"], valid)
        np.testing.assert_allclose(got["scores"], np.asarray(ref["scores"]),
                                   atol=2e-6)
        np.testing.assert_allclose(got["polys"], np.asarray(ref["polys"]),
                                   atol=1e-3)
        n += 1
    assert n == len(TILES)


def test_results_pickles_match_jax(served):
    """Same entries and metas; the detections agree wherever a score is
    clear of the 0.05 threshold by more than the score tolerance."""
    with open(served["jax_pkl"], "rb") as f:
        ref = pickle.load(f)
    with open(served["port_pkl"], "rb") as f:
        got = pickle.load(f)
    assert len(got) == len(ref) == 4 * len(TILES)
    kept = 0
    for ((gp, gs, gl), gm), ((rp, rs, rl), rm) in zip(got, ref):
        assert gm == rm
        gk, rk = np.abs(gs - 0.05) > 2e-6, np.abs(rs - 0.05) > 2e-6
        np.testing.assert_array_equal(gl[gk], rl[rk])
        np.testing.assert_allclose(gs[gk], rs[rk], atol=2e-6)
        np.testing.assert_allclose(gp[gk], rp[rk], atol=1e-3)
        kept += int(gk.sum())
    assert kept > 100
    # perturbed biases put scores on both sides of the threshold
    assert 0 < sum(len(s) for (_, s, _), _ in got) < 64 * 10 * len(got)
    assert served["pr"].test_stats["detections"] == sum(
        len(s) for (_, s, _), _ in got)


def test_merge_of_one_pickle_matches_jax(served, tmp_path, monkeypatch):
    """The port's runner merged its pickle; the JAX merge of that same
    pickle writes byte-equal after-NMS files and CSV."""
    monkeypatch.setattr(jdata_merge, "mergebypoly",
                        partial(jresult_merge.mergebypoly, num_process=1))
    monkeypatch.chdir(tmp_path)
    csv = jdata_merge.data_merge_result(
        str(served["port_pkl"]), str(tmp_path / "work"), 0, "tiny_runner",
        dataset_type="FAIR1M_1_5", nms_threshold_type=1)
    port_dir = served["root"] / "port"
    got_after = port_dir / "work" / "test" / "submit_0" / "after_nms"
    ref_after = tmp_path / "work" / "test" / "submit_0" / "after_nms"
    names = sorted(os.listdir(ref_after))
    assert sorted(os.listdir(got_after)) == names and len(names) == 10
    for name in names:
        assert (got_after / name).read_bytes() == \
            (ref_after / name).read_bytes(), name
    got_csv = (port_dir / "submit_zips" / "tiny_runner.csv").read_bytes()
    assert got_csv == open(csv, "rb").read()
    rows = got_csv.count(b"\n")
    assert 0 < rows < served["pr"].test_stats["detections"]
    assert got_csv.startswith(b"7.tif,")


def test_resume_took_the_checkpoint(served):
    pr = served["pr"]
    assert pr.epoch == served["jr"].epoch == 0
    assert pr.model.compute_dtype is None and not pr.model.training
    assert served["pr"].test_stats["tiles"] == 4 * len(TILES)


def _port_runner(tmp_path, monkeypatch, images, **extra):
    monkeypatch.chdir(tmp_path)
    _use(get_cfg, tiny_config(images, str(tmp_path / "work"), **extra))
    return Runner(device="cpu")


def test_ema_weights_serve_on_resume(served, tmp_path, monkeypatch):
    """A resumed checkpoint with ``ema`` serves the EMA weights, as the
    JAX runner's ``_variables()`` does (``Runner.serving_weights``, the
    context of val and test), and trains on from its parameters, as the
    JAX state's ``params``; a model-only load does not serve them."""
    with open(served["ckpt"], "rb") as f:
        data = pickle.load(f)
    data["ema"] = jax.tree_util.tree_map(lambda a: np.asarray(a) + 1.0,
                                         data["model"]["params"])
    data["meta"]["epoch"] = 4
    path = str(tmp_path / "ckpt_ema.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    ref = np.asarray(data["model"]["params"]["_rpn"]["rpn_cls"]["bias"])
    pr = _port_runner(tmp_path, monkeypatch, served["images"],
                      resume_path=path)
    assert pr.epoch == 4
    with pr.serving_weights():
        np.testing.assert_allclose(
            pr.model.rpn.rpn_cls.bias.detach().numpy(), ref + 1.0, rtol=1e-6)
    np.testing.assert_allclose(pr.model.rpn.rpn_cls.bias.detach().numpy(),
                               ref, rtol=1e-6)
    pr = _port_runner(tmp_path, monkeypatch, served["images"],
                      pretrained_weights=path)
    assert pr.epoch == 0 and pr.ema is None
    with pr.serving_weights():
        np.testing.assert_allclose(
            pr.model.rpn.rpn_cls.bias.detach().numpy(), ref, rtol=1e-6)


def test_pretrained_request_is_loud(served, tmp_path, monkeypatch):
    monkeypatch.delenv("RS_ALLOW_RANDOM_INIT", raising=False)
    model = flagship_cfg(tiny=True)
    model["backbone"]["pretrained"] = True
    with pytest.raises(RuntimeError, match="allow_random_init"):
        _port_runner(tmp_path, monkeypatch, served["images"], model=model)
    _port_runner(tmp_path, monkeypatch, served["images"], model=model,
                 allow_random_init=True)
    monkeypatch.setenv("RS_ALLOW_RANDOM_INIT", "1")
    _port_runner(tmp_path, monkeypatch, served["images"], model=model)


UNPORTED = {
    # an optimizer neither package registers (GradMutilpySGD and Adam,
    # which this case named until they were ported, build:
    # tests/test_torch_retinanet_configs.py, tests/test_torch_optims.py)
    "sgd": (dict(optimizer=dict(type="Lamb", lr=0.01)), None,
            KeyError, "Lamb"),
    "orbax_save": (dict(use_orbax=True), "save", NotImplementedError,
                   "orbax"),
    "orbax_load": ({}, "load_dir", RuntimeError, "orbax"),
    "no_train_dataset": ({}, "train", ValueError, "dataset.train"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_tasks_and_formats_raise(served, tmp_path, monkeypatch,
                                          case):
    """What the port does not do raises: an optimizer outside the
    registry, orbax checkpoints (JAX-only), and training without a train
    dataset. (The per-step EMA and YOLO's parameter groups, which raised
    here until item 11f ported them: ``tests/test_torch_yolo_runner.py``,
    ``tests/test_torch_yolo_configs.py``.)"""
    extra, call, error, match = UNPORTED[case]
    with pytest.raises(error, match=match):
        pr = _port_runner(tmp_path, monkeypatch, served["images"], **extra)
        if call == "load_dir":
            (tmp_path / "orbax_ckpt").mkdir()
            pr.load(str(tmp_path / "orbax_ckpt"))
        elif call is not None:
            getattr(pr, call)()


def test_default_device_needs_a_card(served, tmp_path, monkeypatch):
    """``Runner()`` serves on the CUDA card and raises where there is
    none; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    monkeypatch.chdir(tmp_path)
    _use(get_cfg, tiny_config(served["images"], str(tmp_path / "work")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner()


def test_test_time_and_run_on_images(served, tmp_path):
    pr = served["pr"]
    assert pr.test_time(iters=2, warmup=1) > 0
    paths = [os.path.join(served["images"], t) for t in TILES]
    out = pr.run_on_images(paths, save_dir=str(tmp_path / "vis"))
    assert [p for p, _ in out] == paths
    assert sorted(os.listdir(tmp_path / "vis")) == sorted(TILES)
    polys, scores, labels = out[0][1]
    assert polys.shape[1] == 8 and len(scores) == len(labels)


def _subprocess(code_or_args, cwd):
    # torch's intra-op thread count as this process's (the module runs on
    # one): a CPU conv's sums split by thread, and the CSV is compared byte
    # for byte with the one served here
    env = dict(os.environ, PYTHONPATH=REPO,
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    env.pop("RS_ALLOW_RANDOM_INIT", None)
    proc = subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def test_run_net_cli_serves_a_config(served, tmp_path):
    """``python -m rs_detection_tpu_torch.tools.run_net --cpu --task
    test``: the config's ``flip_test`` runs the four flips, resuming from
    the JAX checkpoint in the work directory."""
    work = tmp_path / "work"
    (work / "checkpoints").mkdir(parents=True)
    shutil.copy(served["ckpt"], work / "checkpoints" / "ckpt_0.pkl")
    cfg = write_config(str(tmp_path / "tiny_runner.py"), tiny_config(
        served["images"], str(work), flip_test=True))
    _subprocess(["-m", "rs_detection_tpu_torch.tools.run_net",
                 "--config-file", cfg, "--task", "test", "--cpu"],
                str(tmp_path))
    with open(work / "test" / "test_0.pkl", "rb") as f:
        assert len(pickle.load(f)) == 4 * len(TILES)
    assert (tmp_path / "submit_zips" / "tiny_runner.csv").read_bytes() == \
        (served["root"] / "port" / "submit_zips" /
         "tiny_runner.csv").read_bytes()


def test_runner_and_run_net_import_no_jax(served, tmp_path):
    """Importing the runner, the CLI, the labelled datasets, the
    evaluation and the tools, loading a JAX checkpoint, serving the tiny
    config's test task, training it one step (``--task train``, a
    checkpoint of the port's format), averaging checkpoints and
    validating pull in no jax, flax or the JAX package."""
    work = tmp_path / "work"
    (work / "checkpoints").mkdir(parents=True)
    shutil.copy(served["ckpt"], work / "checkpoints" / "ckpt_0.pkl")
    cfg = write_config(str(tmp_path / "tiny_runner.py"), tiny_config(
        served["images"], str(work)))
    labelled = tmp_path / "labelled"
    (labelled / "images").mkdir(parents=True)
    for t in TILES:
        shutil.copy(os.path.join(served["images"], t), labelled / "images")
    with open(labelled / "labels.pkl", "wb") as f:
        pickle.dump([dict(filename=t, width=128, height=128, ann=dict(
            bboxes=np.array([[40, 40, 30, 14, 0.3], [80, 70, 20, 10, -0.4]],
                            np.float32), labels=np.array([1, 2])))
            for t in TILES], f)
    split = dict(type="FAIR1M_1_5_Dataset", dataset_dir=str(labelled),
                 batch_size=2, max_gt=4, transforms=[
                     dict(type="RotatedRandomFlip", prob=0.5),
                     dict(type="Pad", size_divisor=32), NORM])
    train_cfg = write_config(str(tmp_path / "tiny_train.py"), tiny_config(
        served["images"], str(tmp_path / "train_work"), max_epoch=1,
        log_interval=1,
        pretrained_weights=str(served["ckpt"]),
        dataset=dict(train=split, val=split)))
    code = ("import sys\n"
            "import rs_detection_tpu_torch.runner\n"
            "from rs_detection_tpu_torch.data import custom, dota\n"
            "from rs_detection_tpu_torch.data.devkits import voc_eval\n"
            "from rs_detection_tpu_torch.tools import get_swa_model, val\n"
            "from rs_detection_tpu_torch.tools.run_net import main\n"
            f"runner = main(['--config-file', {cfg!r}, '--task', 'test',\n"
            "               '--cpu'])\n"
            "assert runner.test_stats['tiles'] == 2, runner.test_stats\n"
            f"runner = main(['--config-file', {train_cfg!r}, '--task',\n"
            "               'train', '--cpu'])\n"
            "assert runner.iter == 1 and runner.history, runner.history\n"
            "get_swa_model.get_swa_model(runner.work_dir, 1, 1)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'optax', 'rs_detection_tpu')]\n"
            "assert not bad, bad\n")
    _subprocess(["-c", code], str(tmp_path))
    assert (tmp_path / "submit_zips" / "tiny_runner.csv").exists()
    assert sorted(os.listdir(tmp_path / "train_work" / "checkpoints")) == [
        "ckpt_1.pkl", "swa_1-1.pkl"]
    assert (tmp_path / "train_work" / "detections" / "val_1" /
            "val.pkl").exists()


@pytest.fixture(scope="module")
def served_scene(served):
    """The JAX runner of ``served`` (its weights and compiled eval step)
    and a port runner resumed from its checkpoint serve one raw scene of
    170 x 229 through ``SceneDataset`` (rates 0.5 and 1.0, 128^2 tiles at
    a gap of 32, batch 1, flip-TTA): 7 tiles, 28 forwards each."""
    from rs_detection_tpu.data.scene import SceneDataset as JSceneDataset

    root = served["root"] / "scene"
    scenes = root / "scenes"
    scenes.mkdir(parents=True)
    Image.fromarray(np.random.RandomState(13).randint(
        0, 256, (170, 229, 3)).astype(np.uint8)).save(scenes / "7.png")
    kw = dict(images_dir=str(scenes), subsize=128, gap=32,
              rates=[0.5, 1.0], batch_size=1)
    jr = served["jr"]
    saved = jr.work_dir, jr.test_dataset
    cwd = os.getcwd()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jdata_merge, "mergebypoly",
                   partial(jresult_merge.mergebypoly, num_process=1))
        (root / "jax").mkdir()
        os.chdir(root / "jax")
        jr.work_dir = str(root / "jax" / "work")
        jr.test_dataset = JSceneDataset(**kw)
        jr.test(flip_test=True)
        port_work = root / "port" / "work"
        (port_work / "checkpoints").mkdir(parents=True)
        shutil.copy(served["ckpt"], port_work / "checkpoints" / "ckpt_0.pkl")
        os.chdir(root / "port")
        _use(get_cfg, tiny_config(str(scenes), str(port_work), dataset=dict(
            test=dict(type="SceneDataset", dataset_type="FAIR1M_1_5", **kw))))
        pr = Runner(device="cpu")
        pr.test(flip_test=True)
    finally:
        jr.work_dir, jr.test_dataset = saved
        os.chdir(cwd)
        mp.undo()
    return dict(root=root, pr=pr,
                jax_pkl=root / "jax" / "work" / "test" / "test_0.pkl",
                port_pkl=port_work / "test" / "test_0.pkl")


def test_scene_task_pickle_matches_jax(served_scene):
    """The scene test task: the same 28 tile metas in the same order (the
    merge's names ``7__0.5__0___0.png`` ...); detections agree within
    ``chip_smoke.py`` phase 21's tolerances (scores 1e-5, polygons 1e-2
    px) wherever a score is clear of the 0.05 threshold by more; both
    merges write FAIR1M-1.5 CSVs of as many rows."""
    with open(served_scene["jax_pkl"], "rb") as f:
        ref = pickle.load(f)
    with open(served_scene["port_pkl"], "rb") as f:
        got = pickle.load(f)
    assert len(got) == len(ref) == 4 * 7
    assert {m["filename"] for _, m in got} >= {"7__0.5__0___0.png",
                                                "7__1.0__101___42.png"}
    kept = 0
    for ((gp, gs, gl), gm), ((rp, rs, rl), rm) in zip(got, ref):
        assert gm == rm
        gk, rk = np.abs(gs - 0.05) > 1e-5, np.abs(rs - 0.05) > 1e-5
        np.testing.assert_array_equal(gl[gk], rl[rk])
        np.testing.assert_allclose(gs[gk], rs[rk], atol=1e-5)
        np.testing.assert_allclose(gp[gk], rp[rk], atol=1e-2)
        kept += int(gk.sum())
    assert kept > 100
    assert served_scene["pr"].test_stats["tiles"] == 4 * 7
    rows = [(served_scene["root"] / side / "submit_zips" /
             "tiny_runner.csv").read_text().count("\n")
            for side in ("port", "jax")]
    assert rows[0] == rows[1] > 0
