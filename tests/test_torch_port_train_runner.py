"""The port's training runner against the JAX runner: a tiny VAN
Oriented R-CNN config (samplers that take every candidate, so both
sides sample the same sets), 2 seeded 64^2 tiles with a ``labels.pkl``,
batch 2 (one step an epoch), flips and 90-degree rotations, 4 epochs:
AdamW with the StepLR warmup and a milestone at epoch 2, then the SWA
switch at epoch 3 (AdamW and the cosine schedule from their step 0).
Both runners start from one set of weights (the JAX runner's init,
perturbed, passed as ``pretrained_weights``), draw the augmentations of
epoch e from the same seeds (``seed_host_rngs``) and save a checkpoint
an epoch. Checked: learning rates, losses and parameters step by step;
resume (the port's and the JAX runner's checkpoints, with the AdamW
moments and count); val between epochs with bf16 compute; SWA
averaging; the ``run_net`` and tool entry points. CPU, f32 unless
stated.

The JAX runner draws ``model.init`` again at the SWA switch
(``runner.py:309`` drops its train step, so ``train`` calls
``_init_state``), which throws the trained weights away; the reference
keeps them. The fixture makes the switch as the reference does, with the
JAX runner's own ``tx_swa``: a fresh optimizer state for the trained
weights and a train step for it. It also builds the first state by hand
(``model.init`` jitted, ``create_train_state``, ``make_train_step``, as
``_init_state`` does): the eager ``init`` there takes about a minute on
the CPU."""

import copy
import importlib.util
import os
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rs_detection_tpu.runner.runner as jrunner
from rs_detection_tpu.config import get_cfg as jget_cfg
from rs_detection_tpu.parallel.train_step import (create_train_state,
                                                  make_train_step)
from rs_detection_tpu.utils.registry import OPTIMS as JOPTIMS
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.flagship import flagship_cfg
from rs_detection_tpu_torch.runner import Runner
from rs_detection_tpu_torch.runner.runner import seed_host_rngs
from rs_detection_tpu_torch.utils.jax_weights import jax_to_state_dict
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
IMG = 64
BASE_LR, SWA_LR = 1e-4, 5e-5
NORM = dict(type="Normalize", mean=[123.675, 116.28, 103.53],
            std=[58.395, 57.12, 57.375], to_bgr=False)
# per step: warmup 1/3 and 2/3 (warmup_iters 2), the epoch-2 milestone,
# then the SWA cosine at its count 0
WANT_LRS = [BASE_LR / 3, 2 * BASE_LR / 3, BASE_LR / 10, SWA_LR]


def make_tiles(root, n=2):
    """Seeded tiles, each with ground truths near anchors of several
    shapes (both stages get positives) and one ignored box."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.RandomState(0)
    infos = []
    for i in range(n):
        name = f"t{i}.png"
        Image.fromarray(rng.randint(0, 256, (IMG, IMG, 3)).astype(
            np.uint8)).save(os.path.join(root, "images", name))
        boxes = np.array([[26, 26, 32, 32, 0.05], [42, 34, 44, 22, -0.08],
                          [20, 46, 24, 12, 0.7]], np.float32)
        infos.append(dict(filename=name, width=IMG, height=IMG, ann=dict(
            bboxes=boxes, labels=np.array([1, 2, 5]),
            bboxes_ignore=np.array([[50, 12, 8, 6, 0.2]], np.float32))))
    with open(os.path.join(root, "labels.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return root


def tiny_train_config(ds, work_dir, **extra):
    model = flagship_cfg(tiny=True)
    # take every candidate: >= the 2387 anchors of a 64^2 image, and
    # nms_post + max_gt proposals, all as positives
    model["rpn"]["sampler"] = dict(num=4096, pos_fraction=1.0)
    model["bbox_head"]["sampler"] = dict(num=64 + 8, pos_fraction=1.0,
                                         add_gt_as_proposals=True)
    resize = dict(type="RotatedResize", min_size=IMG, max_size=IMG)
    pad = dict(type="Pad", size_divisor=32)
    cfg = dict(
        name="tiny_train", work_dir=work_dir, seed=SEED, model=model,
        max_epoch=4, swa_start_epoch=3, log_interval=1,
        checkpoint_interval=1,
        dataset=dict(
            train=dict(type="FAIR1M_1_5_Dataset", dataset_dir=ds,
                       batch_size=2, shuffle=True, max_gt=8,
                       filter_empty_gt=False, transforms=[
                           resize, dict(type="RotatedRandomFlip", prob=0.5),
                           dict(type="RandomRotateAug",
                                random_rotate_on=True), pad, NORM]),
            val=dict(type="FAIR1M_1_5_Dataset", dataset_dir=ds, batch_size=2,
                     max_gt=8, transforms=[resize, pad, NORM])),
        optimizer=dict(type="AdamW", lr=BASE_LR, weight_decay=0.05,
                       grad_clip=dict(max_norm=35)),
        scheduler=dict(type="StepLR", warmup="linear", warmup_iters=2,
                       warmup_ratio=1.0 / 3, milestones=[2]),
        optimizer_swa=dict(type="AdamW", lr=SWA_LR, weight_decay=0.05),
        scheduler_swa=dict(type="CosineAnnealingLR", max_steps=1,
                           min_lr_ratio=0.01))
    cfg.update(extra)
    return cfg


def _use(getter, cfg):
    c = getter()
    c.clear()
    c.update(copy.deepcopy(cfg))


def _record_jax_lrs(monkeypatch, lrs):
    """Record each learning rate the JAX runner's optax AdamW applies."""
    adamw = JOPTIMS._modules["AdamW"]

    def recording(lr=1e-4, **kw):
        def schedule(count):
            v = lr(count)
            jax.debug.callback(lambda x: lrs.append(float(x)), v)
            return v
        return adamw(lr=schedule, **kw)

    monkeypatch.setitem(JOPTIMS._modules, "AdamW", recording)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX runner's 4 epochs (a checkpoint each) and the port's from
    the same weights."""
    root = tmp_path_factory.mktemp("train_runner")
    ds = make_tiles(str(root / "ds"))
    mp = pytest.MonkeyPatch()
    lrs, records = [], []
    try:
        _record_jax_lrs(mp, lrs)
        _use(jget_cfg, tiny_train_config(ds, str(root / "jax")))
        jr = jrunner.Runner()
        images, targets, _ = next(iter(jr.train_dataset.batches()))
        init = jax.jit(lambda i, t: jr.model.init(
            {"params": jax.random.PRNGKey(SEED),
             "sampler": jax.random.PRNGKey(1)}, i, t))
        weights = perturb(init(jnp.asarray(images[:1]), {
            k: jnp.asarray(v[:1]) for k, v in targets.items()}), seed=7)
        with open(root / "weights.pkl", "wb") as f:
            pickle.dump(weights, f)
        dev = jax.devices()[0]
        # committed to the device, as the step's outputs are: one compile
        # serves every step of a phase
        jr.state = jax.device_put(create_train_state(
            jr.model, jax.tree_util.tree_map(jnp.asarray, weights), jr.tx),
            dev)
        jr._train_step = make_train_step(jr.model, jr.tx, mesh=jr.mesh)
        log = jr.logger.log
        mp.setattr(jr.logger, "log", lambda d: (records.append(d), log(d)))
        while not jr.finish:
            seed_host_rngs(SEED, jr.epoch)
            if jr.epoch >= jr.swa_start_epoch and not jr._swa_active:
                jr._swa_active, jr.tx = True, jr.tx_swa
                jr.state = jr.state._replace(opt_state=jax.device_put(
                    jr.tx_swa.init(jr.state.params), dev))
                jr._train_step = make_train_step(jr.model, jr.tx, mesh=jr.mesh)
            jr.train()
            jr.save()
    finally:
        mp.undo()
    ref = jax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                   jr._variables()))
    port = port_run(root / "port", ds, root / "weights.pkl")
    return dict(root=root, ds=ds, weights=str(root / "weights.pkl"),
                jax_lrs=lrs, jax_records=records, jax_params=ref,
                jax_ckpts=str(root / "jax" / "checkpoints"), port=port)


def port_run(work, ds, weights=None, max_epoch=4, **extra):
    """``Runner(device="cpu").run()`` of the tiny config."""
    torch.use_deterministic_algorithms(True)
    try:
        _use(get_cfg, tiny_train_config(
            ds, str(work), max_epoch=max_epoch,
            pretrained_weights=None if weights is None else str(weights),
            **extra))
        runner = Runner(device="cpu")
        runner.run()
    finally:
        torch.use_deterministic_algorithms(False)
    return runner


def _params(runner):
    return {k: v.detach().float().numpy()
            for k, v in runner.model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _assert_params_near_jax(got, ref, lrs):
    """Every element within 2 x (the sum of the step rates): one AdamW
    step moves a weight by about lr x sign(gradient), so where a
    gradient is noise (the biases ahead of a BatchNorm, ~1e-9) the two
    sides may step opposite ways each step; at most 0.5% of the elements
    beyond 1e-6 (measured: 0.05%). BN statistics to 1e-4 relative."""
    assert set(got) == set(ref)
    bound = 2 * sum(lrs) + 1e-6
    beyond = total = 0
    for k, v in ref.items():
        d = np.abs(got[k] - v)
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            continue
        assert d.max() <= bound, (k, d.max(), bound)
        beyond += int((d > 1e-6).sum())
        total += d.size
    assert beyond <= 0.005 * total, (beyond, total)


def test_learning_rates_match_jax(trained):
    """The rate of each step: the warmup and the epoch-2 milestone by
    the AdamW count, then the SWA cosine from its count 0 (its epoch the
    SWA count over the steps per epoch, not the run's epoch, which would
    put it at its floor), to f32 rounding."""
    got = [r["lr"] for r in trained["port"].history]
    np.testing.assert_allclose(got, WANT_LRS, rtol=1e-12)
    np.testing.assert_allclose(trained["jax_lrs"], WANT_LRS, rtol=1e-6)


def test_losses_match_jax(trained):
    """Each step's four losses and their sum to 2e-3 relative (the bound
    of ``test_torch_port_train_step.py:test_losses_match``; measured
    3e-7), both bbox losses nonzero."""
    got, ref = trained["port"].history, trained["jax_records"]
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert (g["epoch"], g["iter"]) == (r["epoch"], r["iter"])
        for k, v in r.items():
            if "loss" in k:
                assert abs(g[k] - v) <= 2e-3 * max(abs(v), 0.1), (k, g[k], v)
        assert r["loss_rpn_bbox"] > 0 and r["orcnn_bbox_loss"] > 0
    # the augmentations act: not every step sees the same batch
    assert len({round(g["loss_rpn_bbox"], 6) for g in got}) == 4


def test_parameters_match_jax(trained):
    _assert_params_near_jax(_params(trained["port"]), trained["jax_params"],
                            WANT_LRS)


def test_swa_switch_state(trained):
    """After the run: the SWA optimizer, one step taken, checkpoints of
    every epoch, and the last one marked as in the SWA phase."""
    pr = trained["port"]
    assert pr._swa_active and pr.optimizer is pr.optimizer_swa
    assert pr.optimizer.iterations == 1 and (pr.epoch, pr.iter) == (4, 4)
    ckpts = pr.work_dir + "/checkpoints"
    assert sorted(os.listdir(ckpts)) == [f"ckpt_{e}.pkl" for e in (1, 2, 3,
                                                                    4)]
    with open(ckpts + "/ckpt_4.pkl", "rb") as f:
        data = pickle.load(f)
    assert data["meta"]["swa_active"] and data["ema"] is None
    assert data["opt_state"]["iterations"] == 1
    assert {v.dtype for v in data["model"].values()} == {np.dtype("float32")}


def test_resume_equals_unbroken(trained, tmp_path):
    """2 epochs, a new Runner resuming from the work directory's newest
    checkpoint (epoch, iteration, AdamW moments and count), 2 more:
    bit for bit the unbroken run's parameters and rates."""
    work = tmp_path / "work"
    first = port_run(work, trained["ds"], trained["weights"], max_epoch=2)
    assert first.optimizer.iterations == 2
    second = port_run(work, trained["ds"], trained["weights"])
    assert (second.epoch, second.iter) == (4, 4)
    assert [r["lr"] for r in second.history] == WANT_LRS[2:]
    ref = _params(trained["port"])
    for k, v in _params(second).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_resume_equals_unbroken_with_loader_threads(trained, tmp_path):
    """The same with 3 loader threads, which run the flips and rotations
    of a batch's samples at once (2 epochs): two unbroken runs from one
    seed draw the same augmentations (equal losses, every step) and
    train the same parameters, and 1 epoch, a resume and 1 more equal
    them, bit for bit."""
    ds = tiny_train_config(trained["ds"], "")["dataset"]
    ds["train"]["num_workers"] = 3

    def run(name, max_epoch=2):
        return port_run(tmp_path / name, trained["ds"], trained["weights"],
                        max_epoch=max_epoch, dataset=ds)

    a, b = run("a"), run("b")
    run("c", max_epoch=1)
    resumed = run("c")
    assert [r["lr"] for r in resumed.history] == WANT_LRS[1:2]
    losses = [{k: v for k, v in r.items() if "loss" in k} for r in a.history]
    assert losses == [{k: v for k, v in r.items() if "loss" in k}
                      for r in b.history]
    assert losses[1:] == [{k: v for k, v in r.items() if "loss" in k}
                          for r in resumed.history]
    ref = _params(a)
    for other in (b, resumed):
        for k, v in _params(other).items():
            np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_resume_inside_swa_adopts_its_optimizer(trained, tmp_path):
    """A checkpoint of the SWA phase resumes into the SWA optimizer with
    its state (not a fresh one) and trains on as the unbroken run."""
    work = tmp_path / "work"
    (work / "checkpoints").mkdir(parents=True)
    shutil.copy(os.path.join(trained["port"].work_dir, "checkpoints",
                             "ckpt_4.pkl"), work / "checkpoints")
    pr = port_run(work, trained["ds"], max_epoch=5)
    assert pr._swa_active and pr.optimizer is pr.optimizer_swa
    assert pr.optimizer.iterations == 2 and pr.iter == 5
    # the cosine at the SWA count 1 of max_steps 1: its floor
    assert pr.history[-1]["lr"] == pytest.approx(0.01 * SWA_LR, rel=1e-12)


def test_jax_checkpoint_resumes_with_its_optimizer_state(trained, tmp_path):
    """The JAX runner's epoch-2 checkpoint: the port takes its epoch,
    iteration, AdamW count and moments (``jax_adamw_state``), then 2
    more steps land on the JAX runner's 4-step parameters."""
    with open(os.path.join(trained["jax_ckpts"], "ckpt_2.pkl"), "rb") as f:
        data = pickle.load(f)
    mu = jax_to_state_dict({"params": data["opt_state"]["1"]["0"]["mu"]})
    nu = jax_to_state_dict({"params": data["opt_state"]["1"]["0"]["nu"]})
    work = tmp_path / "work"
    _use(get_cfg, tiny_train_config(
        trained["ds"], str(work),
        resume_path=os.path.join(trained["jax_ckpts"], "ckpt_2.pkl")))
    pr = Runner(device="cpu")
    assert (pr.epoch, pr.iter, pr.optimizer.iterations) == (2, 2, 2)
    assert not pr._swa_active
    for name, p in pr.model.named_parameters():
        s = pr.optimizer.state[p]
        assert float(s["step"]) == 2.0
        np.testing.assert_array_equal(s["exp_avg"].numpy(), mu[name])
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), nu[name])
    torch.use_deterministic_algorithms(True)
    try:
        pr.run()
    finally:
        torch.use_deterministic_algorithms(False)
    np.testing.assert_allclose([r["lr"] for r in pr.history], WANT_LRS[2:],
                               rtol=1e-12)
    _assert_params_near_jax(_params(pr), trained["jax_params"], WANT_LRS)


def test_val_between_epochs_keeps_the_trajectory(trained, tmp_path):
    """bf16 compute: a run with val after every epoch and one with val
    only at the end train the same f32 master weights bit for bit; val
    leaves the model in train mode and writes its results."""
    model = dict(tiny_train_config("", "")["model"],
                 compute_dtype="bfloat16")
    with_val = port_run(tmp_path / "a", trained["ds"], trained["weights"],
                        model=model, eval_interval=1)
    without = port_run(tmp_path / "b", trained["ds"], trained["weights"],
                       model=model)
    assert {p.dtype for p in with_val.model.parameters()} == {torch.float32}
    assert with_val.model.training
    for k, v in _params(without).items():
        np.testing.assert_array_equal(_params(with_val)[k], v, err_msg=k)
    dets = sorted(os.listdir(tmp_path / "a" / "detections"))
    assert dets == [f"val_{e}" for e in (1, 2, 3, 4)]
    aps = with_val.val()
    assert len(aps) == 11 and all(np.isfinite(list(aps.values())))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_get_swa_model_averages_port_and_jax_checkpoints(trained):
    """``swa_3-4.pkl``: the mean of the two checkpoints' weights by name;
    of the JAX runner's checkpoints too, equal to the JAX tool's mean."""
    from rs_detection_tpu_torch.tools.get_swa_model import get_swa_model
    from rs_detection_tpu_torch.utils.checkpoint import read_checkpoint

    ckpts = os.path.join(trained["port"].work_dir, "checkpoints")
    out = get_swa_model(trained["port"].work_dir, 3, 4)
    assert out == os.path.join(ckpts, "swa_3-4.pkl")
    meta, avg, opt, _ = read_checkpoint(out)
    assert opt is None and meta["epoch"] == 4
    a = read_checkpoint(os.path.join(ckpts, "ckpt_3.pkl"))[1]
    b = read_checkpoint(os.path.join(ckpts, "ckpt_4.pkl"))[1]
    for k in a:
        np.testing.assert_array_equal(avg[k], np.mean(np.stack([a[k], b[k]]),
                                                      0))
    jax_work = os.path.dirname(trained["jax_ckpts"])
    out = get_swa_model(jax_work, 1, 4)
    got = read_checkpoint(out)[1]
    ref = _jax_tool("get_swa_model").average_checkpoints(
        [os.path.join(trained["jax_ckpts"], f"ckpt_{e}.pkl")
         for e in range(1, 5)])
    ref = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, ref["model"]))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def _subprocess(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("RS_ALLOW_RANDOM_INIT", None)
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def _write_config(path, cfg):
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    return str(path)


def test_run_net_train_and_val_cli(trained, tmp_path):
    """``run_net --task train --cpu``, then ``get_swa_model``, then
    ``--task val --cpu`` resuming from the averaged weights, each as a
    subprocess that imports no jax, flax, optax or the JAX package."""
    work = tmp_path / "work"
    cfg = _write_config(tmp_path / "tiny_train.py", tiny_train_config(
        trained["ds"], str(work), max_epoch=2, swa_start_epoch=1,
        pretrained_weights=trained["weights"], dataset=dict(
            tiny_train_config(trained["ds"], "")["dataset"], val=None)))
    val_cfg = _write_config(tmp_path / "tiny_val.py", tiny_train_config(
        trained["ds"], str(tmp_path / "val_work"),
        resume_path=str(work / "checkpoints" / "swa_1-2.pkl")))
    code = (
        "import sys\n"
        "from rs_detection_tpu_torch.tools import get_swa_model, run_net\n"
        "from rs_detection_tpu_torch.tools import val\n"
        f"r = run_net.main(['--config-file', {cfg!r}, '--task', 'train',\n"
        "                   '--cpu'])\n"
        "assert (r.epoch, r.iter, r.optimizer.iterations) == (2, 2, 1)\n"
        f"get_swa_model.main(['--work_dir', {str(work)!r}, '--start', '1',\n"
        "                     '--end', '2'])\n"
        f"r = run_net.main(['--config-file', {val_cfg!r}, '--task', 'val',\n"
        "                   '--cpu'])\n"
        "assert r.epoch == 2 and r._swa_active\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'rs_detection_tpu')]\n"
        "assert not bad, bad\n")
    _subprocess(["-c", code], str(tmp_path))
    assert sorted(os.listdir(work / "checkpoints")) == [
        "ckpt_1.pkl", "ckpt_2.pkl", "swa_1-2.pkl"]
    assert (tmp_path / "val_work" / "detections" / "val_2" /
            "val.pkl").exists()
    log = (work / "log.txt").read_text()
    assert "loss_rpn_bbox:" in log and "lr:" in log


def test_train_needs_a_card_by_default(trained, tmp_path, monkeypatch):
    """``Runner()`` with a train dataset raises where there is no card,
    as for the test task; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    monkeypatch.chdir(tmp_path)
    _use(get_cfg, tiny_train_config(trained["ds"], str(tmp_path / "work")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner()


def test_serving_cast_then_train_raises(trained, tmp_path):
    """After ``test`` cast the parameters to bf16 to serve, ``train``
    refuses instead of training rounded weights."""
    model = dict(tiny_train_config("", "")["model"],
                 compute_dtype="bfloat16")
    _use(get_cfg, tiny_train_config(trained["ds"], str(tmp_path / "w"),
                                    model=model))
    pr = Runner(device="cpu")
    pr.predict(*next(iter(pr.val_dataset.batches()))[:2])
    with pytest.raises(RuntimeError, match="master weights"):
        pr.train()


def test_profile_step_writes_a_trace(trained, tmp_path):
    pr = port_run(tmp_path / "work", trained["ds"], trained["weights"],
                  profile_step=1)
    assert (tmp_path / "work" / "profile" / "trace.json").stat().st_size > 0
    assert pr.iter == 4


def _fair_xml(path, objs):
    body = "".join(
        "<object><possibleresult><name>{}</name></possibleresult><points>"
        "{}</points></object>".format(
            name, "".join(f"<point>{x:.1f},{y:.1f}</point>"
                          for x, y in poly.reshape(4, 2)))
        for name, poly in objs)
    with open(path, "w") as f:
        f.write(f"<annotation><objects>{body}</objects></annotation>")


def test_val_tool_matches_jax(tmp_path):
    """``tools/val.py`` on a seeded submission CSV against a directory
    of ground-truth XML: the port's per-class APs and mean equal the JAX
    tool's to 1e-12."""
    from rs_detection_tpu_torch.config.constant import FAIR1M_1_5_CLASSES
    from rs_detection_tpu_torch.ops.box_ops import rotated_box_to_poly_np
    from rs_detection_tpu_torch.tools import val as port_val

    rng = np.random.RandomState(13)
    xml_dir = tmp_path / "xml"
    xml_dir.mkdir()
    rows = []
    for i in range(4):
        r = np.stack([rng.uniform(50, 450, 8), rng.uniform(50, 450, 8),
                      rng.uniform(10, 60, 8), rng.uniform(5, 30, 8),
                      rng.uniform(-0.7, 2.3, 8)], 1)
        polys = rotated_box_to_poly_np(r).astype(np.float64)
        names = [FAIR1M_1_5_CLASSES[k] for k in rng.randint(0, 4, 8)]
        _fair_xml(xml_dir / f"{i}.xml", list(zip(names, polys)))
        for name, p in zip(names, polys):
            for _ in range(2):
                q = p + rng.uniform(-3, 3, 8)
                rows.append(f"{i}.tif,{name},{rng.rand():.4f},"
                            + ",".join(f"{v:.2f}" for v in q))
        rows.append(f"{i}.tif,{FAIR1M_1_5_CLASSES[5]},0.5,"
                    + ",".join(f"{v:.2f}" for v in polys[0]))
    csv = tmp_path / "sub.csv"
    csv.write_text("\n".join(rows) + "\n")
    got = port_val.evaluate(str(csv), str(xml_dir))
    ref = _jax_tool("val").evaluate(str(csv), str(xml_dir))
    assert list(got) == list(ref) and len(got) == 11
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-12, k
    assert got["meanAP"] > 0
    assert port_val.main(["--csv", str(csv), "--gt_xml_dir",
                          str(xml_dir)]) == got
