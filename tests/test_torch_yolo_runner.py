"""The per-step EMA through the port's runner against the JAX package,
CPU, f32: the narrow YOLO of ``tests/test_torch_yolo_cuda.py`` trained by
``Runner.run`` over two noise tiles (a ``YoloDataset``, letterboxed
128^2 -> 128^2, batch 1) under the COCO recipe's optimizer (nesterov
SGD), ``CosineAnnealingLRGroup`` and ``YoloParameterGroupsGenerator``,
with ``model.ema`` (decay 0.9), from one JAX-format checkpoint at step
2000 (so that the EMA's ramp ``1 - exp(-(step + 1) / 2000)`` is 0.63 and
the average stands apart from the parameters); the JAX
``make_train_step(ema_decay=0.9)`` from the same state over the same
batches. Then a resume from the port's pickle against the unbroken run,
a JAX runner's pickle of the EMA run (``Runner.save``'s own code) loaded
into the port, ``Runner.val`` reading the EMA and ``get_swa_model``
averaging it. One JAX compile: the
training step at batch 1 (the JAX loss runs only there,
``tests/test_torch_yolo_networks.py``)."""

import copy
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.optims import optimizer as _joptim  # noqa: F401
from rs_detection_tpu.parallel import train_step as jts
from rs_detection_tpu.runner import runner as jrunner
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.models.networks.yolo import YOLOv5Head
from rs_detection_tpu_torch.runner import Runner
from rs_detection_tpu_torch.tools.get_swa_model import average_checkpoints
from rs_detection_tpu_torch.utils.checkpoint import FORMAT
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      load_jax_checkpoint)
from test_torch_fcos_networks import one_thread
from test_torch_ssd_cuda import render_coco
from test_torch_yolo_cuda import IMG, tiny_inputs, tiny_model
from test_torch_yolo_networks import variables

START, DECAY = 2000, 0.9
SGD = dict(type="SGD", lr=0.01, momentum=0.937, nesterov=True)
SCHED = dict(type="CosineAnnealingLRGroup", max_steps=2, min_lr_ratio=0.2,
             warmup="linear", warmup_iters=3, warmup_ratio=0.1,
             warmup_init_lr_pg=[0.0, 0.0, 0.1], warmup_initial_momentum=0.8)
LOSSES = ("box_loss", "obj_loss", "cls_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def _use(cfg):
    c = get_cfg()
    c.clear()
    c.update(copy.deepcopy(cfg))


def write_dataset(root):
    """``tiny_inputs``' two noise tiles and their boxes as a ``labels.pkl``
    dataset (``images/``, hbbs, labels 1-4)."""
    tiles, t = tiny_inputs()
    os.makedirs(root / "images")
    infos = []
    for i, tile in enumerate(tiles.numpy()):
        Image.fromarray(tile).save(root / "images" / f"tile_{i}.png")
        m = t["gt_mask"][i].numpy()
        infos.append(dict(filename=f"tile_{i}.png", width=IMG, height=IMG,
                          ann=dict(hboxes=t["hboxes"][i].numpy()[m],
                                   labels=t["labels"][i].numpy()[m])))
    with open(root / "labels.pkl", "wb") as f:
        pickle.dump(infos, f)
    return str(root)


def train_cfg(ds, work, max_epoch=2, resume=None):
    return dict(
        name="yolo_ema", work_dir=str(work), seed=3, max_epoch=max_epoch,
        log_interval=1, checkpoint_interval=1,
        model=dict(tiny_model(), ema_decay=DECAY), resume_path=resume,
        optimizer=SGD, scheduler=SCHED,
        parameter_groups_generator=dict(type="YoloParameterGroupsGenerator",
                                        batch_size=1, weight_decay=0.0005),
        dataset=dict(train=dict(type="YoloDataset", dataset_dir=ds,
                                img_size=IMG, batch_size=1, mosaic=False,
                                hsv=False, flip=False, shuffle=False,
                                max_gt=6),
                     val=None, test=None))


def port_run(cfg):
    _use(cfg)
    runner = Runner(device="cpu")
    runner.run()
    return runner


def jax_steps(jm, v, batches):
    """The JAX training step with the EMA (``make_train_step(ema_decay=
    DECAY)``, optax SGD on the JAX runner's schedule) from ``v`` at step
    ``START``, the EMA a copy of the parameters, over ``batches``: the
    per-step losses and the final state."""
    opt = dict(SGD)
    schedule = jrunner._build_scheduler(SCHED, 2)
    opt["lr"] = lambda step: SGD["lr"] * schedule(step)
    tx = jreg.build_from_cfg(opt, jreg.OPTIMS)
    state = jts.create_train_state(
        jm, jax.tree_util.tree_map(jnp.asarray, v), tx, ema=True)
    state = state._replace(step=jnp.asarray(START, jnp.int32))
    step = jts.make_train_step(jm, tx, donate=False, ema_decay=DECAY)
    losses = []
    for images, t, _ in batches:
        jt = dict(hboxes=t["hboxes"], gt_mask=t["gt_mask"],
                  labels=t["labels"])
        state, metrics = step(state, jnp.asarray(images), jt,
                              jax.random.PRNGKey(3))
        losses.append({k: float(v) for k, v in metrics.items()})
    return losses, state


def jax_save(state, work, it):
    """The JAX runner's ``save`` of ``state`` (its own code, on a stand-in
    runner): returns the pickle's path."""
    stub = types.SimpleNamespace(
        cfg=types.SimpleNamespace(use_orbax=None, dump=lambda: {}),
        work_dir=str(work), epoch=2, iter=it, max_epoch=2,
        _swa_active=False, state=state,
        logger=types.SimpleNamespace(print_log=lambda *_: None))
    stub._variables = lambda use_ema=True: jrunner.Runner._variables(
        stub, use_ema)
    return jrunner.Runner.save(stub)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("yolo_ema")
    ds = write_dataset(root / "ds")
    jm = jreg.build_from_cfg(tiny_model(), jreg.MODELS)
    v = variables(jm, (1, IMG, IMG, 3))
    start = root / "start.pkl"
    with open(start, "wb") as f:
        pickle.dump(dict(meta=dict(epoch=0, iter=START), model=v,
                         opt_state=None, ema=v["params"]), f)
    torch.use_deterministic_algorithms(True)
    try:
        unbroken = port_run(train_cfg(ds, root / "unbroken",
                                      resume=str(start)))
        first = port_run(train_cfg(ds, root / "broken", max_epoch=1,
                                   resume=str(start)))
        resumed = port_run(train_cfg(ds, root / "broken"))
    finally:
        torch.use_deterministic_algorithms(False)
    batches = [b for e in range(2)
               for b in unbroken.train_dataset.batches(seed=e)]
    jax_losses, state = jax_steps(jm, v, batches)
    return dict(root=root, ds=ds, v=v, unbroken=unbroken, first=first,
                resumed=resumed, batches=batches, jax_losses=jax_losses,
                state=state)


def _params(runner):
    return {n: p.detach().numpy().copy()
            for n, p in runner.model.named_parameters()}


def _ema(runner):
    return {n: s.numpy().copy()
            for n, s in zip(runner.ema.names, runner.ema.shadow)}


def _tree(tree):
    return jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                               tree)})


def test_ema_steps_match_make_train_step(runs):
    """4 steps of ``Runner.run`` from step 2000: each step's three losses
    within 1e-5 relative of the JAX step's, the parameters and the EMA
    after them within 1e-5 of their largest entry of JAX's
    ``state.params`` and ``state.ema_params``; the EMA stands more than
    1e-3 (of the largest entry) from the parameters on some tensor, so
    an average that followed the parameters would fail."""
    runner = runs["unbroken"]
    assert (runner.epoch, runner.iter) == (2, START + 4)
    assert len(runner.history) == len(runs["jax_losses"]) == 4
    for rec, ref in zip(runner.history, runs["jax_losses"]):
        for k in LOSSES:
            assert abs(rec[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, rec, ref)
    want_p, want_e = _tree(runs["state"].params), _tree(runs["state"].ema_params)
    got_p, got_e = _params(runner), _ema(runner)
    assert set(got_p) == set(want_p) == set(got_e) == set(want_e)
    apart = 0.0
    for n in want_p:
        scale = np.abs(want_p[n]).max()
        np.testing.assert_allclose(got_p[n], want_p[n], rtol=0,
                                   atol=1e-5 * scale, err_msg=n)
        np.testing.assert_allclose(got_e[n], want_e[n], rtol=0,
                                   atol=1e-5 * np.abs(want_e[n]).max(),
                                   err_msg=n)
        apart = max(apart, np.abs(got_e[n] - got_p[n]).max() / scale)
    assert apart > 1e-3


def test_resume_from_the_ports_pickle_equals_unbroken(runs):
    """2 steps, ``save`` (the parameters under ``model``, the EMA apart
    under ``ema``), a new Runner resuming from the work directory, 2
    more: the step count, the rates and, bit for bit, the parameters and
    the EMA of the unbroken run."""
    first, resumed, unbroken = runs["first"], runs["resumed"], runs["unbroken"]
    path = os.path.join(first.work_dir, "checkpoints", "ckpt_1.pkl")
    with open(path, "rb") as f:
        data = pickle.load(f)
    assert data["meta"]["format"] == FORMAT and data["meta"]["iter"] == \
        START + 2
    first_p, first_e = _params(first), _ema(first)
    for n, a in data["ema"].items():
        np.testing.assert_array_equal(a, first_e[n])
        np.testing.assert_array_equal(data["model"][n], first_p[n])
    assert (resumed.epoch, resumed.iter) == (2, START + 4)
    assert [r["lr"] for r in resumed.history] == \
        [r["lr"] for r in unbroken.history[2:]]
    for got, want in ((_params(resumed), _params(unbroken)),
                      (_ema(resumed), _ema(unbroken))):
        for n, a in want.items():
            np.testing.assert_array_equal(got[n], a, err_msg=n)


def test_a_jax_pickle_of_an_ema_run_loads_as_jax_resumes(runs, tmp_path):
    """Quirk 8: the JAX runner's ``save`` of the EMA run writes the EMA as
    its ``model`` and again as its ``ema`` (``_variables()`` defaults to
    the EMA), the parameters nowhere. A JAX resume from it
    (``Runner.load``) trains on from the EMA: its pending variables and
    its pending EMA are both the EMA. The port loads it into that state:
    parameters and EMA both JAX's EMA, the step count restored."""
    state = runs["state"]
    path = jax_save(state, tmp_path / "jax", START + 4)
    data = load_jax_checkpoint(path)
    ema = _tree(state.ema_params)
    raw = _tree(state.params)
    model = jax_to_state_dict(dict(params=data["model"]["params"]))
    for n, a in ema.items():
        np.testing.assert_array_equal(model[n], a)
        np.testing.assert_array_equal(_tree(data["ema"])[n], a)
    assert any(not np.array_equal(ema[n], raw[n]) for n in ema)
    stub = types.SimpleNamespace(
        tx_swa=None, logger=types.SimpleNamespace(print_log=lambda *_: None))
    jrunner.Runner.load(stub, path)
    pending_p = jax_to_state_dict(dict(params=stub._pending_variables[
        "params"]))
    pending_e = _tree(stub._pending_ema)
    cfg = train_cfg(runs["ds"], tmp_path / "port", resume=path)
    _use(cfg)
    port = Runner(device="cpu")
    assert (port.epoch, port.iter) == (2, START + 4)
    got_p, got_e = _params(port), _ema(port)
    for n, a in ema.items():
        np.testing.assert_array_equal(got_p[n], pending_p[n])
        np.testing.assert_array_equal(got_e[n], pending_e[n])
        np.testing.assert_array_equal(got_p[n], a)


def test_val_reads_the_ema(runs, monkeypatch, tmp_path):
    """``Runner.val`` of a runner resumed from the unbroken run's
    checkpoint (the port's pickle) over a rendered COCO val set: the head
    predicts with the EMA's weights, and after val the parameters are
    the run's own again (bit for bit), the model back in its mode."""
    unbroken = runs["unbroken"]
    img_dir, ann = render_coco(str(tmp_path / "val"), n=2, size=IMG)
    cfg = train_cfg(runs["ds"], tmp_path / "val_work",
                    resume=os.path.join(unbroken.work_dir, "checkpoints",
                                        "ckpt_2.pkl"))
    cfg["dataset"]["val"] = dict(type="COCODataset", images_dir=img_dir,
                                 annotations_file=ann, img_size=IMG,
                                 batch_size=2)
    _use(cfg)
    runner = Runner(device="cpu")
    seen = []

    def record(self, preds, scale_factor=None):
        seen.append(self.out0.weight.detach().clone())
        b = preds[0].shape[0]
        return dict(polys=torch.zeros(b, 1, 8), scores=torch.zeros(b, 1),
                    labels=torch.full((b, 1), -1),
                    valid=torch.zeros(b, 1, dtype=torch.bool))

    monkeypatch.setattr(YOLOv5Head, "get_bboxes", record)
    before = _params(runner)
    runner.model.train()
    aps = runner.val()
    assert "eval/mAP" in aps and len(seen) == 1
    ema = _ema(unbroken)["bbox_head.out0.weight"]
    np.testing.assert_array_equal(seen[0].numpy(), ema)
    assert not np.array_equal(ema, before["bbox_head.out0.weight"])
    assert runner.model.training
    for n, a in _params(runner).items():
        np.testing.assert_array_equal(a, before[n])


def test_swa_average_of_an_ema_run_averages_the_ema(runs):
    """``get_swa_model`` over the unbroken run's two checkpoints (the
    port's pickles, each with its EMA apart) averages their EMAs, which
    is what the JAX tool averages of a JAX EMA run (its ``model``)."""
    ckpts = os.path.join(runs["unbroken"].work_dir, "checkpoints")
    paths = [os.path.join(ckpts, f"ckpt_{e}.pkl") for e in (1, 2)]
    emas = []
    for p in paths:
        with open(p, "rb") as f:
            emas.append(pickle.load(f)["ema"])
    avg = average_checkpoints(paths)["model"]
    assert any(not np.array_equal(emas[0][n], emas[1][n]) for n in emas[0])
    for n in emas[0]:
        np.testing.assert_array_equal(
            avg[n], np.mean(np.stack([emas[0][n], emas[1][n]]), 0))
