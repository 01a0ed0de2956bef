"""The port's runner on ``tests/test_runner.py:_tiny_cfg`` (Resnet18
Oriented R-CNN trained by SGD with momentum, the global-norm clip and a
StepLR warm-up) against the JAX runner: losses and parameters over 4
steps from the same weights on the 4 rendered tiles of
``tests/test_map_pipeline.py:render_dataset``; 2 steps, a save, a resume
and 2 more against 4 unbroken, bit for bit, with the SGD momentum in the
checkpoint; and the JAX runner's epoch-1 checkpoint resumed in the port
with its optax trace as the momentum. Both samplers take every candidate,
so the two frameworks sample the same sets. CPU, f32.

The runners train the backbone as the zoo's ResNet configs do
(``frozen_stages=1``, ``norm_eval=True``). ``_tiny_cfg`` as written
(``norm_eval=False``) trains its norms on batch statistics, and there the
f32 gradients of both frameworks are percent-level off their f64 values
in some backbone tensors (flax's BatchNorm backward up to 7%, torch's
2%; measured), so 4 f32 steps are no test of either;
``test_tiny_cfg_first_step_in_f64`` holds the port to the JAX package on
that model in f64 (``tests/test_torch_resnet.py`` does so for the
backbone's training steps)."""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.runner.runner as jrunner
from rs_detection_tpu.config import get_cfg as jget_cfg
from rs_detection_tpu.parallel.train_step import (create_train_state,
                                                  make_train_step)
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.runner import Runner
from rs_detection_tpu_torch.utils.jax_weights import jax_to_state_dict
from test_map_pipeline import render_dataset
from test_torch_overfit_map import tiny_cfg
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

# >= the 4092 anchors of a 128^2 tile (3 ratios); nms_post + max_gt
RPN_TAKE_ALL = 4096
HEAD_TAKE_ALL = 32 + 8
# per step: warmup 0.25 -> 1 over 4 iterations
WANT_LRS = [0.01 * (0.25 + 0.75 * i / 4) for i in range(4)]


def parity_cfg(ds, work_dir, max_iter, **extra):
    c = tiny_cfg(ds, work_dir, max_iter=max_iter)
    c["model"]["backbone"] = dict(type="Resnet18", frozen_stages=1,
                                  norm_eval=True)
    c["model"]["rpn"]["sampler"] = dict(num=RPN_TAKE_ALL, pos_fraction=1.0)
    c["model"]["bbox_head"]["sampler"] = dict(
        num=HEAD_TAKE_ALL, pos_fraction=1.0, add_gt_as_proposals=True)
    c["log_interval"] = 1
    c.update(extra)
    return c


def _use(getter, cfg):
    c = getter()
    c.clear()
    c.update(copy.deepcopy(cfg))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX runner's 4 steps (a checkpoint an epoch of 2 steps) and
    the port's from the same weights (the JAX init, perturbed)."""
    root = tmp_path_factory.mktemp("resnet_runner")
    ds = render_dataset(str(root / "ds"))
    mp = pytest.MonkeyPatch()
    records = []
    try:
        _use(jget_cfg, parity_cfg(ds, str(root / "jax"), max_iter=4))
        jr = jrunner.Runner()
        images, targets, _ = next(iter(jr.train_dataset.batches()))
        init = jax.jit(lambda i, t: jr.model.init(
            {"params": jax.random.PRNGKey(3),
             "sampler": jax.random.PRNGKey(1)}, i, t))
        weights = perturb(init(jnp.asarray(images[:1]), {
            k: jnp.asarray(v[:1]) for k, v in targets.items()}), seed=7)
        with open(root / "weights.pkl", "wb") as f:
            pickle.dump(weights, f)
        dev = jax.devices()[0]
        jr.state = jax.device_put(create_train_state(
            jr.model, jax.tree_util.tree_map(jnp.asarray, weights), jr.tx),
            dev)
        jr._train_step = make_train_step(jr.model, jr.tx, mesh=jr.mesh)
        log = jr.logger.log
        mp.setattr(jr.logger, "log", lambda d: (records.append(d), log(d)))
        while not jr.finish:
            jr.train()
            jr.save()
    finally:
        mp.undo()
    ref = jax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                   jr._variables()))
    port = port_run(root / "port", ds, root / "weights.pkl", max_iter=4)
    return dict(ds=ds, weights=str(root / "weights.pkl"), jax_records=records,
                jax_params=ref, jax_ckpts=str(root / "jax" / "checkpoints"),
                start=jax_to_state_dict(weights), port=port)


def port_run(work, ds, weights, max_iter, **extra):
    torch.use_deterministic_algorithms(True)
    try:
        _use(get_cfg, parity_cfg(ds, str(work), max_iter=max_iter,
                                 pretrained_weights=str(weights), **extra))
        runner = Runner(device="cpu")
        runner.run()
    finally:
        torch.use_deterministic_algorithms(False)
    return runner


def _params(runner):
    return {k: v.detach().float().numpy()
            for k, v in runner.model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _assert_params_near_jax(got, ref, start):
    """Each parameter tensor within 1e-6 plus 3% of the largest distance
    its 4 SGD steps moved it in JAX (measured 1.1%: in f32 some backbone
    gradients of the port carry 1e-3 of rounding, the JAX ones 4e-6,
    against the port's f64 gradients); the running statistics equal
    (every norm runs on them)."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        d = np.abs(got[k] - r).max()
        moved = np.abs(r - start[k]).max()
        if k.endswith(("running_mean", "running_var")):
            assert d == 0.0 and moved == 0.0, k
            continue
        assert d <= 1e-6 + 0.03 * moved, (k, d, moved)


def test_losses_and_rates_match_jax(trained):
    """Each step's rate exactly (the warm-up by SGD's own count), its
    losses to 2e-3 relative (the AdamW runner test's bound), both bbox
    losses nonzero."""
    got, ref = trained["port"].history, trained["jax_records"]
    assert len(got) == len(ref) == 4
    np.testing.assert_allclose([r["lr"] for r in got], WANT_LRS, rtol=1e-12)
    for g, r in zip(got, ref):
        assert (g["epoch"], g["iter"]) == (r["epoch"], r["iter"])
        for k, v in r.items():
            if "loss" in k:
                assert abs(g[k] - v) <= 2e-3 * max(abs(v), 0.1), (k, g[k], v)
        assert r["loss_rpn_bbox"] > 0 and r["orcnn_bbox_loss"] > 0


def test_parameters_match_jax(trained):
    _assert_params_near_jax(_params(trained["port"]), trained["jax_params"],
                            trained["start"])


def test_checkpoint_holds_the_sgd_momentum(trained):
    """The port's checkpoint: SGD's momentum buffer for every parameter,
    its count, f32 arrays."""
    pr = trained["port"]
    with open(os.path.join(pr.work_dir, "checkpoints", "ckpt_2.pkl"),
              "rb") as f:
        data = pickle.load(f)
    opt = data["opt_state"]
    assert opt["iterations"] == 4
    names = {n for n, _ in pr.model.named_parameters()}
    assert set(opt["state"]) == names
    for name, p in pr.model.named_parameters():
        s = opt["state"][name]
        assert set(s) == {"momentum_buffer"}
        np.testing.assert_array_equal(
            s["momentum_buffer"],
            pr.optimizer.state[p]["momentum_buffer"].numpy())


def test_resume_with_sgd_momentum_equals_unbroken(trained, tmp_path):
    """2 steps, a new Runner resuming from the newest checkpoint (epoch,
    iteration, momentum buffers and count), 2 more: bit for bit the
    unbroken run's parameters and rates."""
    work = tmp_path / "work"
    first = port_run(work, trained["ds"], trained["weights"], max_iter=2)
    assert first.optimizer.iterations == 2
    second = port_run(work, trained["ds"], trained["weights"], max_iter=4)
    assert (second.epoch, second.iter) == (2, 4)
    assert [r["lr"] for r in second.history] == \
        [r["lr"] for r in trained["port"].history][2:]
    ref = _params(trained["port"])
    for k, v in _params(second).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_jax_sgd_checkpoint_resumes_with_its_momentum(trained, tmp_path):
    """The JAX runner's epoch-1 checkpoint: the port takes its epoch,
    iteration, schedule count and optax trace (``jax_sgd_state``) as the
    momentum buffers, then 2 more steps land on the JAX runner's 4-step
    parameters."""
    path = os.path.join(trained["jax_ckpts"], "ckpt_1.pkl")
    with open(path, "rb") as f:
        data = pickle.load(f)
    found = []

    def find(node):
        if isinstance(node, dict):
            if "trace" in node:
                found.append(node["trace"])
            for v in node.values():
                find(v)
    find(data["opt_state"])
    trace = jax_to_state_dict({"params": found[0]})
    _use(get_cfg, parity_cfg(trained["ds"], str(tmp_path / "work"),
                             max_iter=4, resume_path=path))
    pr = Runner(device="cpu")
    assert (pr.epoch, pr.iter, pr.optimizer.iterations) == (1, 2, 2)
    for name, p in pr.model.named_parameters():
        np.testing.assert_array_equal(
            pr.optimizer.state[p]["momentum_buffer"].numpy(), trace[name])
    pr.run()
    np.testing.assert_allclose([r["lr"] for r in pr.history], WANT_LRS[2:],
                               rtol=1e-12)
    _assert_params_near_jax(_params(pr), trained["jax_params"],
                            trained["start"])


def _padded_targets():
    """Two 128^2 images' ground truths in 8 slots (the dataset's
    ``max_gt``)."""
    rboxes = np.zeros((2, 8, 5), np.float32)
    rboxes[:, :2] = [[[40, 40, 30, 14, 0.4], [80, 90, 36, 12, -0.5]],
                     [[60, 60, 30, 16, 1.0], [30, 90, 28, 14, 0.1]]]
    gt_mask = np.zeros((2, 8), bool)
    gt_mask[:, :2] = True
    labels = np.zeros((2, 8), np.int32)
    labels[:, :2] = [[1, 2], [2, 1]]
    return dict(rboxes=rboxes, gt_mask=gt_mask, labels=labels,
                img_hw=np.full((2, 2), 128.0, np.float32))


def test_tiny_cfg_first_step_in_f64():
    """``_tiny_cfg``'s model as written (norms on batch statistics), one
    training forward and backward from the same weights with both sides
    in f64 (the heads keep their f32 logits and losses, by design, on
    both): the four losses to 1e-6 relative (or of 0.1 for a smaller
    one) and every parameter's gradient to 1e-5 of its largest (measured
    5e-7). In f32 both sides' backbone gradients are percent-level off
    the f64 ones (flax's BatchNorm backward up to 7%, torch's 2%;
    measured), which is why the runners above freeze the norms."""
    import rs_detection_tpu.models  # noqa: F401
    from rs_detection_tpu.utils import registry as jreg
    from rs_detection_tpu_torch.utils import registry as reg
    from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables

    model = tiny_cfg("", "", 4)["model"]
    model["rpn"]["sampler"] = dict(num=RPN_TAKE_ALL, pos_fraction=1.0)
    model["bbox_head"]["sampler"] = dict(
        num=HEAD_TAKE_ALL, pos_fraction=1.0, add_gt_as_proposals=True)
    jm = jreg.build_from_cfg(copy.deepcopy(model), jreg.MODELS)
    x = np.random.RandomState(0).randn(2, 128, 128, 3).astype(np.float32)
    t = _padded_targets()
    v = perturb(jax.jit(lambda i, tt: jm.init(
        {"params": jax.random.PRNGKey(3), "sampler": jax.random.PRNGKey(1)},
        i, tt))(jnp.asarray(x), {k: jnp.asarray(a) for k, a in t.items()}),
        seed=7)
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), tree)

        jt = {k: jnp.asarray(a, jnp.float64) if a.dtype == np.float32
              else jnp.asarray(a) for k, a in t.items()}

        def loss(p, bs):
            out, _ = jm.apply({"params": p, **bs}, jnp.asarray(x, jnp.float64),
                              jt, method=jm.loss, mutable=["batch_stats"],
                              rngs={"sampler": jax.random.PRNGKey(2)})
            return sum(a for k, a in out.items() if "loss" in k), out

        (_, jout), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            f64(v["params"]), {"batch_stats": f64(v["batch_stats"])})
        jout = {k: float(a) for k, a in jout.items()}
        jgrad = jax_to_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, jgrad)})
    pm = load_jax_variables(reg.build_from_cfg(copy.deepcopy(model),
                                               reg.MODELS), v)
    pm.double().train()
    tt = {k: torch.from_numpy(a) for k, a in t.items()}
    tt["rboxes"] = tt["rboxes"].double()
    out = pm.loss(torch.from_numpy(x).double(), tt,
                  torch.Generator().manual_seed(0))
    sum(a for k, a in out.items() if "loss" in k).backward()
    for k, r in jout.items():
        assert abs(out[k].item() - r) <= 1e-6 * max(abs(r), 0.1), k
    for k, p in pm.named_parameters():
        r = jgrad[k]
        assert np.abs(p.grad.numpy() - r).max() <= 1e-5 * np.abs(r).max(), k


@pytest.mark.slow
def test_jax_overfit_aps_for_the_record(tmp_path, monkeypatch):
    """The JAX package's own overfit test body
    (``tests/test_map_pipeline.py:test_orcnn_overfits_to_real_detections``,
    up to its val) on the CPU, printing the per-class APs it gates, to
    stand beside the port's (``tests/test_torch_overfit_map.py``)."""
    import rs_detection_tpu.data  # noqa: F401
    import rs_detection_tpu.models  # noqa: F401
    from test_torch_overfit_map import class_aps, overfit_cfg, scene_tiles

    monkeypatch.chdir(tmp_path)
    ds_dir = render_dataset(str(tmp_path / "ds"))
    _use(jget_cfg, overfit_cfg(ds_dir, str(tmp_path / "w"),
                               scene_tiles(ds_dir, str(tmp_path))))
    runner = jrunner.Runner()
    for _ in range(200):
        runner.train()
    aps = class_aps(runner.val())
    print("JAX overfit on the CPU:", aps)
    assert all(v >= 0.3 for v in aps.values()), aps
