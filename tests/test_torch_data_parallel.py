"""Data parallel in the port (``parallel/dist.py``): a step over two
gloo processes on the CPU against one process on the global batch.

Each case runs its task in the test's process on the whole batch and in
two spawned processes (``tests/torch_dp_children.py``), each on its
rows, with a time limit:

* one AdamW step of the tiny Oriented R-CNN on 4 images with the real
  samplers (each rank draws at the global batch's shape and keeps its
  rows) and DropPath at 0.2 (the global batch's mask): losses,
  gradients, parameters and the BN running statistics (the global
  batch's, through the ranks' summed moments);
* ``make_eval_step`` on 3 images (one rank pads a copy of the last);
* one SGD step of the tiny S2ANet (ResNet-18 with the zoo's frozen
  first stage), FCOS, SSD and YOLOv5, whose losses divide by counts over
  the batch (SSD's mined negatives are the global batch's);
* ``run_net --task train`` (two steps, the loader's threads reading
  each rank's rows) and its val, under torchrun's environment.

f32 throughout. The two sides sum in other orders (the ranks' halves,
then the collective), so they agree to rounding: 1e-5 of a leaf's
largest magnitude. A conv bias ahead of a BatchNorm has a zero gradient
up to rounding (the batch mean removes it), so its AdamW step may go
either way: its parameters are held to 2 lr, as in
``tests/test_torch_port_train_step.py``. The two ranks hold the same
parameters bit for bit."""

import os

import numpy as np
import pytest

from torch_one_thread import _one_thread  # noqa: F401
from torch_dp_children import TASKS, make_run, orcnn_step, run_world

TOL = 1e-5
LR = 1e-4 / 3                 # the first warmup step's rate


STEP = dict(n=4, drop_path=0.2, take_all=False)
FAMILIES = ["s2anet", "fcos", "ssd", "yolo"]
TASK_IDS = ["orcnn_step"] + FAMILIES


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(one process, [rank 0, rank 1]) of the step and eval tasks."""
    calls = [("orcnn_step", STEP), ("orcnn_eval", {})] + [
        ("family_step", dict(family=f)) for f in FAMILIES]
    one = [TASKS[name](**kw) for name, kw in calls]
    two = run_world("several", 2, dict(calls=calls),
                    tmp_path_factory.mktemp("dp"))
    names = ["orcnn_step", "orcnn_eval"] + FAMILIES
    return dict(zip(names, one)), [dict(zip(names, r)) for r in two]


def _before_bn(name):
    return name.startswith("backbone.patch_embed") and name.endswith(
        "proj.bias")


def _close(a, b, tol=TOL, floor=1e-12):
    scale = max(np.abs(a).max(), np.abs(b).max(), floor)
    return float(np.abs(a - b).max()) / scale <= tol


@pytest.mark.parametrize("task", TASK_IDS)
def test_losses_equal_one_process(worlds, task):
    one, two = worlds
    ref = one[task]["losses"]
    assert ref["total_loss"] > 0
    for r in two:
        got = r[task]["losses"]
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert abs(got[k] - v) <= TOL * max(abs(v), 1.0), (k, got[k], v)


@pytest.mark.parametrize("task", TASK_IDS)
def test_gradients_equal_one_process(worlds, task):
    """The ranks' averaged (and clipped) gradients are the global batch's;
    the frozen ResNet stage's are zero on every rank."""
    one, two = worlds
    ref = one[task]["grads"]
    nonzero = 0
    for k, g in ref.items():
        got = two[0][task]["grads"][k]
        if _before_bn(k):
            assert max(np.abs(g).max(), np.abs(got).max()) < 1e-6, k
            continue
        assert _close(got, g), k
        nonzero += np.abs(g).max() > 0
    assert nonzero >= 0.5 * len(ref)
    if task == "s2anet":
        frozen = [k for k in ref if k.startswith("backbone.layer1_")]
        assert frozen and all(not np.abs(ref[k]).any() and
                              not np.abs(two[1][task]["grads"][k]).any()
                              for k in frozen)


@pytest.mark.parametrize("task", TASK_IDS)
def test_updated_parameters_equal_one_process(worlds, task):
    """After the optimizer's step (AdamW, SGD); identical on the ranks. An
    AdamW step moves a weight by about lr * sign(grad), so where a
    gradient is noise (under 1e-3 of its leaf's scale) the sides may
    step opposite ways: there the bound is 2 lr, elsewhere 1e-6."""
    one, two = worlds
    for k, p in one[task]["params"].items():
        got = two[0][task]["params"][k]
        assert np.array_equal(got, two[1][task]["params"][k]), k
        g = one[task]["grads"][k]
        diff = np.abs(got - p)
        assert diff.max() <= 2 * LR + 1e-6, (k, diff.max())
        sure = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-12)
        if not _before_bn(k):
            assert (diff[sure] <= 1e-6).all(), (k, diff[sure].max())


@pytest.mark.parametrize("task", [t for t in TASK_IDS if t != "ssd"])
def test_bn_statistics_equal_one_process(worlds, task):
    """The running statistics moved toward the global batch's mean and
    biased variance (absolute, over a unit floor: a mean after a norm is
    ~1e-9). SSD's VGG-16 has no norm."""
    one, two = worlds
    stats = one[task]["stats"]
    assert stats
    for k, v in stats.items():
        got = two[0][task]["stats"][k]
        assert np.array_equal(got, two[1][task]["stats"][k]), k
        assert np.abs(got - v).max() <= TOL * max(np.abs(v).max(), 1.0), k


def test_sampling_and_drop_path_are_live(worlds):
    """The step above sampled (the real samplers keep a subset) and
    dropped paths: without either the gradients move. (The random RPN
    scores every anchor near logit 0, so its loss is ln 2 whichever
    anchors are drawn; their gradients differ.)"""
    one, _ = worlds
    ref = one["orcnn_step"]["grads"]
    for kw in (dict(take_all=True), dict(drop_path=0.0)):
        other = orcnn_step(**dict(STEP, **kw))["grads"]
        assert not _close(other["bbox_head.fc_cls.weight"],
                          ref["bbox_head.fc_cls.weight"], tol=1e-2), kw


def test_eval_step_on_an_uneven_batch_equals_predict(worlds):
    """3 images over 2 ranks (the second pads a copy): the gathered dense
    outputs equal one process's ``predict``."""
    one, two = worlds
    ref = one["orcnn_eval"]
    for r in two:
        got = r["orcnn_eval"]
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
            if v.dtype == bool:
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-4,
                                           err_msg=k)
    assert ref["valid"].any()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``run_net --task train --cpu`` of ``make_run``'s config in one
    process, in two and in three (torchrun's environment, gloo)."""
    root = tmp_path_factory.mktemp("dp_run")
    out = {}
    for world in (1, 2, 3):
        work = root / f"w{world}"
        cfg = make_run(str(root), work)
        d = root / f"procs{world}"
        d.mkdir()
        out[world] = (run_world("run_net", world, dict(argv=[
            "--config-file", cfg, "--task", "train", "--cpu"]), d), work, d)
    return out


def test_run_net_two_ranks_equals_one_process(runs):
    """Loss history (two steps) and the val APs as one process's; the
    last step's gradients to 1e-5 of a leaf's scale; the parameters
    within 2 lr a step, and where the last gradient is not noise (over
    1e-3 of its leaf's scale) within lr / 10, and all but 1e-4 of those
    within 1e-6 (an element whose first gradient was noise took another
    first step: Adam's ratio near its epsilon); bit for bit the same on
    the two ranks (their sha256). One tile is wider than the others, so
    a rank's own rows collate smaller than the global batch: the runner
    pads them to its shape and the RPN takes the global batch's border."""
    (one,), _, _ = runs[1]
    two, _, _ = runs[2]
    _check_against_one_process(one, two)


def test_run_net_three_ranks_on_a_batch_of_four(runs):
    """Three ranks on a global batch of 4 train as the JAX runner does,
    on the most ranks that divide the batch: ranks 0 and 1 step on two
    rows each, as two ranks do (the same bounds against one process),
    rank 2 takes no rows and logs nothing, and after the run (its val
    over all three ranks, each serving its rows) every rank holds rank
    0's parameters bit for bit; the three exited 0."""
    (one,), _, _ = runs[1]
    three, _, d3 = runs[3]
    _check_against_one_process(one, three[:2])
    assert three[2]["history"] == []
    assert three[2]["digest"] == three[0]["digest"]
    assert three[2]["aps"] == three[0]["aps"]
    with open(d3 / "rank2.log") as f:
        assert "loss_rpn_cls" not in f.read()


def _check_against_one_process(one, ranks):
    assert len(one["history"]) == 2
    for r in ranks:
        assert len(r["history"]) == 2
        for a, b in zip(r["history"], one["history"]):
            assert a["iter"] == b["iter"] and a["lr"] == b["lr"]
            for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                      "orcnn_bbox_loss", "total_loss"):
                assert abs(a[k] - b[k]) <= TOL * max(abs(b[k]), 1.0), (k, a, b)
        assert set(r["aps"]) == set(one["aps"]) and one["aps"]
        for k, v in one["aps"].items():
            assert abs(r["aps"][k] - v) <= 1e-6, k
    assert all(r["digest"] == ranks[0]["digest"] for r in ranks)
    lrs = [rec["lr"] for rec in one["history"]]
    n_sure = n_off = 0
    for k, p in one["params"].items():
        g = one["grads"][k]
        diff = np.abs(ranks[0]["params"][k] - p)
        assert diff.max() <= 2 * sum(lrs) + 1e-6, (k, diff.max())
        if _before_bn(k):
            continue
        assert _close(ranks[0]["grads"][k], g), k
        sure = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-12)
        assert (diff[sure] <= min(lrs) / 10).all(), (k, diff[sure].max())
        n_sure += sure.sum()
        n_off += (diff[sure] > 1e-6).sum()
    assert n_off <= 1e-4 * n_sure, (n_off, n_sure)


def test_run_net_rank_zero_alone_writes(runs):
    """The work directory holds what one process writes, and only rank 0
    logged."""
    _, w1, _ = runs[1]
    _, w2, d2 = runs[2]

    def listing(w):
        return sorted(os.path.relpath(os.path.join(p, f), w)
                      for p, _, fs in os.walk(w) for f in fs
                      if "tensorboard" not in p)

    assert listing(w2) == listing(w1)
    assert "checkpoints/ckpt_2.pkl" in listing(w2)
    with open(d2 / "rank1.log") as f:
        assert "loss_rpn_cls" not in f.read()
    with open(d2 / "rank0.log") as f:
        assert "loss_rpn_cls" in f.read()
