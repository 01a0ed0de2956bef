"""The port's data-parallel steps against the JAX mesh's, on the CPU:
the port's step over two gloo processes (``tests/torch_dp_children.py``)
against ``make_train_step(mesh=create_mesh(2))`` on two of the
conftest's virtual devices, and ``make_eval_step`` over two processes on
3 images (an uneven batch: one rank pads) against JAX's ``shard_map``
eval step over a 3-device mesh and the port's own ``predict``.

Both sides start from one set of weights (JAX ``model.init``, perturbed,
carried across by ``load_jax_variables``) and take the tiny Oriented
R-CNN of ``tests/test_torch_port_train_step.py``, whose samplers take
every candidate, so the frameworks sample the same sets; f32, AdamW with
the StepLR warmup and clipping. The tolerances are that test's: the
frameworks sum in other orders through the whole net."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rs_detection_tpu.optims.lr_scheduler import StepLR as JStepLR
from rs_detection_tpu.optims.optimizer import AdamW as JAdamW
from rs_detection_tpu.parallel.train_step import (create_mesh,
                                                  create_train_state,
                                                  make_eval_step,
                                                  make_train_step)
from rs_detection_tpu_torch.utils.jax_weights import jax_to_state_dict
from test_torch_port_slice import perturb
from test_torch_port_train_step import SCHED, _adam_mu, _before_bn, _jax_tiny
from torch_one_thread import _one_thread  # noqa: F401
from torch_dp_children import orcnn_eval, run_world, tiny_batch

N, N_EVAL = 4, 3


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_jax")
    model = _jax_tiny()
    images, targets = tiny_batch(N)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    variables = perturb(jax.jit(lambda i, t: model.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        i, t))(jnp.asarray(images[:1]), {k: v[:1] for k, v in jt.items()}),
        seed=5)
    weights = str(tmp / "weights.pkl")
    with open(weights, "wb") as f:
        pickle.dump(variables, f)

    sched = JStepLR(**SCHED)
    tx = JAdamW(lr=lambda step: sched(1e-4, step, 0), weight_decay=0.05,
                grad_clip=dict(max_norm=35))
    mesh = create_mesh(2)
    state = create_train_state(
        model, jax.tree_util.tree_map(jnp.asarray, variables), tx)
    with mesh:
        new_state, metrics = make_train_step(model, tx, mesh=mesh,
                                             donate=False)(
            state, jnp.asarray(images), jt, jax.random.PRNGKey(2))
    eval_images, _ = tiny_batch(N_EVAL, seed=22)
    mesh3 = create_mesh(N_EVAL)
    with mesh3:
        out = make_eval_step(model, mesh3, use_shard_map=True)(
            variables, jnp.asarray(eval_images),
            {"scale_factor": jnp.ones((N_EVAL,), jnp.float32)})
    ref = dict(
        losses={k: float(v) for k, v in metrics.items()},
        grads=jax_to_state_dict({"params": jax.tree_util.tree_map(
            lambda m: np.asarray(m) / 0.1, _adam_mu(new_state.opt_state))}),
        params=jax_to_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, new_state.params)}),
        stats=jax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
            np.asarray, new_state.batch_stats["batch_stats"])}),
        eval={k: np.asarray(v) for k, v in out.items()})
    calls = [("orcnn_step", dict(n=N, take_all=True, weights=weights)),
             ("orcnn_eval", dict(n=N_EVAL, weights=weights))]
    ranks = [dict(zip(["orcnn_step", "orcnn_eval"], r))
             for r in run_world("several", 2, dict(calls=calls), tmp)]
    return ref, ranks, orcnn_eval(n=N_EVAL, weights=weights)


def test_two_rank_losses_match_the_jax_mesh(sides):
    ref, ranks, _ = sides
    for r in ranks:
        got = r["orcnn_step"]["losses"]
        assert set(got) == set(ref["losses"])
        for k, v in ref["losses"].items():
            assert abs(got[k] - v) <= 2e-3 * max(abs(v), 0.1), (k, got[k], v)
    assert ref["losses"]["orcnn_bbox_loss"] > 0


def test_two_rank_gradients_match_the_jax_mesh(sides):
    """Each (clipped) gradient to 5e-3 of its leaf's largest magnitude."""
    ref, ranks, _ = sides
    got = ranks[0]["orcnn_step"]["grads"]
    assert set(got) == set(ref["grads"])
    for k, gj in ref["grads"].items():
        if _before_bn(k):
            continue
        scale = max(np.abs(gj).max(), np.abs(got[k]).max(), 1e-12)
        assert np.abs(got[k] - gj).max() / scale < 5e-3, k


def test_two_rank_adamw_step_and_bn_stats_match_the_jax_mesh(sides):
    """Parameters within 2 lr (1e-6 of the update where the gradient is
    not noise); running statistics as the one-device test holds them."""
    ref, ranks, _ = sides
    got = ranks[1]["orcnn_step"]
    lr = got["lr"]
    for k, pj in ref["params"].items():
        diff = np.abs(got["params"][k] - pj)
        assert diff.max() <= 2 * lr + 1e-6, (k, diff.max())
        g = ref["grads"][k]
        sure = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-12)
        if sure.any() and not _before_bn(k):
            assert diff[sure].max() <= 1e-6, k
    for k, v in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_two_rank_eval_step_matches_jax_shard_map_and_predict(sides):
    """3 images: the port's 2 ranks (one pads) against JAX's shard_map
    over 3 devices (``tests/test_torch_port_slice.py``'s bounds), and
    against the port's one-process ``predict``."""
    ref, ranks, one = sides
    jx = ref["eval"]
    assert jx["valid"].sum() > 32
    for r in ranks:
        got = r["orcnn_eval"]
        np.testing.assert_array_equal(got["valid"], jx["valid"])
        np.testing.assert_allclose(got["scores"], jx["scores"], atol=2e-6)
        np.testing.assert_allclose(got["polys"], jx["polys"], atol=1e-3)
        for k, v in one.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-4,
                                       err_msg=k)
