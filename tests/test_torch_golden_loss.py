"""The golden-loss regressions of the port: the nine families of
``tests/test_golden_loss.py`` (the same build functions' shapes, the JAX
init of ``PRNGKey(0)`` carried by ``utils/jax_weights.py``), four SGD
steps of the port's ``train_step`` (lr 0.01, momentum 0.9, clip 35;
``rs_detection_tpu_torch/tools/golden_streams.py``), each step's total
loss within ``REL_TOL`` = 0.05 of its reference.

The reference is the recorded fixture ``golden_losses_<name>.json`` for
``fcos``, ``retinanet``, ``s2anet``, ``ssd`` and ``yolo`` (port in f32).

For ``orcnn``, ``gliding``, ``roitrans`` and ``r3det`` it is the JAX
stream from the same init, both sides in f64, the port's RoI samplers
fed the JAX step's own draws (the uniform scores of each sampler call,
from the key the JAX step derives: ``fold_in(PRNGKey(3), step)``
through flax's ``make_rng``, then the network's splits). Those fixtures
are the JAX stream in f32, which the port in f32 does not follow to the
fourth step: at the same state the two frameworks' f32 gradients differ
by up to 3e-4 of a leaf's largest (train-mode BatchNorm over one 64^2
image), and the refined boxes of these heads amplify it. Fed the f32
JAX step's draws, the port's f32 stream agrees to 1e-6 at step 1 and
0.2% at step 2, and is 5.4% (orcnn), 9.2% (gliding) and 34% (roitrans)
off at step 4; r3det,
which draws nothing, 19% (48.89 against 60.16), while its f64 streams
read 48.70 in both frameworks. In f64 the port follows the JAX stream
to 2e-5 over the four steps, its draws included.

One JAX ``init`` a family (and for the four, one f64 ``make_train_step``)
and the port on one thread."""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import rs_detection_tpu.parallel.train_step as jts
import test_golden_loss as golden
from rs_detection_tpu.optims.optimizer import SGD as JSGD
from rs_detection_tpu_torch.tools import golden_streams as gs
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from torch_one_thread import _one_thread  # noqa: F401

REL_TOL = golden.REL_TOL
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
JAX_STREAM = ("gliding", "orcnn", "r3det", "roitrans")
_MAKE_TRAIN_STEP = jts.make_train_step


def _jax_family(name, monkeypatch):
    """The JAX build function's (model, state, images, targets), the model
    caught on its way into ``make_train_step``."""
    seen = {}

    def catch(model, tx, *a, **kw):
        seen["model"] = model
        return _MAKE_TRAIN_STEP(model, tx, *a, **kw)

    monkeypatch.setattr(jts, "make_train_step", catch)
    _, state, images, targets = golden._BUILDERS[name]()
    return seen["model"], state, images, targets


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), tree)


def _jax_f64_stream(model, state, images, targets):
    """``make_train_step``'s four total losses from the build function's state,
    everything in f64 (its samplers draw f64 scores)."""
    with jax.enable_x64(True):
        tx = JSGD(lr=0.01, momentum=0.9, grad_clip=dict(max_norm=35))
        st = jts.create_train_state(
            model, {"params": _f64(state.params),
                    **_f64(state.batch_stats)}, tx)
        step = _MAKE_TRAIN_STEP(model, tx, mesh=None)
        x, t = _f64(images), _f64(targets)
        out = []
        for _ in range(gs.STEPS):
            st, m = step(st, x, t, jax.random.PRNGKey(3))
            out.append(float(m["total_loss"]))
    return out


class _Root(nn.Module):
    @nn.compact
    def __call__(self):
        return self.make_rng("sampler")


def _sampler_keys(name, step):
    """The keys of the JAX step ``step``'s sampler calls, in the port's
    call order, one per image (batch 1): the network's ``make_rng`` of
    ``fold_in(PRNGKey(3), step)`` split into the RPN's and the head's;
    the cascade head splits its own into its two stages'."""
    rng = _Root().apply({}, rngs={"sampler": jax.random.fold_in(
        jax.random.PRNGKey(3), step)})
    k1, k2 = jax.random.split(rng)
    calls = [k1, k2] if name != "roitrans" else [k1, *jax.random.split(k2)]
    return [jax.random.split(k, 1)[0] for k in calls]


@contextlib.contextmanager
def _jax_draws(name):
    """The port's samplers draw the JAX f64 step's scores: each sample
    call's positives and negatives from the two halves of its key."""
    from rs_detection_tpu_torch.models.boxes import sampler as sm

    real, queue, step = sm.dist, [], [0]

    class _Dist:
        def __getattr__(self, attr):
            return getattr(real, attr)

        @staticmethod
        def rand_rows(shape, generator=None, device=None):
            with jax.enable_x64(True):
                if not queue:
                    for key in _sampler_keys(name, step[0]):
                        queue.extend(jax.random.split(key))
                    step[0] += 1
                scores = np.asarray(jax.random.uniform(
                    queue.pop(0), shape[-1:], dtype=jnp.float64))
            assert tuple(shape) == (1,) + scores.shape
            return torch.from_numpy(np.array(scores[None])).to(device)

    sm.dist = _Dist()
    try:
        yield
    finally:
        sm.dist = real


@pytest.mark.parametrize("name", gs.FAMILIES)
def test_golden_losses(name, monkeypatch):
    """Four port steps from the JAX init within 0.05 of the fixture (or
    of the f64 JAX stream, see the module's docstring), every loss
    finite; the port's own batch (``golden_streams.inputs``, which the
    card runs) is the build function's."""
    model, state, images, targets = _jax_family(name, monkeypatch)
    mine, mine_t = gs.inputs(name)
    np.testing.assert_array_equal(mine, np.asarray(images))
    assert set(mine_t) == set(targets)
    for k, v in mine_t.items():
        np.testing.assert_array_equal(v, np.asarray(targets[k]), err_msg=k)
    port = load_jax_variables(gs.build(name), {
        "params": jax.tree_util.tree_map(np.asarray, state.params),
        **jax.tree_util.tree_map(np.asarray, dict(state.batch_stats))})
    if name in JAX_STREAM:
        want = _jax_f64_stream(model, state, images, targets)
        draws = _jax_draws(name) if name in gs.SAMPLING else \
            contextlib.nullcontext()
        with draws:
            got = gs.stream(port, mine, mine_t, dtype=torch.float64)
    else:
        with open(os.path.join(FIXTURES,
                               f"golden_losses_{name}.json")) as f:
            want = json.load(f)["losses"]
        got = gs.stream(port, mine, mine_t)
    assert len(got) == len(want) == gs.STEPS
    assert all(np.isfinite(got))
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) / max(abs(w), 1e-6) < REL_TOL, (i, got, want)


def test_stream_take_state_restarts_from_the_other_stream():
    """``Stream.take_state``, which chip phase 59b's lock step rests on:
    an f32 stream that takes an f64 stream's parameters, buffers and
    momentum after a step holds them (rounded to f32) and takes the same
    next step, with the same sampler draws (``host_draws``), to 1e-5 of
    the loss."""
    import copy

    from rs_detection_tpu_torch.flagship import init_weights

    model = gs.build("orcnn")
    init_weights(model, torch.Generator().manual_seed(592))
    x, t = gs.inputs("orcnn")
    with gs.host_draws():
        ref = gs.Stream(copy.deepcopy(model), x, t, "cpu", torch.float64)
        f32 = gs.Stream(copy.deepcopy(model), x, t, "cpu")
        ref.step(), f32.step()
        f32.take_state(ref)
        for (k, a), b in zip(f32.model.state_dict().items(),
                             ref.model.state_dict().values()):
            assert torch.equal(a, b.to(a.dtype)), k
        for p, q in zip(f32.model.parameters(), ref.model.parameters()):
            m, n = (s.opt.state[v]["momentum_buffer"]
                    for s, v in ((f32, p), (ref, q)))
            assert m.dtype == torch.float32 and torch.equal(m, n.float())
        want, got = ref.step(), f32.step()
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
