"""Raw-scene serving of the port against the JAX package, on the CPU: the
tiler, ``TileScreen`` and ``screen_loss`` with weights carried from
flax, screen checkpoints both ways, one ``train_screen`` step against
optax, ``SceneDataset.batches`` (rates, flips, the screen's ``thresh``
and ``budget``) and the runner's device tensors (``resize_cubic`` and
the jax-free process: ``tests/test_torch_preprocess.py``). The torch
form of the JAX package's screened-scene mAP test is ``slow``; the
``cuda`` tests hold the card against the CPU (``python -m pytest -m cuda
--noconftest tests/test_torch_scene.py`` on the card: they import no
jax)."""

import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from rs_detection_tpu_torch.data.device_resize import resize_cubic
from rs_detection_tpu_torch.data.device_tiler import (tile_positions,
                                                      tile_scene)
from rs_detection_tpu_torch.data.scene import SceneDataset
from rs_detection_tpu_torch.models.networks.tile_screen import (TileScreen,
                                                                screen_loss)
from rs_detection_tpu_torch.tools import train_screen
from rs_detection_tpu_torch.utils.jax_weights import (load_jax_variables,
                                                      module_to_jax_params)
from torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCREEN_KW = dict(channels=(8, 16), pool=2)
SCREEN_CFG = dict(type="TileScreen", **SCREEN_KW)
SCENES = [("A", (150, 173)), ("B", (97, 131))]


def write_scenes(root, seed=0):
    """Seeded uint8 PNG scenes (odd sides; B at rate 0.5 is smaller than
    a 64 tile); returns the directory."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name, (h, w) in SCENES:
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(root, name + ".png"))
    return str(root)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# ---------------------------------------------------------------- JAX twins

def _jax():
    """The JAX package's modules (imported here, so that the ``cuda`` tests
    of this file run where there is no jax)."""
    import jax
    import optax
    from flax import serialization

    from rs_detection_tpu.data import device_resize as jresize
    from rs_detection_tpu.data import device_tiler as jtiler
    from rs_detection_tpu.data import scene as jscene
    from rs_detection_tpu.models.networks import tile_screen as jscreen

    return dict(jax=jax, optax=optax, serialization=serialization,
                resize=jresize, tiler=jtiler, scene=jscene, screen=jscreen)


def _flax_screen(j, seed, shape=(2, 64, 64, 3), **kw):
    model = j["screen"].TileScreen(**kw)
    v = j["jax"].jit(model.init)(j["jax"].random.PRNGKey(seed),
                                np.zeros(shape, np.float32))
    params = j["jax"].tree_util.tree_map(np.asarray, dict(v["params"]))
    return model, {"params": params}


@pytest.mark.parametrize("dims,subsize,gap", [
    ((150, 173), 64, 16), ((48, 66), 64, 16), ((300, 1000), 128, 32),
    ((1024, 1848), 1024, 200)])
def test_tiler_matches_jax(dims, subsize, gap):
    """Window positions, tile order, offsets and pixels (zero padding of
    a scene smaller than a tile included), equal."""
    j = _jax()
    for d in dims:
        assert tile_positions(d, subsize, subsize - gap) == \
            j["tiler"].tile_positions(d, subsize, subsize - gap)
    if dims[0] * dims[1] > 2e5:
        return
    scene = np.random.RandomState(2).randint(0, 256, dims + (3,)).astype(
        np.uint8)
    ref, ref_off = j["tiler"].tile_scene(scene, subsize, gap)
    got, off = tile_scene(torch.from_numpy(scene), subsize, gap)
    np.testing.assert_array_equal(off, ref_off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kw", [dict(channels=(8, 16), pool=2), dict()])
def test_tile_screen_matches_flax(kw):
    """Forward and ``screen_loss`` with the flax init carried over by
    ``load_jax_variables``, and back by ``module_to_jax_params``, at
    1e-5."""
    j = _jax()
    size = 64 if kw else 128
    model, variables = _flax_screen(j, 3, (2, size, size, 3), **kw)
    port = load_jax_variables(TileScreen(**kw), variables)
    back = module_to_jax_params(port)
    flat = j["jax"].tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == \
        [p for p, _ in flat(variables["params"])]
    for (_, a), (_, b) in zip(flat(back), flat(variables["params"])):
        np.testing.assert_array_equal(a, b)
    x = np.random.RandomState(4).randn(5, size, size, 3).astype(np.float32)
    ref = np.asarray(j["jax"].jit(model.apply)(variables, x))
    got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (5,)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    y = np.array([0, 1, 1, 0, 1], np.float32)
    jl, jm = j["screen"].screen_loss(ref, y)
    loss, m = screen_loss(got, torch.from_numpy(y))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert float(m["screen_acc"]) == float(jm["screen_acc"])


def test_train_screen_step_matches_optax():
    """One step of the port's ``screen_step`` (torch AdamW at optax's
    defaults) against ``optax.adamw`` on the same batch and weights."""
    j = _jax()
    jax, optax = j["jax"], j["optax"]
    model, variables = _flax_screen(j, 5, **SCREEN_KW)
    rng = np.random.RandomState(6)
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    gt_mask = np.array([[1, 0], [0, 0], [0, 1], [0, 0]], bool)
    labels = gt_mask.any(axis=1)
    tx = optax.adamw(1e-3)
    opt_state = tx.init(variables["params"])

    def lossfn(p):
        return j["screen"].screen_loss(model.apply({"params": p}, x), labels)

    (_, jm), grads = jax.jit(jax.value_and_grad(lossfn, has_aux=True))(
        variables["params"])
    updates, _ = tx.update(grads, opt_state, variables["params"])
    ref = optax.apply_updates(variables["params"], updates)
    port = load_jax_variables(TileScreen(**SCREEN_KW), variables)
    m = train_screen.screen_step(port, train_screen.make_optimizer(port, 1e-3),
                                 x, gt_mask)
    np.testing.assert_allclose(float(m["screen_loss"]),
                               float(jm["screen_loss"]), rtol=1e-5)
    got = module_to_jax_params(port)
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                              jax.tree_util.tree_leaves_with_path(ref)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def _jax_ckpt(j, path, variables):
    """A checkpoint as the JAX ``tools/train_screen.py`` writes it."""
    with open(path, "wb") as f:
        pickle.dump(dict(model=j["serialization"].to_state_dict(
            {"params": j["jax"].tree_util.tree_map(
                j["jax"].numpy.asarray, variables["params"])})), f)
    return str(path)


def _batches(ds, flip_mode):
    out = []
    for images, targets, metas in ds.batches(flip_mode):
        out.append((np.asarray(images), {k: np.asarray(v)
                                         for k, v in targets.items()}, metas))
    return out


@pytest.mark.parametrize("screen", [None, "thresh", "budget"])
def test_scene_batches_match_jax(tmp_path, screen):
    """Two scenes at rates 0.5 / 1.0 / 1.5 (the zero-padded small variant
    included), batch 3, every flip mode: the same metas (so the same kept
    tiles under a screen, which scores the unflipped tiles), tiles at
    1e-4, the same target arrays and screen counts. The screen loads a
    checkpoint written as the JAX tool writes it."""
    j = _jax()
    scenes = write_scenes(tmp_path / "scenes")
    kw = dict(images_dir=scenes, subsize=64, gap=16, batch_size=3,
              rates=[0.5, 1.0, 1.5])
    if screen:
        _, variables = _flax_screen(j, 7, **SCREEN_KW)
        variables["params"]["Conv_2"]["bias"] = np.array([-4.4], np.float32)
        ckpt = _jax_ckpt(j, tmp_path / "screen.pkl", variables)
        kw["screen"] = dict(model=SCREEN_CFG, checkpoint=ckpt,
                            **({"thresh": 0.5} if screen == "thresh"
                               else {"budget": 3}))
    port = SceneDataset(device="cpu", **kw)
    ref = j["scene"].SceneDataset(**kw)
    for mode in (None, "H", "V", "HV"):
        got, want = _batches(port, mode), _batches(ref, mode)
        assert len(got) == len(want) > 2
        for (gi, gt, gm), (ri, rt, rm) in zip(got, want):
            assert gm == rm
            np.testing.assert_allclose(gi, ri, atol=1e-4)
            assert gt.keys() == rt.keys()
            for k in rt:
                np.testing.assert_array_equal(gt[k], rt[k])
                assert gt[k].dtype == rt[k].dtype
    assert port.screen_stats == ref.screen_stats
    if screen:
        assert 0 < port.screen_stats["kept"] < port.screen_stats["total"]


def test_scene_single_rate_matches_jax(tmp_path):
    """One ``rate`` (Pillow's bicubic on the host) and ``to_bgr``."""
    j = _jax()
    kw = dict(images_dir=write_scenes(tmp_path / "scenes"), subsize=64,
              gap=16, batch_size=2, rate=0.75, to_bgr=True)
    got = _batches(SceneDataset(device="cpu", **kw), "HV")
    want = _batches(j["scene"].SceneDataset(**kw), "HV")
    assert [m for _, _, m in got] == [m for _, _, m in want]
    assert got[0][2][0]["filename"] == "A__0.75__0___0.png"
    for (gi, _, _), (ri, _, _) in zip(got, want):
        np.testing.assert_allclose(gi, ri, atol=1e-4)


def _labelled_tiles(root, n=6, size=64, seed=8):
    """A DOTA-style labelled dataset: bright boxes on half of the tiles."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    infos = []
    for i in range(n):
        img = (rng.rand(size, size, 3) * 40).astype(np.uint8)
        boxes = np.zeros((0, 5), np.float32)
        if i % 2:
            img[20:36, 16:40] = (230, 220, 210)
            boxes = np.array([[28, 28, 24, 16, 0]], np.float32)
        Image.fromarray(img).save(os.path.join(root, "images", f"t{i}.png"))
        ann = dict(bboxes=boxes, labels=np.ones(len(boxes), np.int64),
                   bboxes_ignore=np.zeros((0, 5), np.float32))
        infos.append(dict(filename=f"t{i}.png", width=size, height=size,
                          ann=ann))
    with open(os.path.join(root, "labels.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return root


def test_screen_checkpoints_go_both_ways(tmp_path):
    """``train_screen``'s command line on the CPU writes a checkpoint the
    JAX ``SceneDataset`` loads, scoring tiles as the port does (1e-5);
    the JAX-written one the port loads (``test_scene_batches_match_jax``)."""
    j = _jax()
    ds = _labelled_tiles(str(tmp_path / "ds"))
    cfg = tmp_path / "screen_cfg.py"
    cfg.write_text(repr_config(dict(dataset=dict(train=dict(
        type="DOTADataset", dataset_dir=ds, batch_size=3, max_gt=4,
        filter_empty_gt=False, transforms=[dict(
            type="Normalize", mean=[123.675, 116.28, 103.53],
            std=[58.395, 57.12, 57.375], to_bgr=False)])))))
    out = str(tmp_path / "screen.pkl")
    model = train_screen.main(["--config-file", str(cfg), "--iters", "3",
                               "--out", out, "--cpu", "--log-interval", "1"])
    with open(out, "rb") as f:
        saved = pickle.load(f)
    assert list(saved) == ["model"] and list(saved["model"]) == ["params"]
    x = np.random.RandomState(9).randn(3, 128, 128, 3).astype(np.float32)
    jds = j["scene"].SceneDataset(images_dir=write_scenes(tmp_path / "s"),
                                  subsize=128, screen=dict(checkpoint=out,
                                                           thresh=0.5))
    jds._screen_setup()
    ref = np.asarray(jds._screen_fn(jds._screen_vars, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def repr_config(cfg):
    return "".join(f"{k} = {v!r}\n" for k, v in cfg.items())


def test_scene_screen_errors(tmp_path):
    """The JAX dataset's errors: a screen with neither ``thresh`` nor
    ``budget``, and one without a checkpoint unless random weights are
    allowed (then it runs)."""
    scenes = write_scenes(tmp_path / "scenes")
    with pytest.raises(ValueError, match="thresh"):
        SceneDataset(images_dir=scenes, screen=dict(checkpoint="x.pkl"))
    ds = SceneDataset(images_dir=scenes, subsize=64, gap=16, device="cpu",
                      screen=dict(thresh=0.5))
    with pytest.raises(ValueError, match="random weights"):
        list(ds.batches())
    ds = SceneDataset(images_dir=scenes, subsize=64, gap=16, device="cpu",
                      batch_size=4, screen=dict(budget=2,
                                                allow_random_init=True))
    metas = [m for _, _, b in ds.batches() for m in b if m]
    assert len(metas) == 4 and ds.screen_stats == dict(total=18, kept=4)


def test_runner_takes_device_tensors(tmp_path, monkeypatch):
    """``Runner.predict`` / ``test_time`` take a batch that is already a
    tensor on the runner's device as well as numpy, with the same
    result; a config's ``SceneDataset`` tiles on the runner's device."""
    from rs_detection_tpu_torch.config import get_cfg
    from rs_detection_tpu_torch.flagship import flagship_cfg
    from rs_detection_tpu_torch.runner import Runner

    monkeypatch.chdir(tmp_path)
    cfg = get_cfg()
    cfg.clear()
    cfg.update(dict(
        work_dir=str(tmp_path / "work"), seed=1,
        model=flagship_cfg(tiny=True),
        dataset=dict(test=dict(type="SceneDataset",
                               images_dir=write_scenes(tmp_path / "s"),
                               subsize=64, gap=16, batch_size=2))))
    runner = Runner(device="cpu")
    assert runner.test_dataset.device == torch.device("cpu")
    images, targets, _ = next(iter(runner.test_dataset.batches()))
    assert isinstance(images, torch.Tensor)
    got = runner.predict(images, targets)
    ref = runner.predict(images.numpy(), targets)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert runner.test_time(iters=1, warmup=0) > 0


# ----------------------------------------------------- screened scene mAP

MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


def sparse_scene(ds_dir, root):
    """The JAX test's sparse 384^2 scene ``SP001``: the 4 rendered tiles
    of ``ds_dir`` fill the top-left 2 x 2 of a 3 x 3 grid of 128^2 tiles,
    the other 5 are background. Returns (scene dir, scene array)."""
    from test_torch_overfit_map import OFFSETS

    rng = np.random.RandomState(33)
    scene = np.full((384, 384, 3), 60, np.uint8)
    scene += (rng.rand(384, 384, 3) * 20).astype(np.uint8)
    for i, (ox, oy) in OFFSETS.items():
        with Image.open(os.path.join(ds_dir, "images",
                                     f"tile_{i}.png")) as im:
            scene[oy:oy + 128, ox:ox + 128] = np.asarray(im)
    scene_dir = os.path.join(root, "scenes")
    os.makedirs(scene_dir, exist_ok=True)
    Image.fromarray(scene).save(os.path.join(scene_dir, "SP001.png"))
    return scene_dir, scene


class NineTiles:
    """The sparse scene's 9 normalized tiles and their labels as a
    dataset of one batch. ``tools/train_screen.py``'s command line reads
    a labelled dataset, and the labelled datasets replace an empty tile
    by a drawn one (as in JAX), so that it would see no negative tile."""

    def __init__(self, scene):
        self.x = np.stack([scene[u:u + 128, lf:lf + 128]
                           for u in (0, 128, 256) for lf in (0, 128, 256)])
        self.x = (self.x.astype(np.float32) - np.float32(MEAN)) \
            / np.float32(STD)
        self.labels = np.array([1, 1, 0, 1, 1, 0, 0, 0, 0], bool)

    def batches(self, seed=None):
        yield self.x, dict(gt_mask=self.labels[:, None]), [None] * 9


def train_scene_screen(scene, root, device, iters=150, lr=3e-3):
    """A default ``TileScreen`` trained by ``train_screen.train`` (AdamW)
    on the scene's 9 tiles and saved by ``train_screen.save_screen``;
    returns (checkpoint path, the tiles' logits, labels)."""
    tiles = NineTiles(scene)
    model = train_screen.train(tiles, iters, lr, device, log_interval=iters)
    ckpt = train_screen.save_screen(model, os.path.join(root, "screen.pkl"))
    with torch.no_grad():
        logits = model(torch.from_numpy(tiles.x).to(device)).cpu().numpy()
    return ckpt, logits, tiles.labels


OCCUPIED = {f"SP001__1.0__{lf}___{up}.png" for lf in (0, 128)
            for up in (0, 128)}


def check_screened_scene(runner, ds_dir, root, device):
    """The torch form of ``tests/test_map_pipeline.py:
    test_screened_scene_serving_end_to_end_map``, on a runner trained by
    ``test_torch_overfit_map.trained_runner``: a screen trained by the
    port's ``train_screen.train`` separates the sparse scene's tiles. The
    scene is served dense, then screened at ``thresh=0.5``, which must
    keep exactly the 4 occupied tiles, give each the dense run's
    detections (the results pickles, tile by tile) and reproduce the
    dense merged detections that score above every detection of the
    background tiles (and above the JAX test's 0.3) with the same
    ground-truth matches; at ``budget=1`` it must lose matches. Returns
    the matches, the screen counts and the score floor."""
    import shutil

    from test_torch_overfit_map import match_count, merged_dets

    scene_dir, scene = sparse_scene(ds_dir, root)
    ckpt, logits, labels = train_scene_screen(scene, root, device)
    assert logits[labels].min() > logits[~labels].max(), logits

    def serve(screen):
        sub = os.path.join(runner.work_dir, f"test/submit_{runner.epoch}")
        if os.path.exists(sub):
            shutil.rmtree(sub)
        runner.test_dataset = SceneDataset(
            images_dir=scene_dir, subsize=128, gap=0, batch_size=2,
            screen=screen, device=device)
        runner.test(flip_test=False)
        with open(os.path.join(runner.work_dir,
                               f"test/test_{runner.epoch}.pkl"), "rb") as f:
            tiles = {meta["filename"]: det for det, meta in pickle.load(f)}
        return (merged_dets(runner, "SP001"),
                dict(runner.test_dataset.screen_stats), tiles)

    def confident(dets, floor):
        return {c: sorted(v for v in d if v[0] >= floor)
                for c, d in dets.items() if any(v[0] >= floor for v in d)}

    dense, _, dense_tiles = serve(None)
    m_dense, total = match_count(dense, ds_dir)
    assert m_dense >= total * 0.4, (m_dense, total, dense)
    assert len(dense_tiles) == 9
    # the background tiles' false positives go with the screen; the JAX
    # test's floor of 0.3 stands for "above them" (its comment: they
    # score ~0.06 there), which a model trained elsewhere need not meet
    floor = max([0.3] + [float(s.max()) + 1e-4 for name, (_, s, _)
                         in dense_tiles.items()
                         if name not in OCCUPIED and len(s)])
    screened, stats, screened_tiles = serve(dict(checkpoint=ckpt,
                                                 thresh=0.5))
    assert stats == dict(total=9, kept=4), stats
    assert set(screened_tiles) == OCCUPIED, sorted(screened_tiles)
    for name, (polys, scores, labs) in screened_tiles.items():
        ref = dense_tiles[name]
        np.testing.assert_array_equal(labs, ref[2])
        np.testing.assert_allclose(scores, ref[1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(polys, ref[0], rtol=1e-5, atol=1e-4)
    a, b = confident(dense, floor), confident(screened, floor)
    assert a and set(a) == set(b), (floor, a, b)
    for c in a:
        assert len(a[c]) == len(b[c]), (c, floor, a[c], b[c])
        np.testing.assert_allclose(np.asarray(a[c]), np.asarray(b[c]),
                                   rtol=1e-5, atol=1e-4)
    m_screened, _ = match_count(screened, ds_dir)
    assert m_screened == m_dense, (m_screened, m_dense)
    tight, tight_stats, _ = serve(dict(checkpoint=ckpt, budget=1))
    assert tight_stats == dict(total=9, kept=1), tight_stats
    m_tight, _ = match_count(tight, ds_dir)
    assert m_tight < m_dense and m_tight <= total * 0.5, (m_tight, m_dense)
    return dict(total=total, dense=m_dense, thresh=m_screened,
                budget1=m_tight, thresh_stats=stats, budget1_stats=tight_stats,
                floor=round(floor, 4),
                screen_logits=[round(float(v), 3) for v in logits])


@pytest.mark.slow
def test_screened_scene_serving_end_to_end_map(tmp_path, monkeypatch):
    """``check_screened_scene`` on the CPU after the 200-epoch overfit
    (about 1.5 min on 8 cores)."""
    from test_torch_overfit_map import trained_runner

    monkeypatch.chdir(tmp_path)  # submit_zips/ is cwd-relative
    runner, ds_dir = trained_runner(str(tmp_path), "cpu")
    print("screened scene on the CPU:",
          check_screened_scene(runner, ds_dir, str(tmp_path), "cpu"))


# ------------------------------------------------------------------- card

@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.5, 0.75, 1.5])
def test_resizes_cuda_match_cpu(card, rate):
    """Both resizes on the card against the CPU: ``resize_cubic`` at
    1e-4, ``resize_cubic_rate`` within 1 LSB (rounding at .5 after an f32
    sum may flip)."""
    from rs_detection_tpu_torch.data.device_resize import resize_cubic_rate

    img = torch.from_numpy(np.random.RandomState(11).randint(
        0, 256, (301, 457, 3)).astype(np.uint8))
    oh, ow = int(round(301 * rate)), int(round(457 * rate))
    torch.testing.assert_close(resize_cubic(img.to(card), oh, ow).cpu(),
                               resize_cubic(img, oh, ow), atol=1e-4, rtol=0)
    d = (resize_cubic_rate(img.to(card), rate).cpu().int()
         - resize_cubic_rate(img, rate).int()).abs()
    assert d.max() <= 1


@pytest.mark.cuda
def test_tiler_cuda_matches_cpu(card):
    scene = torch.from_numpy(np.random.RandomState(12).randint(
        0, 256, (150, 173, 3)).astype(np.uint8))
    got, off = tile_scene(scene.to(card), 64, 16)
    ref, ref_off = tile_scene(scene, 64, 16)
    np.testing.assert_array_equal(off, ref_off)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("screen", [None, "budget"])
def test_scene_batches_cuda_match_cpu(card, tmp_path, screen):
    kw = dict(images_dir=write_scenes(tmp_path / "scenes"), subsize=64,
              gap=16, batch_size=3, rates=[0.5, 1.0, 1.5])
    if screen:
        kw["screen"] = dict(model=SCREEN_CFG, budget=3,
                            allow_random_init=True)
    got = list(SceneDataset(device=card, **kw).batches("H"))
    ref = list(SceneDataset(device="cpu", **kw).batches("H"))
    assert len(got) == len(ref)
    for (gi, _, gm), (ri, _, rm) in zip(got, ref):
        assert gi.device.type == "cuda" and gm == rm
        torch.testing.assert_close(gi.cpu(), ri, atol=1e-4, rtol=0)
