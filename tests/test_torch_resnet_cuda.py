"""ResNet, SGD and the EQLv2 head on a CUDA GPU against the CPU
(``python -m pytest -m cuda --noconftest tests/test_torch_resnet_cuda.py``
on the card; every test here skips without one): the registered ResNet
forms at 1024^2 in f32 and bf16; two SGD steps of the tiny ResNet config
with f32 master weights and bf16 activations (as ``compute_dtype``
trains), with the frozen stages decaying and the frozen norms still; the
EQLv2 head's loss and state, checkpointed or not."""

import copy

import numpy as np
import pytest
import torch

from rs_detection_tpu_torch.flagship import (init_weights, make_targets,
                                             normalize)
from rs_detection_tpu_torch.models.networks import rcnn  # noqa: F401
from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
from rs_detection_tpu_torch.optims.optimizer import SGD
from rs_detection_tpu_torch.parallel.train_step import train_step
from rs_detection_tpu_torch.utils import registry as reg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["Resnet50", "Resnet101_v1d", "Resnet18"])
def test_resnet_form_cuda_matches_cpu(dev, name):
    """Eval forward of a 512^2 pair: CUDA f32 (cuDNN, TF32 off) within
    1e-4 of each stage's largest CPU value, bf16 within 5e-2 (bf16
    activations through 16-33 blocks)."""
    torch.manual_seed(0)
    net = reg.build_from_cfg(dict(type=name), reg.BACKBONES).eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    x = torch.randn(2, 512, 512, 3)
    with torch.no_grad():
        ref = net(x)
        gpu = copy.deepcopy(net).to(dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            got = gpu.to(dtype)(x.to(dev, dtype))
            for g, r in zip(got, ref):
                err = (g.float().cpu() - r).abs().max().item()
                assert err <= tol * r.abs().max().item(), (dtype, err)


def _tiny_model():
    from test_torch_overfit_map import tiny_cfg

    model = tiny_cfg("", "", None)["model"]
    model["backbone"].update(frozen_stages=1, norm_eval=True)
    model["rpn"]["sampler"] = dict(num=4096, pos_fraction=1.0)
    model["bbox_head"]["sampler"] = dict(num=38, pos_fraction=1.0,
                                         add_gt_as_proposals=True)
    return model


def test_sgd_steps_in_bf16_compute_track_the_cpu(dev):
    """Two SGD steps of the tiny ResNet config on the card with bf16
    activations and f32 master weights against the CPU in f32: losses
    within 5e-2 relative (bf16 activations), masters still f32, every
    parameter within 20% of its f32 move (plus 1e-6), the frozen conv
    weights decayed and every running statistic unmoved."""
    g = torch.Generator().manual_seed(25)
    tiles = torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    targets = make_targets(2, 128, 6, g)
    targets["rboxes"][..., 4] = 0.0
    runs = []
    for device, dtype in (("cpu", None), (dev, "bfloat16")):
        cfg = dict(_tiny_model(), compute_dtype=dtype)
        model = reg.build_from_cfg(cfg, reg.MODELS)
        init_weights(model, torch.Generator().manual_seed(3))
        model.to(device)
        start = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
        opt = SGD(model.parameters(), lr=0.01, momentum=0.9,
                  grad_clip=dict(max_norm=35))
        sched = StepLR([8], warmup="linear", warmup_iters=4,
                       warmup_ratio=0.25)
        losses = [train_step(model, opt, sched, normalize(tiles.to(device)),
                             {k: v.to(device) for k, v in targets.items()},
                             torch.Generator(device=device).manual_seed(i),
                             epoch=opt.iterations / 2) for i in range(2)]
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        runs.append((losses, start, {k: v.detach().float().cpu() for k, v
                                     in model.state_dict().items()}))
    (l_cpu, s0, w_cpu), (l_gpu, _, w_gpu) = runs
    for a, b in zip(l_gpu, l_cpu):
        for k, v in b.items():
            assert abs(a[k].item() - v.item()) <= 5e-2 * max(abs(v.item()),
                                                             0.1), k
    for k, c in w_cpu.items():
        if k.endswith("num_batches_tracked"):
            continue
        moved = (c - s0[k]).abs().max().item()
        if k.endswith(("running_mean", "running_var")):
            assert moved == 0.0 and torch.equal(w_gpu[k], c), k
            continue
        assert (w_gpu[k] - c).abs().max().item() <= 1e-6 + 0.2 * moved, k
        if k.startswith(("backbone.Conv_0", "backbone.layer1_0.Conv")):
            assert moved > 0.0, k


HEAD_KW = dict(num_classes=5, in_channels=16, fc_out_channels=32,
               sampler=dict(num=44, pos_fraction=1.0,
                            add_gt_as_proposals=True),
               bbox_roi_extractor=dict(
                   roi_layer=dict(output_size=7, sampling_ratio=2),
                   out_channels=16, extend_factor=(1.4, 1.2),
                   featmap_strides=[4, 8, 16, 32]))


def _head_inputs():
    """``tests/test_torch_long_tail.py:_head_inputs(7)``'s kind: features
    of a 64^2 pair, 40 proposals jittered around 4 ground-truth slots an
    image (axis-aligned, as the CUDA-against-CPU training checks keep
    them)."""
    rng = np.random.RandomState(7)
    feats = [rng.randn(2, 64 // s, 64 // s, 16).astype(np.float32)
             for s in (4, 8, 16, 32)]
    rboxes = np.array([
        [[20, 22, 24, 14, 0], [44, 40, 30, 18, 0], [30, 48, 16, 16, 0],
         [48, 16, 12, 20, 0]],
        [[32, 30, 28, 20, 0], [14, 18, 16, 10, 0], [46, 46, 26, 14, 0],
         [0, 0, 0, 0, 0]]], np.float32)
    gt_mask = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], bool)
    labels = np.array([[1, 2, 5, 3], [4, 2, 1, 0]], np.int32)
    pick = rng.randint(0, 3, (2, 40))
    jitter = rng.randn(2, 40, 5) * np.array([4, 4, 4, 3, 0])
    proposals = (rboxes[np.arange(2)[:, None], pick] + jitter).astype(
        np.float32)
    proposals[..., 2:4] = np.abs(proposals[..., 2:4]) + 4
    targets = dict(rboxes=rboxes, gt_mask=gt_mask, labels=labels,
                   img_hw=np.full((2, 2), 64.0, np.float32))
    return feats, proposals, np.ones((2, 40), bool), targets


def test_eqlv2_head_state_cuda_matches_cpu(dev):
    """``OrientedEQLv2Head.loss`` twice on the card (K1, K3) and on the
    CPU from the same weights, the second time under
    ``torch.utils.checkpoint``: losses within 1e-4 relative, the state
    within 1e-5 relative after each step, and the checkpointed step moves
    it once."""
    from torch.utils.checkpoint import checkpoint

    feats, proposals, valid, targets = _head_inputs()
    heads = {}
    for device in ("cpu", dev):
        torch.manual_seed(3)
        head = reg.build_from_cfg(dict(type="OrientedEQLv2Head", **HEAD_KW),
                                  reg.HEADS).to(device)
        args = ([torch.from_numpy(f).to(device) for f in feats],
                torch.from_numpy(proposals).to(device),
                torch.from_numpy(valid).to(device),
                {k: torch.from_numpy(v).to(device)
                 for k, v in targets.items()})
        seen = []
        for step in range(2):
            gen = torch.Generator(device=device).manual_seed(0)
            if step:
                out = checkpoint(head.loss, *args, gen, use_reentrant=False,
                                 context_fn=head.checkpoint_contexts)
            else:
                out = head.loss(*args, gen)
            (out["loss_cls"] + out["orcnn_bbox_loss"]).backward()
            seen.append(({k: v.item() for k, v in out.items()},
                         head.efl.value()))
        heads[str(device)] = seen
    for (lc, sc), (lg, sg) in zip(heads["cpu"], heads[str(dev)]):
        for k, v in lc.items():
            assert abs(lg[k] - v) <= 1e-4 * max(abs(v), 0.1), k
        for a, b in zip(sg, sc):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-8)
