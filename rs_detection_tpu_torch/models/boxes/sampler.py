"""Positive/negative sampling as masks (counterpart of
``rs_detection_tpu/models/boxes/sampler.py``), batched over leading image
axes.

A uniform sample without replacement is the top-k of uniform random
scores; the scores come from an explicit ``torch.Generator`` on the
candidates' device. The two frameworks draw different numbers from one
seed, so only the counts, and the take-all case (``num`` at least the
candidate count, ``pos_fraction`` 1), can agree exactly.
"""

from __future__ import annotations

import torch

from ...utils.registry import BOXES


def random_choice_mask(mask, num_expected: int, generator):
    """Uniformly choose up to ``num_expected`` True entries along the
    last axis of ``mask``; all of them when there are fewer."""
    scores = torch.rand(mask.shape, generator=generator, device=mask.device)
    scores = torch.where(mask, scores, -1.0)
    idx = torch.topk(scores, min(num_expected, mask.shape[-1]), dim=-1).indices
    return torch.zeros_like(mask).scatter(-1, idx, True) & mask


@BOXES.register_module()
class PseudoSampler:
    """Keep every positive and every negative (reference
    ``sampler.py:114``): S2ANet's two target rounds."""

    def __init__(self, **_):
        pass

    def sample(self, assigned, generator=None):
        """assigned [..., A] (-1 / 0 / k+1) -> (pos, neg) bool masks."""
        return assigned > 0, assigned == 0


@BOXES.register_module()
class RandomSampler:
    """Random balanced sampling (reference ``sampler.py:133-178``).
    ``add_gt_as_proposals`` is read by the caller, which puts the ground
    truths among the candidates before assignment. A bound on negatives
    per positive (``neg_pos_ub >= 0``) is not ported: every config of
    the repository sets -1."""

    def __init__(self, num, pos_fraction, neg_pos_ub=-1,
                 add_gt_as_proposals=True, **_):
        if neg_pos_ub >= 0:
            raise NotImplementedError("RandomSampler: neg_pos_ub >= 0 is "
                                      "not ported")
        self.num = num
        self.pos_fraction = pos_fraction
        self.add_gt_as_proposals = add_gt_as_proposals

    def sample(self, assigned, generator):
        """assigned [..., A] (-1 / 0 / k+1) -> (pos, neg) bool masks: at
        most num * pos_fraction positives, negatives fill up to num."""
        num_expected_pos = int(self.num * self.pos_fraction)
        pos = random_choice_mask(assigned > 0, num_expected_pos, generator)
        num_pos = pos.sum(dim=-1, keepdim=True)
        num_expected_neg = self.num - num_pos.clamp(max=num_expected_pos)
        neg_cand = assigned == 0
        scores = torch.rand(neg_cand.shape, generator=generator,
                            device=neg_cand.device)
        scores = torch.where(neg_cand, scores, -1.0)
        kmax = min(self.num, neg_cand.shape[-1])
        vals, idx = torch.topk(scores, kmax, dim=-1)
        rank = torch.arange(kmax, device=assigned.device)
        take = (rank < num_expected_neg) & (vals > -1.0)
        neg = torch.zeros_like(neg_cand).scatter(-1, idx, take)
        return pos, neg


@BOXES.register_module()
class RandomSamplerRotated(RandomSampler):
    """The same sampling: it never looks at the boxes."""
