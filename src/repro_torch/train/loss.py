"""Loss functions (port of ``repro.train.loss``), and the vocab-parallel
cross entropy of a split model (``dist.tensor_parallel``): the logits held
as vocab shards, one a model worker, reduced in float32 by a max
all-reduce, a sum of ``exp`` all-reduce and the gold logit from its owner
by a sum all-reduce; the sums' backward is the identity, so each worker's
gradient of its shard is its shard of the whole one."""
from __future__ import annotations

import torch

from repro_torch.dist import tensor_parallel as tp


def shift_targets(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token targets and mask; the final position is masked out."""
    targets = torch.roll(tokens, -1, dims=-1)
    mask = torch.ones_like(tokens, dtype=torch.float32)
    mask[:, -1] = 0.0
    return targets, mask


def _vocab_parallel_nll(logits32: torch.Tensor, targets: torch.Tensor,
                        ma, lo: int) -> torch.Tensor:
    """``logsumexp - gold`` per position over the whole vocabulary, from
    this worker's shard ``logits32`` [B, S, n] (rows ``lo .. lo + n - 1``
    of the vocabulary), the same on every model worker."""
    n = logits32.shape[-1]
    m = ma.max(logits32.detach().amax(-1))
    m = m.masked_fill(m.abs() == float("inf"), 0.0)      # as logsumexp's
    lse = torch.log(tp.reduce_from(
        torch.exp(logits32 - m[..., None]).sum(-1), ma)) + m
    local = targets - lo
    outside = (local < 0) | (local >= n)
    gold = torch.gather(logits32, -1, local.clamp(0, n - 1)[..., None])
    return lse - tp.reduce_from(gold[..., 0].masked_fill(outside, 0.0), ma)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor, vocab=None) -> torch.Tensor:
    """Token-mean cross entropy in float32; ``vocab`` ``(axis, lo)``:
    ``logits`` are a model worker's vocab shard from row ``lo`` (a split
    model's ``TensorParallel.vocab_axis``), the loss the whole one."""
    logits32 = logits.to(torch.float32)
    if vocab is None:
        lse = torch.logsumexp(logits32, dim=-1)
        gold = torch.gather(logits32, -1, targets[..., None])[..., 0]
        nll = (lse - gold) * mask
    else:
        nll = _vocab_parallel_nll(logits32, targets, *vocab) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
