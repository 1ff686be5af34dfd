"""Loss functions (port of ``repro.train.loss``)."""
from __future__ import annotations

import torch


def shift_targets(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token targets and mask; the final position is masked out."""
    targets = torch.roll(tokens, -1, dims=-1)
    mask = torch.ones_like(tokens, dtype=torch.float32)
    mask[:, -1] = 0.0
    return targets, mask


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy in float32."""
    logits32 = logits.to(torch.float32)
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, targets[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
