"""Synthetic LM tokens (port of ``repro.data.synthetic.token_batch``)."""
from __future__ import annotations

import torch


def token_batch(generator: torch.Generator, vocab: int, batch: int, seq: int,
                structure: int = 97) -> dict:
    """One batch of pseudo-text on the generator's device: Markov-ish tokens
    (the next token correlates with the current one) so the loss is
    learnable, not pure noise."""
    dev = generator.device
    base = torch.randint(0, vocab, (batch, seq), generator=generator,
                         device=dev)
    shifted = (base * 31 + structure) % vocab
    noise = torch.rand((batch, seq), generator=generator, device=dev) < 0.25
    tokens = torch.where(noise, base, torch.roll(shifted, 1, dims=1))
    return {"tokens": tokens}
