"""Synthetic data (port of ``repro.data.synthetic``): LM token batches and
the paper's section-5 generators.

``token_batch`` and ``token_stream`` draw from a ``torch.Generator`` on its
device (the JAX ones take a key), and so does ``stub_embeddings``, the
stub frontend inputs of the vision and audio models. ``logreg_data``,
``svm_data`` and ``image_data`` draw with numpy from ``seed`` exactly as
the JAX functions do, so they return the same arrays bit for bit, as
tensors on ``device`` (the card unless the caller asks for the CPU);
``image_data`` stays NHWC.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.devices import resolve_device


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


def token_stream(generator: torch.Generator, vocab: int, batch: int,
                 seq: int):
    """An endless stream of ``token_batch`` from one generator."""
    while True:
        yield token_batch(generator, vocab, batch, seq)


def stub_embeddings(generator: torch.Generator, shape,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Standard-normal stand-ins for a frontend's output (patch or frame
    embeddings) on the generator's device, drawn in float32 and rounded
    to ``dtype``."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(dtype)


def _tensors(device, *arrays):
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def logreg_data(seed: int, n: int = 1024, d: int = 2048, c1: float = 0.6,
                c2: float = 0.25, device=None):
    """Section 5.1's convex data: x ~ N(0, 1) times the magnitudes B ~
    U[0, 1]^d damped by C1 where B <= C2; labels y = sign(x^T w), w ~ N(0,
    I). Returns ``(x, y, w)`` float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    b = rng.uniform(0, 1, d).astype(np.float32)
    b = np.where(b <= c2, c1 * b, b)
    x = x * b
    w = rng.standard_normal(d).astype(np.float32)
    y = np.sign(x @ w).astype(np.float32)
    y[y == 0] = 1.0
    return _tensors(device, x, y, w)


def svm_data(seed: int, n: int = 51200, d: int = 256, c1: float = 0.01,
             c2: float = 0.9, device=None):
    """Section 5.3's SVM data: the same magnitudes, w ~ U[-0.5, 0.5]^d and
    y = sign(x^T w + sigma), sigma ~ N(0, 1). Returns ``(x, y, w)``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    b = rng.uniform(0, 1, d).astype(np.float32)
    b = np.where(b <= c2, c1 * b, b)
    x = x * b
    w = rng.uniform(-0.5, 0.5, d).astype(np.float32)
    noise = rng.standard_normal(n).astype(np.float32)
    y = np.sign(x @ w + noise).astype(np.float32)
    y[y == 0] = 1.0
    return _tensors(device, x, y, w)


def image_data(seed: int, n: int = 2048, classes: int = 10, hw: int = 32,
               device=None):
    """Section 5.2's CIFAR-shaped stand-in: class-conditional Gaussian blobs
    over ``hw x hw x 3`` (NHWC float32) and int64 labels."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    protos = rng.standard_normal((classes, hw, hw, 3)).astype(np.float32)
    x = protos[y] + 0.8 * rng.standard_normal((n, hw, hw, 3)).astype(
        np.float32)
    return _tensors(device, x, y)
