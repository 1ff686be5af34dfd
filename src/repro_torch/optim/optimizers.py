"""Optimizers and error-feedback state (port of the parts of
``repro.optim.optimizers`` this slice uses: ``sgd``, ``adam``,
``FeedbackState`` and ``init_feedback``).

The JAX optimizers are pure functions over pytrees. Here an optimizer
updates the parameter tensors and its moments in place (a 2.5e9-parameter
model cannot afford a second copy of either) and returns them, so the call
shape ``update(grads, state, params) -> (params, state)`` stays the JAX one.
The arithmetic follows the JAX expressions term by term in float32.

``ControlState``, ``rescale_feedback`` and SVRG are ROADMAP.md queue A
item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[list], Any]
    update: Callable[..., tuple[list, Any]]


@dataclasses.dataclass
class FeedbackState:
    """Per-worker error-feedback residual (Seide et al. 2014): what this
    worker wanted to send minus what the compressed wire carried, one tensor
    per leaf, shaped like the leaf. Each worker process holds its own (the
    JAX step's leading per-worker axis is one process each here)."""
    residual: list
    pod_residual: Any = None


def init_feedback(params: list) -> FeedbackState:
    """Zero residual state, one tensor like each leaf."""
    return FeedbackState(residual=[torch.zeros_like(p) for p in params])


def sgd(lr: float | Callable[[int], float], momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"step": 0, "mu": [torch.zeros_like(p) for p in params]}
        return {"step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        eta = lr(step) if callable(lr) else lr
        if weight_decay:
            grads = [g + weight_decay * p for g, p in zip(grads, params)]
        if momentum:
            for mu, g in zip(state["mu"], grads):
                mu.mul_(momentum).add_(g)
            grads = state["mu"]
        for p, g in zip(params, grads):
            p.sub_(eta * g)
        return params, {**state, "step": step}

    return Optimizer(init, update)


def adam(lr: float | Callable[[int], float], b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
         moment_dtype: torch.dtype = F32) -> Optimizer:
    """Adam/AdamW with ``moment_dtype`` moments (float32 by default)."""
    def init(params):
        return {"step": 0,
                "m": [torch.zeros_like(p, dtype=moment_dtype)
                      for p in params],
                "v": [torch.zeros_like(p, dtype=moment_dtype)
                      for p in params]}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        eta = lr(step) if callable(lr) else lr
        t = torch.tensor(float(step), dtype=F32)
        bc1 = float(1 - b1 ** t)             # float32 pow, as in JAX
        bc2 = float(1 - b2 ** t)
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            g32 = g.to(F32)
            m32 = m.to(F32).mul_(b1).add_(g32 * (1 - b1))
            v32 = v.to(F32).mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
            del g32
            upd = (v32 / bc2).sqrt_().add_(eps)
            upd = (m32 / bc1).div_(upd)
            if weight_decay:
                upd.add_(weight_decay * p.to(F32))
            p.copy_(p.to(F32).sub_(upd.mul_(eta)))
            m.copy_(m32)
            v.copy_(v32)
        return params, {**state, "step": step}

    return Optimizer(init, update)
