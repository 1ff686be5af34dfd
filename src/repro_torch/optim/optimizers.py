"""Optimizers, error-feedback and control state (port of
``repro.optim.optimizers``: ``sgd``, ``adam``, ``SVRG``, ``FeedbackState``,
``init_feedback``, ``ControlState``, ``init_control``,
``rescale_feedback`` and ``make_optimizer``).

The JAX optimizers are pure functions over pytrees. Here an optimizer
updates the parameter tensors and its moments in place (a 2.5e9-parameter
model cannot afford a second copy of either) and returns them, so the call
shape ``update(grads, state, params) -> (params, state)`` stays the JAX one.
The arithmetic follows the JAX expressions term by term in float32.

Step-size conventions of the paper's experiments (section 5.1):
sparsified SGD takes ``eta_t ~ 1 / (t var)``, sparsified SVRG ``eta ~ 1 /
var``, with ``var = ||Q(g)||^2 / ||g||^2``; ``update`` takes an optional
``var_scale`` for it. The step size is ``lr_t / var_scale``. Where JAX forms
it as a float32 array (a ``var_scale`` array or a callable ``lr``) it is a
float32 tensor on the parameters' device here, a tensor quotient: PyTorch's
``float / tensor`` multiplies by the reciprocal, and a CUDA tensor divided
by a Python number does too, neither an IEEE quotient. With such a step
size JAX's ``sgd`` promotes a bfloat16 parameter to float32 (its result is
float32); the port keeps the parameter bfloat16 and rounds JAX's float32
value once (ROADMAP.md C).
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
    JAX step's leading per-worker axis is one process each here).
    ``pod_residual`` is the pod stage's residual of the hierarchical sync
    (ROADMAP.md queue A item 9); None without one."""
    residual: list
    pod_residual: Any = None


def init_feedback(params: list) -> FeedbackState:
    """Zero residual state, one tensor like each leaf."""
    return FeedbackState(residual=[torch.zeros_like(p) for p in params])


@dataclasses.dataclass
class ControlState:
    """The adaptive control loop's state (``CompressionConfig.adaptive``,
    consumed by ``comm.sync.sync_tree``) of this worker: ``last_sent``, the
    EMA of what its wire carried, and ``last_avg``, the EMA of the synced
    average, each shaped like the leaves; ``bound``, one float32 energy
    scalar per leaf, 0-d tensors on the leaves' device (read and written
    there, no host sync); ``step``, the step count, a Python int that
    ``sync_tree`` advances (0 primes the bound and never skips). The JAX
    state stacks the workers' ``last_sent`` and ``bound`` on a leading
    axis; here each worker process holds its own
    (``models.convert.control_from_jax`` takes one worker's slice)."""
    last_sent: list
    last_avg: list
    bound: list
    step: int = 0


def init_control(params: list) -> ControlState:
    """Zero control state: delta coding starts from ``last_sent = 0``, so
    the first adaptive step sends the full gradient."""
    return ControlState(
        last_sent=[torch.zeros_like(p) for p in params],
        last_avg=[torch.zeros_like(p) for p in params],
        bound=[torch.zeros((), dtype=F32, device=p.device) for p in params])


def _f32(x, device) -> torch.Tensor:
    """``x`` (a Python number or a tensor) as a 0-d float32 tensor on
    ``device``, with no host sync."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F32)
    return torch.full((), x, dtype=F32, device=device)


def rescale_feedback(fb: FeedbackState, lr_prev, lr_now) -> FeedbackState:
    """Momentum-corrected error feedback (Karimireddy et al. 2019): the
    residual lives in the lr-scaled update domain, so when the schedule
    moves the step size it is rescaled by ``lr_prev / lr_now`` (a float32
    quotient; 1.0 where ``lr_now == 0``: no update domain to map into)
    before compression. In place, one leaf at a time (a float32 copy of
    one leaf at most): each residual and ``pod_residual`` leaf becomes
    ``(x.float() * ratio).to(x.dtype)``, so a constant schedule is a
    bit-exact no-op. Returns ``fb``."""
    leaves = list(fb.residual) + list(fb.pod_residual or [])
    if not leaves:
        return fb
    dev = leaves[0].device
    prev, now = _f32(lr_prev, dev), _f32(lr_now, dev)
    ok = now != 0
    ratio = torch.where(ok, prev / torch.where(ok, now, 1.0), 1.0)
    with torch.no_grad():
        for x in leaves:
            x.copy_(x.to(F32).mul_(ratio))
    return fb


def _step_size(lr, step: int, var_scale, device):
    """``lr_t / var_scale``: a Python float where JAX's is one (a float lr
    and ``var_scale`` a number), else a 0-d float32 tensor on ``device``
    (``full_like(var_scale, lr_t) / var_scale``)."""
    lr_t = lr(step) if callable(lr) else lr
    if not callable(lr) and not isinstance(var_scale, torch.Tensor):
        return lr_t / var_scale
    return _f32(lr_t, device) / _f32(var_scale, device)


def sgd(lr: float | Callable[[int], Any], momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"step": 0, "mu": [torch.zeros_like(p) for p in params]}
        return {"step": 0}

    @torch.no_grad()
    def update(grads, state, params, var_scale=1.0):
        step = state["step"] + 1
        eta = _step_size(lr, step, var_scale, params[0].device)
        if weight_decay:
            grads = [g + weight_decay * p for g, p in zip(grads, params)]
        if momentum:
            for mu, g in zip(state["mu"], grads):
                mu.mul_(momentum).add_(g)
            grads = state["mu"]
        for p, g in zip(params, grads):
            if isinstance(eta, torch.Tensor) and p.dtype != F32:
                # JAX promotes to float32 here: round its value once
                p.copy_(p.to(F32).sub_(g.to(F32, copy=True).mul_(eta)))
            else:
                p.sub_(eta * g)
        return params, {**state, "step": step}

    return Optimizer(init, update)


def adam(lr: float | Callable[[int], Any], b1: float = 0.9,
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
    def update(grads, state, params, var_scale=1.0):
        step = state["step"] + 1
        dev = params[0].device
        eta = _step_size(lr, step, var_scale, dev)
        t = torch.tensor(float(step), dtype=F32)
        # float32 pow, as in JAX; divisors on the device: PyTorch's CUDA
        # division by a Python number multiplies by its reciprocal
        bc1 = _f32(float(1 - b1 ** t), dev)
        bc2 = _f32(float(1 - b2 ** t), dev)
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


@dataclasses.dataclass(frozen=True)
class SVRG:
    """SVRG control variate (Johnson & Zhang 2013), the paper's second base
    algorithm: a reference point w~ and its full gradient; the
    variance-reduced gradient is ``g(w) - g(w~) + full_grad(w~)``. The
    sparsified variant ``Q(g(w) - g(w~)) + full_grad(w~)`` is the paper's
    equation (15): only the correction is sparsified."""
    inner: Optimizer

    def init(self, params):
        return {"opt": self.inner.init(params),
                "ref_params": [p.detach().clone() for p in params],
                "ref_grad": [torch.zeros_like(p) for p in params]}

    def set_reference(self, state, params, full_grad):
        return {**state, "ref_params": [p.detach().clone() for p in params],
                "ref_grad": full_grad}

    def correct(self, state, grads_w, grads_ref):
        """``g(w) - g(w~)``; add ``state["ref_grad"]`` after the (optional)
        sparsification."""
        del state
        return [a - b for a, b in zip(grads_w, grads_ref)]

    def update(self, vr_grads, state, params, var_scale=1.0):
        params, opt_state = self.inner.update(vr_grads, state["opt"],
                                              params, var_scale=var_scale)
        return params, {**state, "opt": opt_state}


OPTIMIZERS = {"sgd": sgd, "adam": adam}


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}")
    return OPTIMIZERS[name](lr, **kw)
