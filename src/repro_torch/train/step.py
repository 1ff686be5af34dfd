"""The compressed train step, Algorithm 1 on a data-parallel process group
(port of ``repro.train.step``: ``make_loss_fn`` and
``make_compressed_train_step``).

Every worker process computes its local gradient, compresses it per leaf
(the stacked leaves per layer) and exchanges the compressed messages with
``repro_torch.comm.sync.sync_tree``; every worker then applies the same
averaged update, so the parameters stay replicated. The FSDP step, the pod
hierarchy and the adaptive control state are ROADMAP.md queue A item 10.

The step's step-size options are the JAX step's: ``var_adaptive_lr``
divides the optimizer's step size by ``max(var, 1)`` (the paper's eta ~
1/var), and ``lr_schedule`` with error feedback rescales the carried
residual by ``lr_prev / lr_now`` before each sync (momentum-corrected
error feedback, ``optimizers.rescale_feedback``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.comm.sync import SyncStats, _worker_order_mean, sync_tree
from repro_torch.core.api import CompressionConfig
from repro_torch.models.transformer import ModelConfig, forward_train
from repro_torch.optim.optimizers import (FeedbackState, Optimizer,
                                          rescale_feedback)
from repro_torch.train.loss import lm_loss, shift_targets


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """``(params dict, batch) -> scalar loss``."""
    def loss_fn(params, batch):
        logits = forward_train(params, cfg, batch["tokens"])
        targets, mask = shift_targets(batch["tokens"])
        return lm_loss(logits, targets, mask)
    return loss_fn


def _mean_over_workers(xs: list[torch.Tensor], group) -> list[torch.Tensor]:
    """pmean over the data-parallel group, as one all-reduce, in float64 so
    that the wire byte counts stay exact."""
    m = dist.get_world_size(group)
    flat = torch.stack([x.to(torch.float64) for x in xs])
    dist.all_reduce(flat, group=group)
    return list((flat / m).unbind())


def _var_scale(var_ratio: torch.Tensor, group) -> torch.Tensor:
    """``max(var, 1)``, float32 on the device, with ``var`` the workers'
    float32 variance ratios averaged in worker order as the dense exchange
    averages (``_worker_order_mean``), so that every replica applies the
    same step size; this worker's own ratio at one worker, as in the JAX
    step."""
    v = var_ratio.to(torch.float32).reshape(1).clone()
    m = dist.get_world_size(group)
    if m > 1:
        _worker_order_mean(v, m, group)
    return torch.clamp_min(v.reshape(()), 1.0)


def make_compressed_train_step(model, comp: CompressionConfig,
                               opt: Optimizer, group=None,
                               var_adaptive_lr: bool = False,
                               lr_schedule: Callable | None = None
                               ) -> Callable:
    """Algorithm 1 for ``model`` (a ``Transformer``) on the workers of
    ``group`` (the default process group when None).

    Without error feedback: ``step(opt_state, batch, generator) ->
    (opt_state, metrics)``. With ``comp.error_feedback``: ``step(opt_state,
    ef_state, batch, generator) -> (opt_state, ef_state, metrics)``, where
    ``ef_state`` is this worker's FeedbackState. The model's parameters are
    updated in place; ``generator`` draws this worker's compression
    uniforms. Metrics are float64 scalars on the model's device, averaged
    over the workers. After each call, ``step.layouts`` holds the ``(rows,
    d, k_cap, layout)`` stamped on each sparse group (``SyncStats.layouts``).

    ``var_adaptive_lr``: the optimizer's step size is divided by ``max(var,
    1)``, ``var`` from ``sync_tree``'s float32 stats averaged over the
    workers (``_var_scale``). ``lr_schedule``: the optimizer's step-size
    schedule (pass the same callable to the optimizer as its lr); with
    error feedback, before update t the carried residual is rescaled in
    place by ``lr_schedule(t) / lr_schedule(t + 1)`` (by 1 at t = 0).
    Without either option the step is the plain one."""
    loss_fn = make_loss_fn(model.cfg)
    params = model.leaves()
    layouts: list = []          # a holder, so that no closure cycle keeps
                                # the model alive after the step is dropped

    def _step(opt_state, ef_state, batch, generator):
        for p in params:
            p.grad = None
        loss = loss_fn(dict(model.params), batch)
        loss.backward()
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        if lr_schedule is not None and ef_state is not None:
            t = opt_state["step"]
            lr_now = lr_schedule(t + 1)
            rescale_feedback(ef_state, lr_schedule(t) if t > 0 else lr_now,
                             lr_now)
        synced, new_fb, stats = sync_tree(
            comp, generator, grads, group=group, stacked=model.stacked,
            feedback=ef_state)
        del grads
        vals = _mean_over_workers(
            [loss.detach()] + [getattr(stats, f) for f in SyncStats.FIELDS],
            group)
        metrics = dict(zip(("loss",) + SyncStats.FIELDS, vals))
        var_scale = (_var_scale(stats.var_ratio, group) if var_adaptive_lr
                     else 1.0)
        _, opt_state = opt.update(synced, opt_state, params,
                                  var_scale=var_scale)
        layouts[:] = stats.layouts
        return opt_state, new_fb, metrics

    if comp.error_feedback:
        def step(opt_state, ef_state: FeedbackState, batch, generator):
            return _step(opt_state, ef_state, batch, generator)
    else:
        def step(opt_state, batch, generator):
            opt_state, _, metrics = _step(opt_state, None, batch, generator)
            return opt_state, metrics
    step.layouts = layouts
    return step
