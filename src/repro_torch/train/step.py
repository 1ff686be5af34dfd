"""The compressed train step, Algorithm 1 on a data-parallel process group
(port of ``repro.train.step``: ``make_loss_fn`` and
``make_compressed_train_step``).

Every worker process computes its local gradient, compresses it per leaf
(the stacked leaves per layer) and exchanges the compressed messages with
``repro_torch.comm.sync.sync_tree``; every worker then applies the same
averaged update, so the parameters stay replicated. The FSDP step, the pod
hierarchy and the adaptive control state are ROADMAP.md queue A item 10.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.comm.sync import SyncStats, sync_tree
from repro_torch.core.api import CompressionConfig
from repro_torch.models.transformer import ModelConfig, forward_train
from repro_torch.optim.optimizers import FeedbackState, Optimizer
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


def make_compressed_train_step(model, comp: CompressionConfig,
                               opt: Optimizer, group=None) -> Callable:
    """Algorithm 1 for ``model`` (a ``Transformer``) on the workers of
    ``group`` (the default process group when None).

    Without error feedback: ``step(opt_state, batch, generator) ->
    (opt_state, metrics)``. With ``comp.error_feedback``: ``step(opt_state,
    ef_state, batch, generator) -> (opt_state, ef_state, metrics)``, where
    ``ef_state`` is this worker's FeedbackState. The model's parameters are
    updated in place; ``generator`` draws this worker's compression
    uniforms. Metrics are float64 scalars on the model's device, averaged
    over the workers. After each call, ``step.layouts`` holds the ``(rows,
    d, k_cap, layout)`` stamped on each sparse group (``SyncStats.layouts``)."""
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
        synced, new_fb, stats = sync_tree(
            comp, generator, grads, group=group, stacked=model.stacked,
            feedback=ef_state)
        del grads
        vals = _mean_over_workers(
            [loss.detach()] + [getattr(stats, f) for f in SyncStats.FIELDS],
            group)
        metrics = dict(zip(("loss",) + SyncStats.FIELDS, vals))
        _, opt_state = opt.update(synced, opt_state, params)
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
