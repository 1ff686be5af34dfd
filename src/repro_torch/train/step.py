"""The compressed train step, Algorithm 1 on a data-parallel process group
(port of ``repro.train.step``: ``make_loss_fn``,
``init_compressed_control`` and ``make_compressed_train_step`` with its
error-feedback and adaptive variants).

Every worker process computes its local gradient, compresses it per leaf
(the stacked leaves per layer) and exchanges the compressed messages with
``repro_torch.comm.sync.sync_tree``; every worker then applies the same
averaged update, so the parameters stay replicated. With
``comp.adaptive`` the step also carries the control loop's
``ControlState`` (``train_step_adaptive``'s shape). With a ``pod_group``
the exchange is the pod hierarchy of ``sync_tree`` (the pod stage, with
``comp.resparsify_pods`` Algorithm 1's step 7 on its own residual,
``FeedbackState.pod_residual``).

With a model axis (a ``dist.sharding.ModelAxis``: ``--mesh DxM`` or
``PxDxM``) every (pod, data, model) worker compresses and exchanges its
own shard of every gradient leaf, the shard the JAX rules give it, as the
JAX step's ``shard_local_sync`` does; the model workers of one data index
take the same batch. Two steps get there (``worker_grads``):

- the split step, for a split model (every arch past one model worker,
  ``Transformer.tp``: ``dist.tensor_parallel``): the worker holds
  its shards and its forward and backward run on them, as JAX's GSPMD
  splits them; its gradient of a split leaf is its shard, of a whole leaf
  the whole gradient, and of a whole leaf it read only in part (``wk``,
  ``wv`` where the kv heads do not divide) its share, summed over the
  model workers in rank order; it updates its shards in place and gathers
  nothing;
- the gathered step, for a whole model with a model axis (no launcher
  path takes it: the tests hold the split step to it): the gradient
  computed whole, on the full parameters, its shard kept; after the
  update the parameters are all-gathered over the model group. Its
  gradient is GSPMD's up to the order of float sums (ROADMAP.md queue C).

Each hands its shards to the sync over its data (and pod) group
(``shard_sync``: the delta energies summed over the model workers, the
statistics reduced over them as JAX's ``_reduce_stats``) and updates its
shard of the parameters with its own shard of the optimizer's moments. A
leaf the rules leave whole is compressed by every model worker with its
own stream, as in JAX, and every model worker applies the synced value of
model index 0 (JAX's model replicas of such a leaf would each apply their
own).

``make_prefill_step`` and ``make_decode_step`` are the serving steps
(no compression: gradient sparsification is a training method); they
fill and advance the caches of ``models.transformer.init_model_cache``
in place.

``make_fsdp_train_step`` is the JAX package's fsdp mode: the gradient
averaged over every worker, then Q applied once to the average (Algorithm
1's step 7), with error feedback on a params-shaped residual; with an
``FsdpLayout`` each worker holds its blocks of the parameters and states
under ``FSDP_RULES``, over the data axis and, past one model worker, the
model axis (``dist.fsdp``, ``core.api.compress_tree_sharded``).

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

from repro_torch.comm.sync import (SyncStats, _div_workers,
                                   _worker_order_mean, sync_tree)
from repro_torch.core.api import (CompressionConfig, compress_tree,
                                  compress_tree_sharded)
from repro_torch.dist import fsdp
from repro_torch.dist.sharding import (WHOLE, FsdpLayout, ModelAxis,
                                       sum_in_order)
from repro_torch.models.transformer import (ModelConfig, forward_decode,
                                            forward_prefill, forward_train)
from repro_torch.optim.optimizers import (ControlState, FeedbackState,
                                          Optimizer, init_control,
                                          rescale_feedback)
from repro_torch.train.loss import lm_loss, shift_targets


def make_loss_fn(cfg: ModelConfig, balance_group=None, tp=None) -> Callable:
    """``(params dict, batch) -> scalar loss``: the token-mean cross
    entropy plus the MoE auxiliary loss (``forward_train``'s; 0.0 without
    MoE), as the JAX step forms it. The batch carries ``tokens`` and,
    where the model reads them, ``prefix`` or ``enc_embeds``
    (``launch.specs.train_batch``). An optional ``batch["loss_mask"]``
    ([B, S], 0 or 1) multiplies the next-token mask. ``balance_group``:
    the workers whose batches the load-balance term spans (the FSDP step's
    global batch); None for this worker's own batch. ``tp``: a split
    model's (``Transformer.tp``; ``params`` its shards), the cross entropy
    then vocab-parallel where the table is split; the loss is the whole
    one on every model worker."""
    vocab = None if tp is None else tp.vocab_axis()

    def loss_fn(params, batch):
        logits, aux = forward_train(params, cfg, batch["tokens"],
                                    balance_group,
                                    prefix=batch.get("prefix"),
                                    enc_embeds=batch.get("enc_embeds"),
                                    tp=tp)
        targets, mask = shift_targets(batch["tokens"])
        if "loss_mask" in batch:
            mask = mask * batch["loss_mask"]
        return lm_loss(logits, targets, mask, vocab) + aux
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


def _local_grads(model, params: list, loss_fn: Callable, batch):
    """This worker's loss on ``batch`` and the gradient of each of
    ``params`` (the model's leaves), taken off the leaves; a leaf the loss
    never reads (zamba2's shared sites' ``ln1``) gets exact zeros of its
    shape and dtype, as ``jax.grad`` gives it."""
    for p in params:
        p.grad = None
    loss = loss_fn(dict(model.params), batch)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    for p in params:
        p.grad = None
    return loss, grads


def worker_leaves(model, model_axis: ModelAxis = WHOLE) -> list:
    """What this worker's optimizer updates and its per-leaf states are
    shaped like: its shard of each of ``model``'s leaves (views into the
    leaves; the leaves' data at one model worker and for a split model,
    which holds its shards)."""
    if model.tp is not None:
        return [p.data for p in model.leaves()]
    return [model_axis.shard(p.data, i) for i, p in enumerate(model.leaves())]


def worker_grads(model, model_axis: ModelAxis, loss_fn: Callable, batch):
    """This worker's loss on ``batch`` and its shard of each leaf's
    gradient, contiguous: what it hands to ``shard_sync``. A split model
    (``model.tp``; its own axis) yields its shards from its backward, a
    ``PARTIAL`` leaf's share summed over the model workers in rank order;
    a whole model (the gathered step) computes the whole gradient and
    keeps ``model_axis``'s shard of it."""
    params = model.leaves()
    loss, grads = _local_grads(model, params, loss_fn, batch)
    if model.tp is not None:
        ma = model.tp.axis
        return loss, [ma.sum_in_rank_order(g.contiguous()) if ma.partial(i)
                      else g.contiguous() for i, g in enumerate(grads)]
    return loss, [model_axis.shard(g, i).contiguous()
                  for i, g in enumerate(grads)]


def init_compressed_control(model, comp: CompressionConfig,
                            model_axis: ModelAxis = WHOLE) -> ControlState:
    """Zero ControlState for the adaptive step of ``model`` (this worker's:
    ``last_sent`` and ``last_avg`` like its leaves, or its shards of them,
    one bound per leaf)."""
    if not comp.adaptive:
        raise ValueError("init_compressed_control with adaptive=False")
    return init_control(worker_leaves(model, model_axis))


# the statistics summed over the model workers (each shard sends its own
# message); the others (density, var_ratio, skipped) are averaged
MODEL_SUMS = ("bits", "dense_bits", "wire_bytes", "wire_bytes_intra",
              "wire_bytes_inter", "overflow")


def stats_vector(stats: SyncStats) -> torch.Tensor:
    """``SyncStats.FIELDS`` of ``stats`` as one float64 vector (exact: the
    fields are float32 or float64)."""
    return torch.stack([getattr(stats, f).to(torch.float64).reshape(())
                        for f in SyncStats.FIELDS])


def reduce_over_model(rows: torch.Tensor, like: SyncStats) -> SyncStats:
    """JAX's ``_reduce_stats`` over the model axis: ``rows`` [M, 9] holds
    every model worker's ``stats_vector`` in rank order; each field is
    taken back to its dtype in ``like``, summed in rank order and, past
    ``MODEL_SUMS``, divided by M (an IEEE quotient). ``layouts`` are
    ``like``'s."""
    m = rows.shape[0]
    out = {}
    for j, f in enumerate(SyncStats.FIELDS):
        col = rows[:, j].to(getattr(like, f).dtype)
        acc = sum_in_order(col)
        out[f] = acc if f in MODEL_SUMS else _div_workers(acc, m)
    return SyncStats(**out, layouts=like.layouts)


def shard_sync(comp: CompressionConfig, generator: torch.Generator,
               shards: list, *, group=None, pod_group=None,
               pod_generator: torch.Generator | None = None,
               stacked: list | None = None, feedback=None, control=None,
               model_stack=None):
    """The per-shard half of the compressed step: ``sync_tree`` on this
    worker's shards (compress, exchange over ``group`` and ``pod_group``),
    with the leaves' delta energies summed over the model workers, then its
    statistics reduced over them (``reduce_over_model``). ``model_stack``
    maps a tensor to the ``[M, ...]`` stack of every model worker's
    (``ModelAxis.stack``: an all-gather over the model group); None leaves
    both unreduced: at one model worker (``ModelAxis.reduction``), or for
    a caller that drives every shard in one process and reduces the
    statistics itself. Returns ``sync_tree``'s tuple."""
    energy_sum = (None if model_stack is None
                  else lambda x: sum_in_order(model_stack(x)))
    out = sync_tree(comp, generator, shards, group=group,
                    pod_group=pod_group, pod_generator=pod_generator,
                    stacked=stacked, feedback=feedback, control=control,
                    energy_sum=energy_sum)
    if model_stack is None:
        return out
    stats = out[-1]
    return out[:-1] + (reduce_over_model(model_stack(stats_vector(stats)),
                                         stats),)


def make_compressed_train_step(model, comp: CompressionConfig,
                               opt: Optimizer, group=None, pod_group=None,
                               var_adaptive_lr: bool = False,
                               lr_schedule: Callable | None = None,
                               pod_generator: torch.Generator | None = None,
                               model_axis: ModelAxis = WHOLE,
                               worker_group=None) -> Callable:
    """Algorithm 1 for ``model`` (a ``Transformer``) on the workers of
    ``group`` (the default process group when None), and with a
    ``pod_group`` between the pods too (``sync_tree``'s pod hierarchy:
    ``group`` is then this worker's pod, ``pod_group`` its peers of the
    other pods; ``pod_generator``, seeded alike on a pod's data workers,
    draws the pod stage's uniforms under ``comp.resparsify_pods``, and
    with error feedback ``ef_state`` carries ``pod_residual``:
    ``init_feedback(params, pod=True)``). Metrics are then averaged over
    every worker of both groups (the default process group).

    ``model_axis`` (a ``dist.sharding.ModelAxis``; ``WHOLE``, one model
    worker, by default): this worker's place on the model axis (module
    docstring): a whole ``model`` takes the gathered step on it, a split
    one (``model.tp``) the split step on its own ``tp.axis``; ``group``
    and ``pod_group`` are this model index's, and ``worker_group`` holds
    every (pod, data) worker of this model index, over which the metrics
    are averaged (default: the data group, or with pods every worker).
    ``opt_state``, ``ef_state`` and ``ctl_state`` are shaped like this
    worker's shards (``worker_leaves``).

    Without error feedback: ``step(opt_state, batch, generator) ->
    (opt_state, metrics)``. With ``comp.error_feedback``: ``step(opt_state,
    ef_state, batch, generator) -> (opt_state, ef_state, metrics)``, where
    ``ef_state`` is this worker's FeedbackState. With ``comp.adaptive``:
    ``step(opt_state, ef_state, ctl_state, batch, generator) ->
    (opt_state, ef_state, ctl_state, metrics)``, ``ctl_state`` this
    worker's ControlState (``init_compressed_control``; the one passed in
    is spent: carry the returned one). The model's parameters are
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
    if comp.resparsify_pods and pod_group is not None \
            and pod_generator is None:
        raise ValueError("resparsify_pods with a pod group needs a "
                         "pod_generator")
    loss_fn = make_loss_fn(model.cfg, tp=model.tp)
    params = model.leaves()
    split = model.tp is not None
    ma = model.tp.axis if split else model_axis
    targets = worker_leaves(model, ma)    # what the optimizer updates
    # the stats' mean: over the data group, or with pods over every worker
    stats_group = worker_group if worker_group is not None else (
        group if pod_group is None else None)
    layouts: list = []          # a holder, so that no closure cycle keeps
                                # the model alive after the step is dropped

    def _step(opt_state, ef_state, ctl_state, batch, generator):
        loss, grads = worker_grads(model, ma, loss_fn, batch)
        if lr_schedule is not None and ef_state is not None:
            t = opt_state["step"]
            lr_now = lr_schedule(t + 1)
            rescale_feedback(ef_state, lr_schedule(t) if t > 0 else lr_now,
                             lr_now)
        out = shard_sync(comp, generator, grads, group=group,
                         pod_group=pod_group, pod_generator=pod_generator,
                         stacked=model.stacked, feedback=ef_state,
                         control=ctl_state,
                         model_stack=ma.reduction)
        synced, new_fb, stats = out[0], out[1], out[-1]
        new_ctl = out[2] if ctl_state is not None else None
        del grads, out
        for i, s in enumerate(synced):   # a whole leaf: model index 0's
            if not ma.split(i):
                ma.broadcast(s)
        vals = _mean_over_workers(
            [loss.detach()] + [getattr(stats, f) for f in SyncStats.FIELDS],
            stats_group)
        metrics = dict(zip(("loss",) + SyncStats.FIELDS, vals))
        var_scale = (_var_scale(stats.var_ratio, stats_group)
                     if var_adaptive_lr else 1.0)
        _, opt_state = opt.update(synced, opt_state, targets,
                                  var_scale=var_scale)
        del synced
        if not split:             # the gathered step: the whole leaves back
            for i, p in enumerate(params):
                ma.gather(p.data, i)
        layouts[:] = stats.layouts
        return opt_state, new_fb, new_ctl, metrics

    if comp.adaptive:
        def step(opt_state, ef_state: FeedbackState, ctl_state: ControlState,
                 batch, generator):
            return _step(opt_state, ef_state, ctl_state, batch, generator)
    elif comp.error_feedback:
        def step(opt_state, ef_state: FeedbackState, batch, generator):
            opt_state, ef_state, _, metrics = _step(opt_state, ef_state,
                                                    None, batch, generator)
            return opt_state, ef_state, metrics
    else:
        def step(opt_state, batch, generator):
            opt_state, _, _, metrics = _step(opt_state, None, None, batch,
                                             generator)
            return opt_state, metrics
    step.layouts = layouts
    return step


def make_fsdp_train_step(model, comp: CompressionConfig | None,
                         opt: Optimizer, layout: FsdpLayout | None = None,
                         uniforms: Callable | None = None) -> Callable:
    """The JAX package's fsdp step for ``model``.

    With a ``layout`` (a ``dist.sharding.FsdpLayout``: the launcher's past
    one worker) ``model`` holds this worker's blocks of every leaf under
    ``FSDP_RULES`` (a split model past one model worker, ``model.tp``
    with ``layout.model``), and so do the optimizer's state and the
    residual: the forward gathers each leaf over the data workers just
    before use, the backward scatters its gradient back averaged over them
    (``dist.fsdp.shard_grads``), and Q is applied once to the averaged
    tree, each row's lambda formed over its shards
    (``core.api.compress_tree_sharded``) and every shard of a block drawing
    the same uniforms, from a stream keyed by ``generator.initial_seed()``,
    the optimizer's step count and the shard's place
    (``dist.fsdp.KeyedUniforms``; ``uniforms(step)`` gives the draw
    instead, for tests: a callable ``(leaf, row, block, n) -> [n]``). The
    MoE load-balance term spans ``layout.data``'s workers. Metrics as
    below, the same on every worker.

    Without a layout, on every worker of the default process group
    (every leaf whole on each): each worker computes
    the gradient of its share of the global batch, the gradients are
    averaged over the workers in worker order (the dense exchange's
    ``_worker_order_mean``, in place, leaf by leaf; none at one worker),
    and with a compressor other than ``none`` Q is applied once to the
    averaged tree (``compress_tree``: Algorithm 1's step 7, unbiased
    whatever the sharding) before the optimizer. Every worker draws the
    same uniforms (``generator`` seeded alike on every rank), so the
    replicas stay equal. ``comp.wire``, its layouts and the exchange do not
    act here, as in JAX.

    The MoE load-balance term spans the global batch: each worker's
    per-expert choice counts are summed over the workers before the division
    (``make_loss_fn``'s ``balance_group``), so the averaged gradient and
    loss are JAX's over the global batch.

    Without error feedback: ``step(opt_state, batch, generator) ->
    (opt_state, metrics)``; with ``comp.error_feedback``: ``step(opt_state,
    ef_state, batch, generator) -> (opt_state, ef_state, metrics)``, the
    residual of the averaged gradient params-shaped (``init_feedback``;
    one per run, the same on every worker). Metrics: ``loss`` (float64,
    the workers' mean) and, when compressing, ``bits``, ``density`` and
    ``var_ratio`` of the averaged tree. The parameters are updated in place
    and stay replicated."""
    if layout is not None:
        return _sharded_fsdp_step(model, comp, opt, layout, uniforms)
    compress = comp is not None and comp.name != "none"
    ef = compress and comp.error_feedback
    grp = dist.group.WORLD
    loss_fn = make_loss_fn(model.cfg, balance_group=grp)
    params = model.leaves()
    stacked = model.stacked

    def _step(opt_state, ef_state, batch, generator):
        loss, grads = _local_grads(model, params, loss_fn, batch)
        m = dist.get_world_size(grp)
        if m > 1:
            for g in grads:
                _worker_order_mean(g.view(-1), m, grp)
        metrics = {"loss": _mean_over_workers([loss.detach()], grp)[0]}
        new_fb = None
        if compress:
            q, res, stats = compress_tree(
                comp, generator, grads, stacked=stacked,
                residual=ef_state.residual if ef else None)
            grads = q
            metrics.update(bits=stats.bits, density=stats.density,
                           var_ratio=stats.var_ratio)
            if ef:
                new_fb = FeedbackState(residual=res)
        _, opt_state = opt.update(grads, opt_state, params)
        return opt_state, new_fb, metrics

    if ef:
        def step(opt_state, ef_state: FeedbackState, batch, generator):
            return _step(opt_state, ef_state, batch, generator)
    else:
        def step(opt_state, batch, generator):
            opt_state, _, metrics = _step(opt_state, None, batch, generator)
            return opt_state, metrics
    return step


def _sharded_fsdp_step(model, comp, opt: Optimizer, layout: FsdpLayout,
                       uniforms: Callable | None) -> Callable:
    """``make_fsdp_train_step`` with a layout."""
    compress = comp is not None and comp.name != "none"
    ef = compress and comp.error_feedback
    loss_fn = make_loss_fn(model.cfg, balance_group=layout.data.group,
                           tp=model.tp)
    params = model.leaves()
    stacked = model.stacked
    calls = [0]          # the step count where the optimizer keeps none

    def _step(opt_state, ef_state, batch, generator):
        loss, grads = fsdp.shard_grads(model, layout, loss_fn, batch)
        metrics = {"loss": _mean_over_workers([loss.detach()],
                                              layout.data.group)[0]}
        new_fb = None
        if compress:
            t = opt_state.get("step", calls[0])
            draw = (uniforms(t) if uniforms is not None else
                    fsdp.KeyedUniforms(generator.initial_seed(), t,
                                       grads[0].device))
            grads, res, stats = compress_tree_sharded(
                comp, grads, layout, stacked,
                ef_state.residual if ef else None, draw)
            metrics.update(bits=stats.bits, density=stats.density,
                           var_ratio=stats.var_ratio)
            if ef:
                new_fb = FeedbackState(residual=res)
        calls[0] += 1
        _, opt_state = opt.update(grads, opt_state, params)
        return opt_state, new_fb, metrics

    if ef:
        def step(opt_state, ef_state: FeedbackState, batch, generator):
            return _step(opt_state, ef_state, batch, generator)
    else:
        def step(opt_state, batch, generator):
            opt_state, _, metrics = _step(opt_state, None, batch, generator)
            return opt_state, metrics
    return step


# ---------------------------------------------------------------------------
# Serving steps (no compression: gradient sparsification is a training method)
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``(params dict, batch, caches) -> the last position's logits``
    [B, 1, vocab]; the caches are filled in place (``forward_prefill``)."""
    def prefill_step(params, batch, caches):
        return forward_prefill(params, cfg, batch, caches)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``(params dict, caches, tokens [B, 1], pos) -> logits`` [B, 1,
    vocab]; the caches are advanced in place (``forward_decode``)."""
    def decode_step(params, caches, tokens, pos):
        return forward_decode(params, cfg, tokens, caches, pos)
    return decode_step
