"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro.models.moe``: ``MoEConfig``, ``init_moe`` and ``moe_ffn``).

Each batch row is a dispatch group: its ``S * top_k`` choices are sorted
by expert id and the first ``capacity(S)`` choices of each expert fill
that expert's slots of a fixed ``[E, capacity]`` buffer; choices past
capacity drop. The routed FFN is a batched product over the expert axis,
the shared experts (deepseek-v2) a gated MLP on every token, and the
router's auxiliary loss the switch load-balance term plus the router
z-loss, in float32.

The numerics follow the JAX package: the top-k keeps the lowest expert
index among equal probabilities (``lax.top_k``; here a stable descending
sort), the choice sort and its inverse are stable, and the k choices are
reduced choice-major in ``x.dtype``. Every gather's backward is a
permutation or adds exact zeros: a token's k copies are made by a
broadcast whose backward sums them by a reshape, not by a gather that
repeats the token, so the backward adds in a fixed order on the card too.

``balance_group``: the load-balance term's ``ce`` (the fraction of all
top-k choices each expert takes) is JAX's over the whole batch it sees.
Where that batch is split over workers and the gradients averaged (the
FSDP step), the workers' per-expert choice counts are summed over the
group before the division, so that the averaged aux equals JAX's over the
global batch; ``me`` and the z-loss are means and average correctly.

Past one model worker (``dist.tensor_parallel``) the routed experts run
split over ``expert_mlp``: ``w_gate`` and ``w_up`` [E, d, f] by columns,
``w_down`` [E, f, d] by rows. The router, the aux losses, the sort, the
capacity masks and the slots run alike on every worker, outside the
split: the dispatched tokens ``xs`` are copied into it, and each choice's
expert output, unsorted, is summed over the model workers before the
combine weights multiply it, so the gradients of the router and of the
weights are whole on every worker. The shared experts are a split gated
MLP.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.dist import tensor_parallel as tp
from repro_torch.models.layers import gated_mlp

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int                  # hidden width of one routed expert
    num_experts: int
    top_k: int
    num_shared: int = 0            # deepseek-v2 shared experts
    capacity_factor: float = 1.25
    act: str = "silu"
    normalize_weights: bool = True
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 1e-3

    def capacity(self, tokens_per_group: int) -> int:
        c = int(tokens_per_group * self.top_k * self.capacity_factor
                / self.num_experts) + 1
        return max(4, -(-c // 4) * 4)          # round up to a multiple of 4


# the logical axes of each leaf (``repro.models.moe.init_moe``; the shared
# experts a gated MLP's)
MOE_AXES = {"router": ("embed", "experts"),
            "w_gate": ("experts", "embed", "expert_mlp"),
            "w_up": ("experts", "embed", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "embed"),
            "shared/gate": ("embed", "mlp"), "shared/up": ("embed", "mlp"),
            "shared/down": ("mlp", "embed")}


def moe_shapes(cfg: MoEConfig) -> dict[str, tuple[int, ...]]:
    """The MoE FFN's leaves (under ``ffn/``) and their shapes."""
    d, f, e = cfg.d_model, cfg.d_expert, cfg.num_experts
    out = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
           "w_down": (e, f, d)}
    if cfg.num_shared:
        fs = cfg.num_shared * f
        out.update({"shared/gate": (d, fs), "shared/up": (d, fs),
                    "shared/down": (fs, d)})
    return out


def init_moe(ini, cfg: MoEConfig, layers: int | None = None,
             keep=lambda name, t: t) -> dict[str, torch.Tensor]:
    """The JAX package's distributions: the router N(0, d^-0.5), the
    experts N(0, 1/fan-in) with the fan-in on axis 1, the shared gated
    MLP N(0, 1/fan-in) on axis 0; ``layers`` stacks that many copies on a
    leading axis; ``keep(name, leaf)`` takes each leaf as it is drawn (a
    split model's shard, the whole leaf then freed)."""
    p = {}
    for name, shape in moe_shapes(cfg).items():
        if name == "router":
            full = shape if layers is None else (layers,) + shape
            p[name] = keep(name, ini.normal(full, stddev=cfg.d_model ** -0.5))
        else:
            p[name] = keep(name, ini.fan_in(
                shape, 1 if name.startswith("w_") else 0, layers=layers))
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, the lower index
    first among equal values (a stable descending sort)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _choice_fractions(ids: torch.Tensor, e: int,
                      balance_group) -> torch.Tensor:
    """``ce``: each expert's share of the top-k choices, float32 [E], over
    this worker's batch or, with ``balance_group``, every worker's
    (integer counts summed over the group, then one division)."""
    counts = F.one_hot(ids, e).to(F32).sum((0, 1, 2))
    total = torch.full((1,), float(ids.numel()), dtype=F32,
                       device=ids.device)
    if balance_group is not None and dist.get_world_size(balance_group) > 1:
        both = torch.cat([counts, total]).to(torch.float64)
        dist.all_reduce(both, group=balance_group)
        counts, total = both[:e].to(F32), both[e:].to(F32)
    return counts / total


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [B, N, d]`` gathered along axis 1 at ``idx [B, M]``."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def route(p: dict, cfg: MoEConfig, x: torch.Tensor):
    """The router on x [B, S, d]: float32 ``(logits [B, S, E], probs,
    weights [B, S, k], ids [B, S, k])``, the top-k by a stable descending
    sort, the weights normalized with ``normalize_weights``."""
    logits = torch.einsum("bsd,de->bse", x, p["router"]).to(F32)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = _top_k(probs, cfg.top_k)
    if cfg.normalize_weights:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-9)
    return logits, probs, weights, ids


def sort_choices(ids: torch.Tensor, e: int, cap: int):
    """Each batch row's ``S * k`` choices ``ids [B, S, k]`` sorted by expert
    id (stable: token order within an expert): ``(order, sids, keep,
    slots)``, each [B, S * k]; ``keep`` marks the first ``cap`` choices of
    each expert, ``slots`` their slot ``expert * cap + rank`` (clipped for
    the dropped)."""
    b = ids.shape[0]
    ids_f = ids.reshape(b, -1)
    n = ids_f.shape[1]
    order = torch.argsort(ids_f, dim=-1, stable=True)
    sids = torch.gather(ids_f, 1, order)                       # sorted ids
    starts = torch.searchsorted(sids, sids, side="left")
    ranks = torch.arange(n, device=ids.device)[None, :] - starts
    keep = ranks < cap
    slots = torch.clamp_max(sids * cap + ranks, e * cap - 1)   # clipped slot
    return order, sids, keep, slots


def moe_ffn(p: dict, cfg: MoEConfig, x: torch.Tensor, balance_group=None,
            experts_axis=None, shared_axis=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux loss, a 0-d float32). ``p`` holds
    ``router``, ``w_gate``, ``w_up``, ``w_down`` and with shared experts
    ``shared/gate``, ``shared/up``, ``shared/down``. ``experts_axis`` and
    ``shared_axis``: the model axis over which the routed and the shared
    experts run split (``p`` then holds this worker's shards of them;
    module docstring), None where they run whole."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = cfg.capacity(s)
    n = s * k
    dev = x.device

    logits, probs, weights, ids = route(p, cfg, x)             # [B,S,k]

    # ---- load-balance + z aux losses (on the full router output)
    me = probs.mean((0, 1))                                    # [E]
    ce = _choice_fractions(ids, e, balance_group)
    aux = cfg.aux_loss_coef * e * torch.sum(me * ce)
    aux = aux + cfg.z_loss_coef * torch.mean(
        torch.logsumexp(logits, -1) ** 2)

    # ---- sort the choices by expert id within each batch row
    order, sids, keep, slots = sort_choices(ids, e, cap)

    # ---- dispatch: each token's k copies (a broadcast), the sorted order,
    # then each expert's window of slots
    x_rep = x[:, :, None, :].expand(b, s, k, d).reshape(b, n, d)
    x_sorted = _take_rows(x_rep, order) * keep[..., None].to(x.dtype)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    starts_e = torch.searchsorted(sids, experts, side="left")
    ends_e = torch.searchsorted(sids, experts, side="right")
    p_slot = starts_e[..., None] + torch.arange(cap, device=dev)  # [B,E,cap]
    slot_valid = p_slot < torch.minimum(ends_e[..., None],
                                        starts_e[..., None] + cap)
    p_clip = torch.clamp_max(p_slot, n - 1).reshape(b, e * cap)
    xs = _take_rows(x_sorted, p_clip)
    xs = xs * slot_valid.reshape(b, e * cap, 1).to(x.dtype)
    xs = xs.reshape(b, e, cap, d)
    if experts_axis is not None:
        xs = tp.copy_to(xs, experts_axis)

    # ---- expert FFN: batched products over the expert axis
    gate = torch.einsum("becd,edf->becf", xs, p["w_gate"])
    h = (F.gelu(gate, approximate="tanh") if cfg.act == "gelu"
         else F.silu(gate))
    h = h * torch.einsum("becd,edf->becf", xs, p["w_up"])
    ys = torch.einsum("becf,efd->becd", h, p["w_down"])

    # ---- combine: each sorted choice's expert output, unsorted by the
    # inverse permutation, then the k choices reduced
    y_sorted = _take_rows(ys.reshape(b, e * cap, d), slots)
    y_sorted = y_sorted * keep[..., None].to(x.dtype)
    inv_order = torch.argsort(order, dim=-1, stable=True)      # unsort perm
    y_choice = _take_rows(y_sorted, inv_order)
    if experts_axis is not None:    # [B, S*k, d]: fewer rows than ys'
        y_choice = tp.reduce_from(y_choice, experts_axis)
    w_k = weights.reshape(b, s, k, 1).to(x.dtype)              # choice-major
    y = torch.sum(y_choice.reshape(b, s, k, d) * w_k, dim=2)

    if cfg.num_shared:
        y = y + gated_mlp(p["shared/gate"], p["shared/up"],
                          p["shared/down"], x, cfg.act, shared_axis)
    return y, aux
