"""Carry weights and state across from the JAX package: its parameter tree
(nested dicts of arrays, e.g. ``split_params(init_model(...))[0]``
converted with ``np.asarray``) becomes the port's flat parameter dict, so
both packages compute the same function; its decode cache tree
(``init_model_cache``'s values, or what ``forward_prefill`` and
``forward_decode`` return) becomes the port's flat cache dict and back
(``cache_from_jax``, ``cache_to_jax``); its adaptive ``ControlState``
and its ``FeedbackState`` become one worker's (``control_from_jax``,
``feedback_from_jax``).

Checkpoints (``repro_torch.checkpoint``) keep the JAX package's file
format: ``checkpoint_entries`` names each tensor of the port's training
state by its key in a JAX-written ``.npz`` (``params/<leaf path>``,
``opt/step``, ``opt/m/<leaf path>``, ``ef/.residual/<leaf path>``,
``ctl/.bound/<leaf path>``, ...) with its layout there: replicated, or
stacked over the workers or the pods on a leading axis (an fsdp run's
residual is params-shaped and replicated, as the JAX fsdp launcher saves
it).
``numpy_from_tensor`` and ``tensor_from_numpy`` carry a bfloat16 tensor
as the 2-byte ``|V2`` records numpy writes for JAX's bfloat16 arrays,
without ``ml_dtypes``."""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(x, device="cpu") -> torch.Tensor:
    """One array (anything ``np.asarray`` takes) as a tensor; bfloat16
    arrays (numpy's ml_dtypes extension, or the ``|V2`` records
    ``np.savez`` writes for them) keep their bits."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16" or arr.dtype == BF16_RECORD:
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


# how numpy stores a JAX bfloat16 array it cannot name: 2-byte records
BF16_RECORD = np.dtype("V2")


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array for a checkpoint: bfloat16 as ``|V2``
    records of its bits (what ``np.savez`` writes for a JAX bfloat16
    array), every other dtype as itself."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RECORD)
    return t.numpy()


# layouts of a checkpoint entry: the same on every worker, stacked over the
# workers (rank order) or over the pods on a leading axis
REPLICATED, WORKERS, PODS = "replicated", "workers", "pods"


def checkpoint_entries(names: list, params: list, opt_state=None,
                       ef_state=None, ctl_state=None,
                       mode: str = "compressed",
                       sharded_params: bool = False) -> list:
    """``(key, value, layout, leaf)`` of every entry of this worker's training
    state, in the order the JAX package's ``tree_flatten`` writes the tree
    ``{"params", "opt", "ef", "ctl"}`` (absent parts left out). ``names``
    are the leaf paths in the JAX flatten order, ``params`` the leaves in
    that order; ``value`` is a tensor, or an int for a step count (0-d
    int32 in the file). The optimizer state's lists (Adam's ``m`` and
    ``v``, SGD's ``mu``) and ``step`` key as ``opt/<field>``; the
    FeedbackState and ControlState fields as ``.<field>``, which is how
    JAX prints a dataclass attribute in a key path; ``bound`` stacks one
    float32 per worker. The residual stacks over the workers in the
    ``compressed`` mode and is REPLICATED (params-shaped, one per run) in
    the ``fsdp`` mode. ``leaf`` is the index of the leaf whose shape an
    entry of the optimizer, feedback or control state takes (with a model
    axis, this worker's shard of it), None for the parameters (whole on
    every worker; with ``sharded_params``, a split model's, their leaf's
    index too), the bounds and the step counts."""
    if mode not in ("compressed", "fsdp"):
        raise ValueError(f"mode {mode!r}: want compressed or fsdp")
    out = []
    if ctl_state is not None:
        for field, layout in (("last_sent", WORKERS),
                              ("last_avg", REPLICATED), ("bound", WORKERS)):
            out += [(f"ctl/.{field}/{n}", x, layout,
                     None if field == "bound" else i)
                    for i, (n, x) in enumerate(zip(
                        names, getattr(ctl_state, field)))]
        out.append(("ctl/.step", ctl_state.step, REPLICATED, None))
    if ef_state is not None:
        layout = REPLICATED if mode == "fsdp" else WORKERS
        out += [(f"ef/.residual/{n}", x, layout, i)
                for i, (n, x) in enumerate(zip(names, ef_state.residual))]
        if ef_state.pod_residual is not None:
            out += [(f"ef/.pod_residual/{n}", x, PODS, i)
                    for i, (n, x) in enumerate(zip(names,
                                                   ef_state.pod_residual))]
    if opt_state is not None:
        for field in sorted(opt_state):
            if field == "step":
                out.append(("opt/step", opt_state["step"], REPLICATED, None))
            else:
                out += [(f"opt/{field}/{n}", x, REPLICATED, i)
                        for i, (n, x) in enumerate(zip(names,
                                                       opt_state[field]))]
    out += [(f"params/{n}", x, REPLICATED, i if sharded_params else None)
            for i, (n, x) in enumerate(zip(names, params))]
    return out


def params_from_numpy(tree: dict, device="cpu") -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> ``{"a/b/c": tensor}``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
            return
        out[prefix] = tensor_from_numpy(node, device)

    walk(tree, "")
    return out


def shards_from_numpy(tree: dict, model_axis, device="cpu"
                      ) -> dict[str, torch.Tensor]:
    """The JAX parameters (nested dict of numpy arrays) as this worker's
    shards under ``model_axis`` (a ``ModelAxis`` whose specs follow the
    leaves' JAX flatten order): ``params_from_numpy``, then
    ``ModelAxis.shard`` of each leaf, copied; a split model's parameters
    (``Transformer(cfg, ..., tp=...)``)."""
    from repro_torch.models.common import leaf_order
    flat = params_from_numpy(tree, device)
    return {n: model_axis.shard(flat[n], i).clone()
            for i, n in enumerate(leaf_order(flat))}


def cache_from_jax(tree: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The JAX decode cache tree (nested dicts of arrays: ``prelude``,
    ``blocks`` stacked over the periods, ``cross``) -> the port's flat
    cache, keyed ``"blocks/b0_attn_sw/k"`` as ``init_model_cache`` keys
    it."""
    return params_from_numpy(tree, device)


def cache_to_jax(cache: dict[str, torch.Tensor]) -> dict:
    """The port's flat cache -> the JAX cache tree of host arrays (nested
    dicts keyed by the path's parts; bfloat16 as ``numpy_from_tensor``
    writes it)."""
    out: dict = {}
    for path, t in cache.items():
        *parents, leaf = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = numpy_from_tensor(t)
    return out


def _flatten(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in JAX's flatten
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def control_from_jax(ctl, worker: int = 0, device="cpu"):
    """A JAX ``ControlState`` (trees of arrays, the workers stacked on the
    leading axis of ``last_sent`` and ``bound``, ``last_avg`` params-shaped,
    a scalar ``step``) -> worker ``worker``'s port ``ControlState``: lists in
    the JAX flatten order, ``bound`` 0-d float32 tensors, ``step`` an int."""
    from repro_torch.optim.optimizers import ControlState
    return ControlState(
        last_sent=[tensor_from_numpy(np.asarray(x)[worker], device)
                   for x in _flatten(ctl.last_sent)],
        last_avg=[tensor_from_numpy(x, device)
                  for x in _flatten(ctl.last_avg)],
        bound=[tensor_from_numpy(np.asarray(x)[worker], device).to(
            torch.float32).reshape(()) for x in _flatten(ctl.bound)],
        step=int(np.asarray(ctl.step)))


def feedback_from_jax(fb, worker: int = 0, pod: int = 0, device="cpu"):
    """A JAX ``FeedbackState`` of the compressed step (the workers stacked
    on the leading axis of ``residual``; with a pod stage ``pod_residual``
    stacked on a leading pod axis) -> worker ``worker``'s port
    ``FeedbackState`` of pod ``pod``: lists in the JAX flatten order."""
    from repro_torch.optim.optimizers import FeedbackState
    pod_res = None
    if fb.pod_residual is not None:
        pod_res = [tensor_from_numpy(np.asarray(x)[pod], device)
                   for x in _flatten(fb.pod_residual)]
    return FeedbackState(
        residual=[tensor_from_numpy(np.asarray(x)[worker], device)
                  for x in _flatten(fb.residual)],
        pod_residual=pod_res)


def cnn_params_from_jax(tree: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The JAX package's section-5.2 CNN parameters (``init_cnn``'s nested
    dict, as numpy arrays) -> the port's ``{"conv1/w": tensor}`` dict in
    the JAX flatten order (sorted names). The port keeps the JAX layout
    (HWIO kernels, ``fc`` rows in NHWC flatten order; ``experiments.cnn``
    convolves a permuted view), so no array is transposed."""
    return dict(sorted(params_from_numpy(tree, device).items()))
