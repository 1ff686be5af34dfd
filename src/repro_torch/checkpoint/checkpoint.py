"""Checkpoints of the training state in the JAX package's file format
(port of ``repro.checkpoint.checkpoint``: ``save``, ``restore``,
``load_meta``).

One ``.npz`` holds every array under the key JAX's ``tree_flatten_with_path``
gives it (``models.convert.checkpoint_entries``): the parameters under
``params/``, the optimizer's under ``opt/`` (Adam's ``m`` and ``v``, the
step a 0-d int32), the error-feedback residual under ``ef/.residual/`` with
the workers stacked on the leading axis in rank order (the pod residual,
``ef/.pod_residual/``, with the pods), the adaptive control state under
``ctl/.<field>/``; the ``extra`` dict goes to ``<path>.meta.json``. A
bfloat16 leaf is written as the 2-byte ``|V2`` records that numpy writes
for JAX's bfloat16 arrays and read back as the bits of the target leaf.
The file is written entry by entry (``zipfile``, stored, as ``np.savez``
writes it), so the host holds one leaf at a time.

Past one worker (the default process group), ``save`` gathers each
stacked entry to rank 0, which alone writes, and ``restore`` hands every
rank its own slice; ``mesh`` ``(pods, data, model)``
(``launch.train.parse_mesh``'s, ranks model-minor: ``rank = (p * D + d)
* M + m``) places the pod residual, whose copy is taken from each pod's
first data worker. With a model axis (``model_axis``, a
``dist.sharding.ModelAxis``) the optimizer's moments, the residuals and
the control state hold this worker's shard of each leaf: ``save``
all-gathers them over the model group into the global arrays the JAX
launcher writes, and ``restore`` slices them. A stacked entry's row is
its data worker's model index 0's where the leaf is whole: a JAX global
array holds one replica, so past one model worker a resume hands every
model worker of a data index model index 0's residual, ``last_sent`` and
pod residual of a whole leaf (ROADMAP.md queue C). A split model
(``Transformer.tp``: its parameters are shards) saves its parameters
gathered the same way and restores its shards of them, so its file is the
one the gathered step writes for the same parameters and states. In the
fsdp mode past one worker (``model_axis`` an ``dist.sharding.
FsdpLayout``) the parameters, the optimizer's state and the params-shaped
residual are this worker's blocks: ``save`` gathers each leaf over the
data workers, then over the model workers, into the global array, and
``restore`` slices this worker's block.
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import WHOLE, ModelAxis
from repro_torch.models.convert import (PODS, WORKERS, checkpoint_entries,
                                        numpy_from_tensor, tensor_from_numpy)
from repro_torch.models.transformer import param_shapes


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _mesh(mesh, world: int, pods_needed: bool = False
          ) -> tuple[int, int, int]:
    """(pods, data workers a pod, model workers a data worker)."""
    if mesh is None:
        if pods_needed and world > 1:
            raise ValueError("a pod residual past one worker needs the mesh "
                             "(pods, data, model)")
        return 1, world, 1
    pods, data, model = mesh
    pods = pods or 1
    if pods * data * model != world:
        raise ValueError(f"mesh {mesh} does not cover {world} workers")
    return pods, data, model


def _stacked(value: torch.Tensor, layout: str, world: int, rank: int,
             mesh) -> np.ndarray | None:
    """The file's array of a stacked entry, on rank 0 (None elsewhere):
    every worker's ``value`` gathered in rank order, each data worker's
    from its model index 0, for the pods every pod's first data
    worker's."""
    t = value.detach().contiguous()
    if world == 1:
        parts = [t]
    else:
        parts = ([torch.empty_like(t) for _ in range(world)] if rank == 0
                 else None)
        dist.gather(t, parts, dst=0)
        if rank != 0:
            return None
    _, data, model = _mesh(mesh, world, layout == PODS)
    parts = parts[::data * model if layout == PODS else model]
    return numpy_from_tensor(torch.stack(parts))


def _whole(value: torch.Tensor, leaf: int, full_shape, model_axis):
    """The whole leaf from this worker's shard ``value``: all-gathered over
    the model group (``value`` itself where the leaf is not split)."""
    if not model_axis.split(leaf):
        return value
    full = value.new_empty(full_shape)
    model_axis.shard(full, leaf).copy_(value)
    model_axis.gather(full, leaf)
    return full


def _axis(model, model_axis):
    """The axis whose shards the states (and the parameters) hold, and
    whether the parameters are shards: an fsdp layout's
    (``FsdpLayout.params_sharded``), else a split model's own axis, else
    ``model_axis``."""
    if getattr(model_axis, "params_sharded", False):
        return model_axis, True
    if model.tp is not None:
        return model.tp.axis, True
    return model_axis, False


def save(path: str, model, opt_state=None, ef_state=None, ctl_state=None,
         extra: dict | None = None, mesh=None,
         mode: str = "compressed", model_axis: ModelAxis = WHOLE) -> None:
    """Write ``model``'s parameters and the given states to ``path``
    (``.npz`` appended when missing), ``extra`` to ``path +
    ".meta.json"``; ``mode`` the train step's (``convert.
    checkpoint_entries``); ``model_axis`` this worker's (the states then
    hold its shards; a split model's own axis is taken instead). Every
    worker calls it; rank 0 writes."""
    world, rank = _world()
    leaves = model.leaves()
    model_axis, sharded = _axis(model, model_axis)
    shapes = param_shapes(model.cfg)
    entries = checkpoint_entries(model.leaf_names, leaves, opt_state,
                                 ef_state, ctl_state, mode,
                                 sharded_params=sharded)
    zf = None
    if rank == 0:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        zf = zipfile.ZipFile(_npz(path), "w", zipfile.ZIP_STORED,
                             allowZip64=True)
    try:
        for key, value, layout, leaf in entries:
            if leaf is not None:
                value = _whole(value, leaf,
                               shapes[model.leaf_names[leaf]][0], model_axis)
            if isinstance(value, int):
                arr = np.asarray(value, np.int32)
            elif layout in (WORKERS, PODS):
                arr = _stacked(value, layout, world, rank, mesh)
            else:
                arr = numpy_from_tensor(value) if rank == 0 else None
            if zf is not None:
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
            del arr
    finally:
        if zf is not None:
            zf.close()
    if rank == 0 and extra is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)
    if world > 1:
        dist.barrier()


def restore(path: str, model, opt_state=None, ef_state=None, ctl_state=None,
            mesh=None, mode: str = "compressed",
            model_axis: ModelAxis = WHOLE):
    """Read ``path`` into ``model``'s parameters and the given states, in
    place (each tensor keeps its device and dtype; a stacked entry gives
    this rank its own slice, and a leaf-shaped entry this worker's shard
    under ``model_axis``, or a split model's own axis, which slices its
    parameters too). Returns ``(opt_state, ef_state, ctl_state)``
    with the step counts read. Raises ValueError where a shape, a dtype or
    the worker count differs from the file's."""
    world, rank = _world()
    pods, data_n, model_n = _mesh(mesh, world, ef_state is not None
                                  and ef_state.pod_residual is not None)
    pod = rank // (data_n * model_n)
    model_axis, sharded = _axis(model, model_axis)
    steps = {}
    with np.load(_npz(path)) as data:
        for key, target, layout, leaf in checkpoint_entries(
                model.leaf_names, model.leaves(), opt_state, ef_state,
                ctl_state, mode, sharded_params=sharded):
            if key not in data:
                raise ValueError(f"{path}: no entry {key!r}")
            arr = data[key]
            if layout in (WORKERS, PODS):
                want = world // model_n if layout == WORKERS else pods
                if arr.ndim == 0 or arr.shape[0] != want:
                    raise ValueError(f"{key}: stacked over {arr.shape[:1]}, "
                                     f"this run has {want}")
                arr = arr[rank // model_n if layout == WORKERS else pod]
            if isinstance(target, int):
                steps[key] = int(arr)
                continue
            got = tensor_from_numpy(arr)
            if leaf is not None:
                got = model_axis.shard(got, leaf)
            if got.shape != target.shape or got.dtype != target.dtype:
                raise ValueError(f"{key}: file {tuple(got.shape)} {got.dtype}"
                                 f", state {tuple(target.shape)} "
                                 f"{target.dtype}")
            with torch.no_grad():
                target.copy_(got)
    if opt_state is not None:
        opt_state = {**opt_state, "step": steps["opt/step"]}
    if ctl_state is not None:
        ctl_state.step = steps["ctl/.step"]
    return opt_state, ef_state, ctl_state


def load_meta(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)
