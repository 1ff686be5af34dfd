"""The public surface of the port, in one import (port of ``repro.api``,
with the same ``__all__``)::

    from repro_torch.api import CompressionConfig, sync_tree, init_feedback

- configure: ``CompressionConfig`` (frozen; validates at construction,
  ``describe()`` for log lines) and ``make_compressor`` for the paper's
  standalone compressor zoo;
- compress: ``compress_tree`` (dense-layout Q(g)) and
  ``compress_tree_sparse`` (fixed-capacity sparse buffers for the wire);
- synchronize: ``sync_tree``, the sync entry point (the dense, gather
  and packed wires, the sync and overlapped exchanges, the pod hierarchy
  with ``pod_group``). Error feedback carries a ``FeedbackState``
  (``init_feedback``; ``init_feedback(params, pod=True)`` adds the pod
  stage's residual for ``resparsify_pods``); the adaptive control loop
  (``CompressionConfig.adaptive``: delta transmission, communication
  skipping, fitted Golomb-Rice parameters) a ``ControlState``
  (``init_control``); ``rescale_feedback`` corrects the residual under an
  lr schedule.

Names not exported here are internal to the port.
"""
from __future__ import annotations

from repro_torch.comm.sync import SyncStats, sync_tree
from repro_torch.core._compressors import (REGISTRY, CompressedGrad,
                                           make_compressor)
from repro_torch.core.api import (CompressionConfig, TreeStats,
                                  compress_leaf, compress_tree,
                                  compress_tree_sparse, zeros_like_residual)
from repro_torch.optim.optimizers import (ControlState, FeedbackState,
                                          init_control, init_feedback,
                                          rescale_feedback)

__all__ = [
    "CompressionConfig", "TreeStats", "compress_leaf", "compress_tree",
    "compress_tree_sparse", "zeros_like_residual",
    "sync_tree", "SyncStats",
    "FeedbackState", "init_feedback",
    "ControlState", "init_control", "rescale_feedback",
    "make_compressor", "CompressedGrad", "REGISTRY",
]
