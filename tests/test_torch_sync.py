"""The port's sparse gather exchange over two gloo ranks, under every wire
layout (``coo``, ``bitmap``, ``dense``, ``rice`` and the ``auto`` chooser,
which picks rice, bitmap and dense for the groups here): each rank's synced
leaves equal a numpy scatter-add of both ranks' compact buffers in worker
order, divided by two, bit for bit — with the bucket in one chunk, and
split into many row chunks decoded in small row batches — the tiny leaves ride the float32 all-reduce, and
the wire bytes equal the JAX package's accounting, with the RICE payload
recomputed by its ``coding.rice_stream_words`` on the port's kept
indices."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.comm import compaction as jcompaction
from repro.core import coding as jcoding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(4, 3000), (5000,), (64,), (3, 700), (2, 200), (4, 100)]
STACKED = [True, False, False, True, True, True]
CAPS = {"one_chunk": 2**31 - 1, "row_chunks": 5000}
LAYOUTS = ("coo", "bitmap", "dense", "rice", "auto")
# the COO cases keep the names they had before the other layouts were ported
CASES = {(name if layout == "coo" else f"{layout}-{name}"): (layout, cap)
         for layout in LAYOUTS for name, cap in CAPS.items()}

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.comm import sync
from repro_torch.core import api

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
shapes, stacked, cases = eval(sys.argv[4]), eval(sys.argv[5]), eval(sys.argv[6])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
rng = np.random.default_rng(100 + rank)
leaves = [torch.from_numpy((rng.standard_normal(s)
                            * np.exp(rng.standard_normal(s))
                            ).astype(np.float32)) for s in shapes]
results = {"leaves": leaves}
default_units = sync.DECODE_UNITS
for name, (layout, cap) in cases.items():
    # the row-chunked cases also decode in small row batches
    sync.DECODE_UNITS = default_units if cap == 2**31 - 1 else 4096
    cfg = api.CompressionConfig(rho=0.1, min_leaf_size=256, wire="gather",
                                bucket_coord_cap=cap, wire_layout=layout)
    items, _, _ = api.compress_tree_sparse(
        cfg, torch.Generator().manual_seed(7 + rank), leaves, stacked=stacked)
    synced, _, stats = sync.sync_tree(
        cfg, torch.Generator().manual_seed(7 + rank), leaves, stacked=stacked)
    results[name] = {
        "items": [(k, (p.values, p.idx, p.d, p.nnz, p.layout)
                   if k == "sparse" else p, m) for k, p, m in items],
        "synced": synced, "wire": float(stats.wire_bytes)}
torch.save(results, out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port), outs[r],
         repr(SHAPES), repr(STACKED), repr(CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(o, weights_only=False) for o in outs]


def _expected(results, name):
    """Worker-major numpy scatter-add of both ranks' buffers, / 2."""
    out = [None] * len(SHAPES)
    per_rank = [r[name]["items"] for r in results]
    for e, (kind, _, members) in enumerate(per_rank[0]):
        if kind == "dense":
            flat = (per_rank[0][e][1].numpy() + per_rank[1][e][1].numpy()) / 2
            off = 0
            for i, n in members:
                out[i] = flat[off:off + n].reshape(SHAPES[i])
                off += n
            continue
        d = per_rank[0][e][1][2]
        rows = sum(r for _, r in members)
        dense = np.zeros((rows, d), np.float32)
        for w in range(2):                     # worker-major order
            vals, idx = per_rank[w][e][1][:2]
            for r in range(rows):
                np.add.at(dense[r], idx[r].numpy(),
                          vals[r].numpy().astype(np.float32))
        dense = dense / np.float32(2)
        r0 = 0
        for i, n in members:
            out[i] = dense[r0:r0 + n].reshape(SHAPES[i])
            r0 += n
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_gather_decode_is_worker_major_scatter_add(two_ranks, name):
    want = _expected(two_ranks, name)
    for rank in range(2):
        got = two_ranks[rank][name]["synced"]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                          w.view(np.uint32),
                                          err_msg=f"rank {rank} leaf {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_wire_bytes_per_worker(two_ranks, name):
    """The JAX accounting: value slots at 4 bytes for every sparse row, plus
    per layout the int32 coordinates (coo), the occupancy words (bitmap),
    nothing (dense), or the counts vector and the realized Golomb-Rice words
    of the kept indices (rice); plus 4 bytes per dense-passthrough element.
    The same on both ranks and for any chunking."""
    layout = CASES[name][0]
    for rank in range(2):
        want = 0
        for kind, payload, _ in two_ranks[rank][name]["items"]:
            if kind == "dense":
                want += payload.numel() * 4
                continue
            vals, idx, d, nnz, lay = payload
            assert lay == layout or layout == "auto"
            rows, k_cap = vals.shape
            if lay == "dense":
                want += rows * d * 4
            elif lay == "coo":
                want += rows * k_cap * (4 + 4)
            elif lay == "bitmap":
                want += rows * (k_cap + jcompaction.bitmap_words(d)) * 4
            else:
                want += rows * (k_cap * 4 + 4) + 4 * sum(
                    jcoding.rice_stream_words(
                        idx[r, :min(int(nnz[r]), k_cap)].numpy(), k_cap, d)
                    for r in range(rows))
        assert two_ranks[rank][name]["wire"] == want
    if layout == "auto":
        assert {p[4] for k, p, _ in two_ranks[0][name]["items"]
                if k == "sparse"} == {"rice", "bitmap", "dense"}
