"""The adaptive control loop in the port against the JAX package's
``sync_tree``, on the same numpy inputs: deterministic top-k at rho 0.05
with error feedback, delta coding (``delta_beta`` 1, and 0.9 on bfloat16
leaves), skipping (``skip_tau`` 0.7, bound decay 0.9) and, on the gather
wire's RICE layout, the data-fitted Golomb-Rice parameter. Each case is one
step at one worker (a gloo group of one) and at two gloo ranks, against the
JAX step on one and on two fake CPU devices (one subprocess), with the
bounds forcing a mixed step as ``tests/test_api.py`` does: leaf ``a`` (a
stacked [4, 512] leaf) is skipped (bound 1e30), ``b`` ([1536]) sent (bound
0), ``c`` ([64], under ``min_leaf_size``) rides the dense passthrough and
never skips. Compared bit for bit: the synced leaves, the residuals, the
new ``last_sent`` and ``last_avg``, the step, ``skipped`` and the wire
bytes; the new bounds too where the forced 1e30 sets them, and elsewhere to
rtol 1e-6 (the delta energy is a float32 sum, which the two packages take
in different orders), on bfloat16 leaves to rtol 1e-3 (XLA keeps the
bfloat16 delta in float32 inside the fusion that squares it: its
``xla_allow_excess_precision``; the port squares the rounded delta). The port's dense wire and its gather wire (COO, and
RICE with and without the fitted parameter) give the same step; the fitted
wire never charges more than the static one. Also the launcher's adaptive
run on the CPU and ``models.convert.control_from_jax``."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.comm import sync
from repro_torch.core.api import CompressionConfig
from repro_torch.launch import train as tlaunch
from repro_torch.optim.optimizers import ControlState, FeedbackState

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"a": (4, 512), "b": (1536,), "c": (64,)}   # JAX flatten order
STACKED = {"a": True, "b": False, "c": False}
KEYS = sorted(SHAPES)
BASE = dict(name="topk", rho=0.05, min_leaf_size=128, error_feedback=True,
            adaptive=True, delta_beta=1.0, skip_tau=0.7, bound_decay=0.9)
MIXED = {"a": 1e30, "b": 0.0, "c": 0.0}
FITTED = dict(wire="gather", wire_layout="rice", rice_fitted=True)
# name: (workers, config, bounds, control step, leaf dtype)
CASES = {
    "rice_fitted": (1, FITTED, MIXED, 1, "float32"),
    "rice_static": (1, dict(wire="gather", wire_layout="rice"), MIXED, 1,
                    "float32"),
    "coo": (1, dict(wire="gather", wire_layout="coo"), MIXED, 1, "float32"),
    "dense": (1, dict(wire="dense"), MIXED, 1, "float32"),
    "prime": (1, FITTED, dict.fromkeys(KEYS, 0.0), 0, "float32"),
    "dense_bf16_beta": (1, dict(wire="dense", delta_beta=0.9), MIXED, 1,
                        "bfloat16"),
    "rice_fitted_2w": (2, FITTED, MIXED, 1, "float32"),
    "dense_2w": (2, dict(wire="dense"), MIXED, 1, "float32"),
}
FIELDS = ("synced", "residual", "last_sent", "last_avg", "bound")


def make_inputs() -> dict:
    """Per worker count W: gradients, residuals and last_sent ``[W, ...]``,
    and one last_avg, float32 from numpy (a bfloat16 case rounds them in
    each package the same way)."""
    rng = np.random.default_rng(11)
    data = {}
    for w in (1, 2):
        for k in KEYS:
            shape = SHAPES[k]
            data[f"{w}_g_{k}"] = rng.standard_normal((w,) + shape).astype(
                np.float32)
            data[f"{w}_r_{k}"] = (rng.standard_normal((w,) + shape)
                                  * 0.1).astype(np.float32)
            data[f"{w}_s_{k}"] = (rng.standard_normal((w,) + shape)
                                  * 0.5).astype(np.float32)
            data[f"{w}_la_{k}"] = (rng.standard_normal(shape)
                                   * 0.5).astype(np.float32)
    return data


def port_case(data, case, rank: int) -> dict:
    """One adaptive ``sync_tree`` of this rank on the case's inputs (a
    process group of the case's worker count must be running). Returns the
    outputs as float32 numpy arrays, per field a list in KEYS order."""
    w, kw, bounds, step, dtype = case
    dt = getattr(torch, dtype)

    def leaves(what, worker=True):    # copies: sync_tree writes last_sent
        return [torch.from_numpy(data[f"{w}_{what}_{k}"][rank] if worker
                                 else data[f"{w}_{what}_{k}"]).to(
                                     dt, copy=True)
                for k in KEYS]

    cfg = CompressionConfig(**{**BASE, **kw})
    ctl = ControlState(
        last_sent=leaves("s"), last_avg=leaves("la", worker=False),
        bound=[torch.tensor(bounds[k], dtype=torch.float32) for k in KEYS],
        step=step)
    synced, fb, new_ctl, stats = sync.sync_tree(
        cfg, torch.Generator(), leaves("g"),
        stacked=[STACKED[k] for k in KEYS],
        feedback=FeedbackState(residual=leaves("r")), control=ctl)
    out = {"synced": synced, "residual": fb.residual,
           "last_sent": new_ctl.last_sent, "last_avg": new_ctl.last_avg,
           "bound": new_ctl.bound}
    out = {f: [t.to(torch.float32).numpy() for t in ts]
           for f, ts in out.items()}
    out.update(step=new_ctl.step, skipped=float(stats.skipped),
               wire=float(stats.wire_bytes))
    return out


JAX_SCRIPT = r"""
import sys
import numpy as np
import repro                               # jax API shims first
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.api import (CompressionConfig, ControlState, FeedbackState,
                       sync_tree)

data = np.load(sys.argv[1])
cases, base, stacked = eval(sys.argv[3]), eval(sys.argv[4]), eval(sys.argv[5])
out = {}
for name, (w, kw, bounds, step, dtype) in cases.items():
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cfg = CompressionConfig(backend="reference", **{**base, **kw})
    mesh = Mesh(np.array(jax.devices()[:w]), ("data",))
    get = lambda what: {k: jnp.asarray(data[f"{w}_{what}_{k}"]).astype(dt)
                        for k in stacked}
    la = get("la")
    b0 = {k: jnp.full((w,), v, jnp.float32) for k, v in bounds.items()}

    def f(g, r, s, b):
        first = lambda t: jax.tree.map(lambda x: x[0], t)
        ctl = ControlState(last_sent=first(s), last_avg=la, bound=first(b),
                           step=jnp.int32(step))
        synced, nfb, nctl, stats = sync_tree(
            cfg, jax.random.key(5), first(g), data_axis="data",
            stacked=stacked, feedback=FeedbackState(residual=first(r)),
            control=ctl)
        ex = lambda t: jax.tree.map(lambda x: jnp.asarray(x)[None], t)
        return (ex(synced), ex(nfb.residual), ex(nctl.last_sent),
                ex(nctl.last_avg), ex(nctl.bound), ex(nctl.step),
                ex(stats.skipped), ex(stats.wire_bytes))

    with jax.set_mesh(mesh):
        o = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("data"),) * 4, out_specs=P("data"),
            axis_names={"data"}, check_vma=False))(
                get("g"), get("r"), get("s"), b0)
    for field, tree in zip(("synced", "residual", "last_sent", "last_avg",
                            "bound"), o[:5]):
        for k in stacked:
            out[f"{name}_{field}_{k}"] = np.asarray(tree[k]).astype(
                np.float32)
    for field, x in zip(("step", "skipped", "wire"), o[5:]):
        out[f"{name}_{field}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
"""

GLOO_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import test_torch_adaptive as t

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
data = dict(np.load(sys.argv[5]))
res = {name: t.port_case(data, case, rank)
       for name, case in t.CASES.items() if case[0] == 2}
torch.save(res, out)
dist.destroy_process_group()
"""


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX package's steps (one subprocess, two fake CPU devices), the
    port's two-rank steps (two gloo subprocesses) and its one-worker steps
    (here, a gloo group of one), run side by side."""
    tmp = tmp_path_factory.mktemp("adaptive")
    data = make_inputs()
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz"), repr(CASES), repr(BASE), repr(STACKED)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = _port()
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_WORKER, str(r), str(port), outs[r],
         os.path.dirname(os.path.abspath(__file__)), str(tmp / "in.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_port()}",
                            rank=0, world_size=1)
    try:
        port_res = {name: [port_case(data, case, 0)]
                    for name, case in CASES.items() if case[0] == 1}
    finally:
        dist.destroy_process_group()
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(o, weights_only=False) for o in outs]
    for name, case in CASES.items():
        if case[0] == 2:
            port_res[name] = [ranks[0][name], ranks[1][name]]
    log = jax_proc.communicate(timeout=300)[0]
    assert jax_proc.returncode == 0, log
    return port_res, dict(np.load(tmp / "jax.npz")), data


def _bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", list(CASES))
def test_adaptive_sync_matches_jax(results, name):
    port, jx, _ = results
    w, _, bounds, step, _ = CASES[name]
    for rank in range(w):
        got = port[name][rank]
        for field in FIELDS:
            for i, k in enumerate(KEYS):
                want = jx[f"{name}_{field}_{k}"]
                want = want[0] if field in ("synced", "last_avg") \
                    else want[rank]
                have = got[field][i]
                what = f"{name} rank {rank} {field} {k}"
                if field == "bound" and bounds[k] < 1e30:
                    rtol = 1e-3 if CASES[name][4] == "bfloat16" else 1e-6
                    np.testing.assert_allclose(have, want, rtol=rtol,
                                               err_msg=what)
                else:
                    np.testing.assert_array_equal(_bits(have), _bits(want),
                                                  err_msg=what)
        assert got["step"] == int(jx[f"{name}_step"][rank]) == step + 1
        assert got["skipped"] == float(jx[f"{name}_skipped"][rank])
        assert got["wire"] == float(jx[f"{name}_wire"][rank]), name


def test_mixed_step_skips_exactly(results):
    """In the mixed step leaf ``a`` is skipped: its residual is its whole
    target (delta plus carried residual), bit for bit, it carried no mass
    (synced = last_avg at one worker), and ``last_sent = g + r_in - r_out``;
    at step 0 nothing skips and the bounds are primed."""
    port, _, data = results
    for name in ("rice_fitted", "coo", "dense", "rice_fitted_2w"):
        w = CASES[name][0]
        for rank in range(w):
            got = port[name][rank]
            assert got["skipped"] == 1.0
            g, r, s = (data[f"{w}_{x}_a"][rank] for x in "grs")
            target = (g - s) + r
            np.testing.assert_array_equal(_bits(got["residual"][0]),
                                          _bits(target))
            np.testing.assert_array_equal(
                _bits(got["last_sent"][0]),
                _bits((g + r) - got["residual"][0]))
            if w == 1:
                np.testing.assert_array_equal(_bits(got["synced"][0]),
                                              _bits(data["1_la_a"]))
            assert not np.array_equal(got["residual"][1],
                                      data[f"{w}_g_b"][rank]
                                      - data[f"{w}_s_b"][rank]
                                      + data[f"{w}_r_b"][rank])
    assert port["prime"][0]["skipped"] == 0.0
    for i, k in enumerate(KEYS):
        delta = data[f"1_g_{k}"][0] - data[f"1_s_{k}"][0]
        np.testing.assert_allclose(port["prime"][0]["bound"][i],
                                   np.sum(delta.astype(np.float64) ** 2),
                                   rtol=1e-6)


def test_dense_and_gather_wires_agree(results):
    """Every decision is taken upstream of the wire: the dense wire, COO and
    RICE (static and fitted) give the same step, bit for bit; the fitted
    RICE wire charges no more than the static one, and both less than
    COO."""
    port, _, _ = results
    dense = port["dense"][0]
    for name in ("coo", "rice_static", "rice_fitted"):
        for field in FIELDS[:4]:
            for a, b in zip(port[name][0][field], dense[field]):
                np.testing.assert_array_equal(_bits(a), _bits(b),
                                              err_msg=f"{name} {field}")
        assert port[name][0]["skipped"] == dense["skipped"]
    for rank in range(2):
        for field in FIELDS[:4]:
            for a, b in zip(port["rice_fitted_2w"][rank][field],
                            port["dense_2w"][rank][field]):
                np.testing.assert_array_equal(_bits(a), _bits(b))
    wire = {n: port[n][0]["wire"] for n in ("rice_fitted", "rice_static",
                                            "coo")}
    assert 0 < wire["rice_fitted"] <= wire["rice_static"] < wire["coo"]


def test_sync_tree_refuses_a_missing_or_stray_control():
    leaves = [torch.ones(300)]
    cfg = CompressionConfig(**BASE)
    with pytest.raises(ValueError, match="control"):
        sync.sync_tree(cfg, torch.Generator(), leaves,
                       feedback=[torch.zeros(300)])
    with pytest.raises(ValueError, match="adaptive=False"):
        sync.sync_tree(CompressionConfig(error_feedback=True),
                       torch.Generator(), leaves,
                       feedback=[torch.zeros(300)],
                       control=ControlState([], [], []))


def test_control_from_jax_takes_one_workers_slice():
    import jax.numpy as jnp
    from repro.optim.optimizers import ControlState as JControl
    from repro_torch.models.convert import control_from_jax
    rng = np.random.default_rng(3)
    ls = {"b": rng.standard_normal((2, 5)).astype(np.float32),
          "a": {"w": rng.standard_normal((2, 3)).astype(np.float32)}}
    la = {"b": np.ones(5, np.float32), "a": {"w": np.zeros(3, np.float32)}}
    bound = {"b": np.array([1.0, 2.0], np.float32),
             "a": {"w": np.array([3.0, 4.0], np.float32)}}
    jctl = JControl(last_sent=ls, last_avg=la, bound=bound,
                    step=jnp.int32(7))
    ctl = control_from_jax(jctl, worker=1)
    np.testing.assert_array_equal(ctl.last_sent[0].numpy(), ls["a"]["w"][1])
    np.testing.assert_array_equal(ctl.last_sent[1].numpy(), ls["b"][1])
    np.testing.assert_array_equal(ctl.last_avg[1].numpy(), la["b"])
    assert [float(b) for b in ctl.bound] == [4.0, 2.0]
    assert ctl.bound[0].shape == () and ctl.step == 7


def test_launcher_adaptive_fitted_run_on_the_cpu():
    """``launch.train --device cpu --smoke --adaptive --rice-fitted`` for
    three steps on the gather wire: finite losses, every group on RICE,
    ``skipped`` reported, the fitted charge under the static capacity."""
    out = tlaunch.main(["--arch", "gemma-2b", "--smoke", "--steps", "3",
                        "--device", "cpu", "--wire", "gather",
                        "--error-feedback", "--adaptive", "--skip-tau",
                        "0.7", "--rice-fitted", "--log-every", "1"])
    assert {lay for *_, lay in out["layouts"]} == {"rice"}
    for m in out["metrics"]:
        assert np.isfinite(m["loss"]) and m["skipped"] >= 0.0
        assert 0 < m["wire_bytes"]
    with pytest.raises(ValueError, match="error_feedback"):
        tlaunch.main(["--arch", "gemma-2b", "--smoke", "--steps", "1",
                      "--device", "cpu", "--adaptive"])
