"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's file format (``repro.checkpoint.checkpoint``), on the gemma2-9b
smoke config in float32 and in bfloat16:

- a file written by the JAX ``save`` (parameters, Adam, EF with the pod
  residual, the adaptive control state) restores into the port's fresh
  state bit for bit, bfloat16 leaves included (stored as ``|V2`` records;
  the JAX ``restore`` itself cannot read those back: ROADMAP.md C);
- a port-written file of the same state has the JAX file's keys, in its
  order, and every array's dtype, shape and bytes; the JAX ``restore``
  reads the port's float32 file;
- train three steps, or one, save, restore into fresh state and two more:
  parameters, moments, residual and control state bit-equal, on one
  worker and on two gloo ranks (each rank gets its own residual slice back
  from the stacked file); so too the phi3.5-moe, rwkv6, zamba2, paligemma
  and seamless smoke configs in the compressed mode (the last two with
  their stub inputs in each batch) and deepseek-v2's in its fsdp mode,
  whose params-shaped residual the file holds as the JAX fsdp launcher
  writes it (the keys, order, shapes and dtypes of a JAX-written file of
  the same tree; zamba2's shared leaves once, unstacked; seamless's
  ``encoder``, ``enc_final_ln`` and ``cross`` subtrees).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro  # noqa: F401  (jax API shims first)
from repro.checkpoint import checkpoint as jckpt
from repro.configs import gemma2_9b as jgemma2
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro.optim import optimizers as jopt
from repro.configs import registry as jregistry
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import gemma2_9b as tgemma2
from repro_torch.configs import registry as tregistry
from repro_torch.core.api import CompressionConfig
from repro_torch.launch.specs import train_batch
from repro_torch.models.convert import (control_from_jax, feedback_from_jax,
                                        params_from_numpy, tensor_from_numpy)
from repro_torch.models.transformer import (Transformer, init_model,
                                           param_shapes)
from repro_torch.optim import optimizers as topt
from repro_torch.train import step as tstep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_state(dtype: str):
    """The JAX tree ``{"params", "opt", "ef", "ctl"}`` of one worker and
    one pod, every leaf filled from a seeded numpy stream."""
    jdt = DTYPES[dtype][0]
    cfg = dataclasses.replace(jgemma2.SMOKE, dtype=jdt)
    params = jax.jit(lambda k: split_params(jtf.init_model(k, cfg))[0])(
        jax.random.key(0))
    rng = np.random.default_rng(4)

    def fill(tree):
        return jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape), x.dtype), tree)

    opt = jopt.adam(1e-3).init(params)
    opt = {"step": jnp.asarray(7, jnp.int32), "m": fill(opt["m"]),
           "v": fill(opt["v"])}
    ef = jopt.init_feedback(params, num_workers=1, num_pods=1)
    ef = jopt.FeedbackState(residual=fill(ef.residual),
                            pod_residual=fill(ef.pod_residual))
    ctl = jopt.init_control(params, 1)
    ctl = jopt.ControlState(last_sent=fill(ctl.last_sent),
                            last_avg=fill(ctl.last_avg),
                            bound=fill(ctl.bound),
                            step=jnp.asarray(5, jnp.int32))
    return cfg, {"params": params, "opt": opt, "ef": ef, "ctl": ctl}


def _fresh(dtype: str):
    """The port's zero state of the same model (one worker, one pod)."""
    cfg = dataclasses.replace(tgemma2.SMOKE, dtype=DTYPES[dtype][1])
    model = Transformer(cfg, init_model(cfg, torch.Generator().manual_seed(9),
                                        "cpu"))
    leaves = model.leaves()
    return (model, topt.adam(1e-3).init(leaves),
            topt.init_feedback(leaves, pod=True), topt.init_control(leaves))


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _np_bits(x) -> np.ndarray:
    return _bits(tensor_from_numpy(np.asarray(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restores_a_jax_written_checkpoint(dtype, tmp_path):
    _, tree = _jax_state(dtype)
    path = str(tmp_path / "jax_ckpt")
    jckpt.save(path, tree, extra={"arch": "gemma2-9b"})
    model, opt, fb, ctl = _fresh(dtype)
    opt, fb, ctl = tckpt.restore(path, model, opt, fb, ctl)
    assert tckpt.load_meta(path) == {"arch": "gemma2-9b"}
    want = params_from_numpy(jax.tree.map(np.asarray, tree["params"]))
    assert sorted(want) == model.leaf_names
    for name in model.leaf_names:
        assert torch.equal(model.params[name].detach(), want[name]), name
    assert opt["step"] == 7 and ctl.step == 5
    for field in ("m", "v"):
        got = opt[field]
        for x, w in zip(got, jax.tree.leaves(tree["opt"][field])):
            np.testing.assert_array_equal(_bits(x), _np_bits(w))
    jfb = feedback_from_jax(tree["ef"])
    for a, b in zip(fb.residual + fb.pod_residual,
                    jfb.residual + jfb.pod_residual):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    jctl = control_from_jax(tree["ctl"])
    for field in ("last_sent", "last_avg", "bound"):
        for a, b in zip(getattr(ctl, field), getattr(jctl, field)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    if dtype == "bfloat16":
        # inherited from the reference: the JAX restore cannot read its
        # own bfloat16 leaves back (np.savez stored them as |V2)
        assert np.load(path + ".npz")["params/embed/table"].dtype == "V2"
        with pytest.raises(TypeError):
            jckpt.restore(path, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_file_has_the_jax_keys_shapes_and_bytes(dtype, tmp_path):
    _, tree = _jax_state(dtype)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port.npz")
    jckpt.save(jpath, tree)
    model, opt, fb, ctl = _fresh(dtype)
    opt, fb, ctl = tckpt.restore(jpath, model, opt, fb, ctl)
    tckpt.save(tpath, model, opt, fb, ctl, extra={"steps": 3})
    with np.load(jpath + ".npz") as want, np.load(tpath) as got:
        assert list(got.keys()) == list(want.keys())
        for key in want.keys():
            a, b = got[key], want[key]
            assert (a.dtype, a.shape) == (b.dtype, b.shape), key
            assert a.tobytes() == b.tobytes(), key
    with open(tpath + ".meta.json") as f:
        assert json.load(f) == {"steps": 3}
    if dtype == "float32":
        back = jckpt.restore(tpath, tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_refuses_a_mismatched_state(tmp_path):
    """A dtype other than the file's, a missing entry, or a worker count
    other than the file's raises ValueError."""
    _, tree = _jax_state("float32")
    path = str(tmp_path / "jax")
    jckpt.save(path, tree)
    model = _fresh("bfloat16")[0]
    with pytest.raises(ValueError, match="params/"):
        tckpt.restore(path, model)
    model, _, fb, _ = _fresh("float32")
    tckpt.save(str(tmp_path / "params_only"), model)
    with pytest.raises(ValueError, match="no entry 'ef/.residual/"):
        tckpt.restore(str(tmp_path / "params_only"), model, ef_state=fb)
    tree["ef"] = jopt.init_feedback(tree["params"], num_workers=2,
                                    num_pods=1)
    jckpt.save(path, tree)
    with pytest.raises(ValueError, match="stacked over"):
        tckpt.restore(path, model, ef_state=fb)


def _train(state, fb, ctl, step, steps: range, cfg, rank: int):
    """Steps ``steps`` of the compressed step, the data and the uniforms
    of step t (on worker ``rank``) from generators seeded with both."""
    for t in steps:
        batch = train_batch(torch.Generator().manual_seed(100 + 7 * t + rank),
                            cfg, 2, 16)
        gen = torch.Generator().manual_seed(200 + 7 * t + rank)
        if ctl is not None:
            state, fb, ctl, _ = step(state, fb, ctl, batch, gen)
        else:
            state, fb, _ = step(state, fb, batch, gen)
    return state, fb, ctl


def _fresh_run(comp, cfg, seed: int, mode: str = "compressed"):
    model = Transformer(cfg, init_model(
        cfg, torch.Generator().manual_seed(seed), "cpu"))
    opt = topt.adam(1e-3)
    leaves = model.leaves()
    ctl = topt.init_control(leaves) if comp.adaptive else None
    make = (tstep.make_fsdp_train_step if mode == "fsdp"
            else tstep.make_compressed_train_step)
    return (model, opt.init(leaves), topt.init_feedback(leaves), ctl,
            make(model, comp, opt))


def _run(comp, cfg, steps: int = 3, resume_at=None, path=None, rank=0,
         mode: str = "compressed"):
    """``steps`` steps from the seeded init; with ``resume_at``, that many,
    a save to ``path``, a restore into fresh state (another seed's
    parameters, zero moments and residual) and the rest. Returns the
    model and its (opt, EF, control) states. ``mode``: the train step's
    (``compressed`` or ``fsdp``)."""
    model, state, fb, ctl, step = _fresh_run(comp, cfg, 1, mode)
    if resume_at is None:
        return model, _train(state, fb, ctl, step, range(steps), cfg, rank)
    state, fb, ctl = _train(state, fb, ctl, step, range(resume_at), cfg,
                            rank)
    tckpt.save(path, model, state, fb, ctl, mode=mode)
    del model, state, fb, ctl, step
    model, state, fb, ctl, step = _fresh_run(comp, cfg, 2, mode)
    state, fb, ctl = tckpt.restore(path, model, state, fb, ctl, mode=mode)
    return model, _train(state, fb, ctl, step, range(resume_at, steps), cfg,
                         rank)


def _same_state(a, b) -> None:
    (ma, (sa, fa, ca)), (mb, (sb, fb, cb)) = a, b
    for x, y in zip(ma.leaves(), mb.leaves()):
        assert torch.equal(x.detach(), y.detach())
    assert sa["step"] == sb["step"] == 3
    for x, y in zip(sa["m"] + sa["v"] + fa.residual,
                    sb["m"] + sb["v"] + fb.residual):
        assert torch.equal(x, y)
    if ca is not None:
        assert ca.step == cb.step
        for x, y in zip(ca.last_sent + ca.last_avg + ca.bound,
                        cb.last_sent + cb.last_avg + cb.bound):
            assert torch.equal(x, y)


@pytest.fixture
def one_worker_group():
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("adaptive,resume_at", [(False, 1), (True, 1),
                                                (False, 2)])
def test_resumed_run_is_bit_equal(adaptive, resume_at, tmp_path,
                                  one_worker_group):
    """gspar on the gather wire's ``auto`` with EF (and the adaptive loop)
    and Adam: three steps against ``resume_at`` steps, a save, a restore
    into fresh state and the rest."""
    cfg = tgemma2.SMOKE
    comp = CompressionConfig(name="gspar", rho=0.05, wire="gather",
                             error_feedback=True, min_leaf_size=1024,
                             adaptive=adaptive,
                             skip_tau=0.7 if adaptive else 0.0)
    _same_state(_run(comp, cfg), _run(comp, cfg, resume_at=resume_at,
                                      path=str(tmp_path / "ck.npz")))


@pytest.mark.parametrize("arch,mode", [("phi3.5-moe-42b-a6.6b", "compressed"),
                                       ("deepseek-v2-236b", "fsdp"),
                                       ("rwkv6-1.6b", "compressed"),
                                       ("zamba2-2.7b", "compressed"),
                                       ("paligemma-3b", "compressed"),
                                       ("seamless-m4t-large-v2",
                                        "compressed")])
def test_arch_resume_is_bit_equal(arch, mode, tmp_path, one_worker_group):
    """gspar with EF and Adam, on the gather wire's ``auto`` (phi3.5-moe,
    rwkv6, zamba2, paligemma, seamless) or in deepseek-v2's fsdp mode (Q of the averaged
    gradient): three steps against one, a save, a restore into fresh
    state and two more. The file has the keys, order, shapes and dtypes of
    the JAX launcher's file of ``{"params", "opt": adam, "ef"}`` where the
    tree is new to the format: deepseek-v2's fsdp residual params-shaped
    under ``ef/.residual/``, rwkv6's and zamba2's residual stacked over
    one worker, zamba2's ``shared/*`` leaves once, unstacked."""
    cfg = tregistry.get(arch).smoke
    comp = CompressionConfig(name="gspar", rho=0.05, wire="gather",
                             error_feedback=True, min_leaf_size=1024)
    path = str(tmp_path / "ck.npz")
    _same_state(_run(comp, cfg, mode=mode),
                _run(comp, cfg, resume_at=1, path=path, mode=mode))
    if arch == "phi3.5-moe-42b-a6.6b":
        return
    jcfg = jregistry.get(arch).smoke
    params = jax.jit(lambda k: split_params(jtf.init_model(k, jcfg))[0])(
        jax.random.key(0))
    jpath = str(tmp_path / "jax")
    tree = {"params": params, "opt": jopt.adam(1e-3).init(params),
            "ef": jopt.init_feedback(
                params, num_workers=None if mode == "fsdp" else 1)}
    jckpt.save(jpath, tree)
    with np.load(jpath + ".npz") as want, np.load(path) as got:
        assert list(got.keys()) == list(want.keys())
        for key in want.keys():
            assert (got[key].dtype, got[key].shape) == (
                want[key].dtype, want[key].shape), key
        if arch == "zamba2-2.7b":
            assert got["params/shared/in_proj"].shape == (256, 128)
            assert got["ef/.residual/shared/in_proj"].shape == (1, 256, 128)
        if arch == "seamless-m4t-large-v2":
            assert got["params/encoder/blk/attn/wq"].shape == (2, 128, 4, 32)
            assert got["params/enc_final_ln/bias"].shape == (128,)
            assert got["ef/.residual/cross/x0/attn/bo"].shape == (1, 2, 128)
        if mode != "fsdp":
            return
        assert any(k.startswith("ef/.residual/prelude/") for k in want.keys())
        residual = {k: got[k] for k in got.keys() if k.startswith("ef/")}
    # the JAX restore reads the port's fsdp file into that tree
    back = jckpt.restore(path, tree)
    for path_k, x in jax.tree_util.tree_flatten_with_path(back["ef"])[0]:
        key = "ef/.residual/" + "/".join(k.key for k in path_k[1:])
        np.testing.assert_array_equal(np.asarray(x), residual[key])


RANK = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import test_torch_checkpoint as T
from repro_torch.configs import gemma2_9b
from repro_torch.core.api import CompressionConfig

rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
cfg = gemma2_9b.SMOKE
comp = CompressionConfig(name="gspar", rho=0.05, wire="gather",
                         error_feedback=True, min_leaf_size=1024)
T._same_state(T._run(comp, cfg, rank=rank),
              T._run(comp, cfg, resume_at=1, path=f"{tmp}/ck.npz",
                     rank=rank))
one = T._run(comp, cfg, steps=1, rank=rank)[1][1]
torch.save([r.clone() for r in one.residual], f"{tmp}/res{rank}.pt")
dist.destroy_process_group()
"""


def test_two_gloo_ranks_resume_bit_equal_with_their_own_slices(tmp_path):
    """Two workers with their own data and uniforms: each resumes bit-equal
    to its uninterrupted run, and the file stacks the two residuals on the
    leading axis in rank order (rank 0 writes it, each rank reads its own
    slice back)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(port), str(tmp_path),
         os.path.join(REPO, "tests")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    res = [torch.load(tmp_path / f"res{r}.pt") for r in range(2)]
    names = sorted(param_shapes(tgemma2.SMOKE), key=lambda n: n.split("/"))
    with np.load(tmp_path / "ck.npz") as f:
        for i, name in enumerate(names):
            stacked = f["ef/.residual/" + name]
            assert stacked.shape == (2,) + tuple(res[0][i].shape)
            for r in range(2):
                np.testing.assert_array_equal(stacked[r], res[r][i].numpy())
    assert any(not torch.equal(a, b) for a, b in zip(*res))


def test_example_trains_and_round_trips_its_checkpoint(tmp_path,
                                                       monkeypatch):
    """``python -m repro_torch.examples.train_lm`` on the CPU at a small
    width: the loss falls and the checkpoint restores exactly."""
    import tempfile
    from repro_torch.examples import train_lm
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert train_lm.main(["--steps", "8", "--device", "cpu", "--d-model",
                          "64", "--layers", "2"]) == 0.0
    assert list(tmp_path.glob("*/demo_ckpt.npz"))
