"""The port's serving path (``models.transformer``: ``init_model_cache``,
``forward_prefill``, ``forward_decode``; ``train.step``'s
``make_prefill_step`` and ``make_decode_step``; the caches of every block
kind, the cross cache and the SSM states) against the JAX package's, on
every arch of the registry at its smoke config in float32 on the CPU, the
JAX weights carried across by ``models.convert``:

- JAX ``forward_prefill`` of an 8-token prompt (paligemma's 8 stub
  patches before it, seamless's 8 stub frames through the encoder; stubs
  from a numpy seed, rounded to bfloat16) and four ``forward_decode``
  steps, against the port's on the same inputs: every step's logits
  within rtol ``RTOL`` / atol ``ATOL`` x the logits' largest magnitude,
  every cache leaf after the prefill and after the last step likewise;
  the port's decode from JAX's prefilled cache (``convert.
  cache_from_jax``) too;
- the port's teacher-forced decode against its own ``forward_train``
  (``tests/test_models.py``'s check, its 2e-3);
- a window case (gemma2-9b, window 8): a 12-token prompt (the ring
  rolled) and decode to position 27, three times round the ring, in both
  attention impls, against ``forward_train``; the ring equal to JAX's;
- the cache conversion round trip and the cache tree's paths, shapes and
  dtypes equal to JAX's ``init_model_cache``;
- ``repro_torch.examples.serve_decode --smoke --device cpu`` ends in OK;
- ``registry.SHAPES`` and every spec's ``shapes`` and ``skip_notes``
  equal JAX's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax API shims first)
from repro.configs import registry as jregistry
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro_torch.configs import registry as tregistry
from repro_torch.examples import serve_decode
from repro_torch.launch import specs as tspecs
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import (cache_from_jax, cache_to_jax,
                                        params_from_numpy)
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ARCHS = list(tregistry.ID_TO_MODULE)
B, PROMPT, STEPS = 2, 8, 4
RTOL, ATOL = 1e-5, 2e-6     # float32 sums in other orders (x the largest
                            # magnitude: up to 7.3e-7 of it measured)
TRAIN_TOL = 2e-3            # decode against the train path (test_models)


def _close(got, want, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


def _flat(tree) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in flat}


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str):
    """JAX's parameters, inputs, prefill logits and cache, the four
    decode steps' logits and the cache after them (one jitted prefill and
    one jitted decode)."""
    jcfg = jregistry.get(arch).smoke
    params = jax.jit(lambda k: split_params(jtf.init_model(k, jcfg))[0])(
        jax.random.key(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (B, PROMPT + STEPS))
    stubs = {name: torch.from_numpy(rng.standard_normal(shape).astype(
                 np.float32)).to(dtype).float().numpy()
             for name, (shape, dtype) in tspecs.stub_inputs(
                 tregistry.get(arch).smoke, B).items()}
    offset = PROMPT + (jcfg.prefix_len if "prefix" in stubs else 0)
    caches, _ = jtf.init_model_cache(jcfg, batch=B, max_seq=offset + STEPS)
    batch = {"tokens": jnp.asarray(tokens[:, :PROMPT])}
    batch.update({k: jnp.asarray(v, jnp.bfloat16) for k, v in stubs.items()})
    logits, caches = jax.jit(
        lambda p, bt, c: jtf.forward_prefill(p, jcfg, bt, c))(
        params, batch, caches)
    prefilled = _flat(caches)
    steps = [np.asarray(logits)]
    decode = jax.jit(lambda p, c, t, q: jtf.forward_decode(p, jcfg, t, c, q))
    for i in range(STEPS):
        t = PROMPT + i
        logits, caches = decode(params, caches,
                                jnp.asarray(tokens[:, t:t + 1]),
                                jnp.asarray(offset + i, jnp.int32))
        steps.append(np.asarray(logits))
    return (jax.tree.map(np.asarray, params), tokens, stubs, offset, steps,
            prefilled, _flat(caches))


def _port_batch(tokens, stubs) -> dict[str, torch.Tensor]:
    out = {"tokens": torch.from_numpy(tokens[:, :PROMPT])}
    out.update({k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in stubs.items()})
    return out


@functools.lru_cache(maxsize=None)
def _port_run(arch: str):
    """The port's prefill and decode steps on JAX's inputs: the logits of
    each step, the cache after the prefill and after the last step."""
    params_np, tokens, stubs, offset, *_ = _jax_run(arch)
    cfg = tregistry.get(arch).smoke
    params = params_from_numpy(params_np)
    caches = ttf.init_model_cache(cfg, B, offset + STEPS, "cpu")
    prefill, decode = tstep.make_prefill_step(cfg), tstep.make_decode_step(
        cfg)
    steps = [prefill(params, _port_batch(tokens, stubs), caches).numpy()]
    prefilled = {k: v.clone().numpy() for k, v in caches.items()}
    for i in range(STEPS):
        t = PROMPT + i
        steps.append(decode(params, caches,
                            torch.from_numpy(tokens[:, t:t + 1]),
                            offset + i).numpy())
    return steps, prefilled, {k: v.numpy() for k, v in caches.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    want = _jax_run(arch)[4]
    got = _port_run(arch)[0]
    assert len(got) == len(want) == STEPS + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (B, 1, tregistry.get(arch).smoke.vocab)
        _close(g, w, f"{arch} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_cache_leaf_matches_jax(arch):
    """After the prefill and after the last decode step: the same leaves
    (paths, shapes, dtypes) and values."""
    *_, j_pre, j_last = _jax_run(arch)
    _, t_pre, t_last = _port_run(arch)
    for when, got, want in (("prefill", t_pre, j_pre),
                            ("decode", t_last, j_last)):
        assert sorted(got) == sorted(want), when
        for name, w in want.items():
            assert got[name].shape == w.shape, name
            assert str(got[name].dtype) == str(w.dtype), name
            _close(got[name], w, f"{arch} {when} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_jax_prefilled_cache(arch):
    """JAX's prefilled cache carried across (``cache_from_jax``): the
    port's four decode steps give JAX's logits."""
    params_np, tokens, stubs, offset, want, j_pre, _ = _jax_run(arch)
    cfg = tregistry.get(arch).smoke
    params = params_from_numpy(params_np)
    tree: dict = {}
    for path, v in j_pre.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    caches = cache_from_jax(tree)
    for i in range(STEPS):
        t = PROMPT + i
        got = ttf.forward_decode(params, cfg,
                                 torch.from_numpy(tokens[:, t:t + 1]),
                                 caches, offset + i)
        _close(got.numpy(), want[i + 1], f"{arch} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_train(arch):
    """``tests/test_models.py``'s check on the port alone: prefill 8
    tokens, decode the next 7 teacher-forced; each step's logits equal
    ``forward_train``'s over 16 tokens (two of the SSMs' smoke chunks) at
    the same position within ``TRAIN_TOL``."""
    params_np, _, stubs, _, *_ = _jax_run(arch)
    cfg = tregistry.get(arch).smoke
    params = params_from_numpy(params_np)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, 16))
    full = _port_batch(tokens, stubs)
    with torch.no_grad():
        ref = ttf.forward_train(params, cfg, torch.from_numpy(tokens),
                                prefix=full.get("prefix"),
                                enc_embeds=full.get("enc_embeds"))[0]
    offset = PROMPT + (cfg.prefix_len if "prefix" in full else 0)
    caches = ttf.init_model_cache(cfg, B, offset + 8, "cpu")
    lg = ttf.forward_prefill(params, cfg, full, caches)
    np.testing.assert_allclose(lg[:, 0].numpy(), ref[:, PROMPT - 1].numpy(),
                               rtol=TRAIN_TOL, atol=TRAIN_TOL)
    for i in range(7):
        t = PROMPT + i
        lg = ttf.forward_decode(params, cfg,
                                torch.from_numpy(tokens[:, t:t + 1]),
                                caches, offset + i)
        np.testing.assert_allclose(lg[:, 0].numpy(), ref[:, t].numpy(),
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                   err_msg=f"{arch} position {t}")


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_window_ring_wraps(impl):
    """gemma2-9b's smoke model (window 8): a 12-token prompt (the last 8
    keys kept, rolled so that position t sits in slot t % 8), then decode
    to position 27; every step's logits equal ``forward_train``'s within
    ``TRAIN_TOL``, and the ring after the prefill equals JAX's."""
    params_np = _jax_run("gemma2-9b")[0]
    jcfg = jregistry.get("gemma2-9b").smoke
    cfg = dataclasses.replace(tregistry.get("gemma2-9b").smoke,
                              attn_impl=impl, attn_q_chunk=4,
                              attn_kv_chunk=4)
    params = params_from_numpy(params_np)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (1, 28))
    with torch.no_grad():
        ref = ttf.forward_train(params, cfg, torch.from_numpy(tokens))[0]
    caches = ttf.init_model_cache(cfg, 1, 28, "cpu")
    assert caches["blocks/b0_attn_sw/k"].shape[2] == 8
    lg = ttf.forward_prefill(params, cfg,
                             {"tokens": torch.from_numpy(tokens[:, :12])},
                             caches)
    jc, _ = jtf.init_model_cache(jcfg, batch=1, max_seq=28)
    _, jc = jtf.forward_prefill(jax.tree.map(jnp.asarray, params_np), jcfg,
                                {"tokens": jnp.asarray(tokens[:, :12])}, jc)
    for name, w in _flat(jc).items():
        _close(caches[name].numpy(), w, name)
    np.testing.assert_allclose(lg[:, 0].numpy(), ref[:, 11].numpy(),
                               rtol=TRAIN_TOL, atol=TRAIN_TOL)
    for t in range(12, 27):
        lg = ttf.forward_decode(params, cfg,
                                torch.from_numpy(tokens[:, t:t + 1]),
                                caches, t)
        np.testing.assert_allclose(lg[:, 0].numpy(), ref[:, t].numpy(),
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                   err_msg=f"{impl} t={t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_tree_and_round_trip(arch):
    """``init_model_cache``'s leaves are JAX's (paths, shapes, dtypes, at
    a bf16 config too), and ``cache_to_jax`` then ``cache_from_jax`` gives
    the cache back bit for bit."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jregistry.get(arch).smoke,
                                   dtype=jnp.dtype(dtype))
        tcfg = dataclasses.replace(tregistry.get(arch).smoke,
                                   dtype=getattr(torch, dtype))
        want = jax.eval_shape(lambda: jtf.init_model_cache(jcfg, 2, 12)[0])
        caches = ttf.init_model_cache(tcfg, 2, 12, "cpu")
        flat = {"/".join(k.key for k in p): v for p, v in
                jax.tree_util.tree_flatten_with_path(want)[0]}
        assert sorted(flat) == sorted(caches)
        for name, w in flat.items():
            assert tuple(caches[name].shape) == w.shape, name
            assert str(caches[name].dtype).split(".")[1] == str(w.dtype)
        gen = torch.Generator().manual_seed(3)
        for v in caches.values():
            v.copy_(torch.randn(v.shape, generator=gen))
        back = cache_from_jax(cache_to_jax(caches))
        assert sorted(back) == sorted(caches)
        for name, v in caches.items():
            assert back[name].dtype == v.dtype and torch.equal(back[name], v)


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_serve_decode_example_on_cpu(arch, capsys):
    out = serve_decode.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "16",
                             "--tokens", "5"])
    assert capsys.readouterr().out.rstrip().endswith("OK")
    assert out["tokens"].shape == (2, 5)
    assert out["cache_bytes"] > 0


def test_registry_shapes_are_the_jax_registry_s():
    assert tregistry.SHAPES == jregistry.SHAPES
    for arch in ARCHS:
        t, j = tregistry.get(arch), jregistry.get(arch)
        assert t.shapes == j.shapes and t.skip_notes == j.skip_notes, arch
