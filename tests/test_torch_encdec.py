"""The encoder-decoder and prefix pieces of the port (seamless-m4t-large-v2's
encoder and cross-attention, paligemma-3b's prefix of patch embeddings)
against the JAX package, eager, on the smoke configs in float32 on the
CPU, the JAX weights carried across by ``repro_torch.models.convert``, and
the launcher's batch against ``repro/launch/specs.py``:

- ``attention_train`` with ``kv_x`` (cross-attention: keys and values from
  a sequence of another length, no RoPE) and with ``causal=False``, within
  rtol 1e-5 / atol 1e-6; skipping JAX's ``where`` on an all-ones mask is
  bit-equal to applying it;
- ``encode``: the non-causal encoder and ``enc_final_ln`` over stub frames
  (atol 1e-5 on its unit-scale output and the frames' gradient);
- ``forward_train`` with paligemma's prefix: the logits of the tokens
  alone (the prefix sliced off), equal to JAX's; the ``P + S`` sequence
  runs causal (a token moves no logit before it; the prefix moves all of
  them), with RoPE over the prefix's positions too;
- the launcher's batch: ``prefix`` and ``enc_embeds`` shaped and typed as
  ``train_batch_structs`` shapes them at ``train_4k`` and the frame rule
  of ``arch_model_for_shape`` (``frames_for(128) == 64``), 256 patches;
  the stub inputs drawn after the tokens, fixed by the seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax API shims first)
from repro.configs import registry as jregistry
from repro.configs import seamless_m4t_large_v2 as jseamless
from repro.launch import specs as jspecs
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro_torch.configs import registry as tregistry
from repro_torch.configs import seamless_m4t_large_v2 as tseamless
from repro_torch.data.synthetic import token_batch
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import apply_rope, rope_table

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
SEAMLESS, PALIGEMMA = "seamless-m4t-large-v2", "paligemma-3b"


def _cfgs(arch: str):
    return jregistry.get(arch).smoke, tregistry.get(arch).smoke


@functools.lru_cache(maxsize=None)
def _params(arch: str) -> dict:
    """The JAX init of the smoke config as a nested dict of numpy arrays."""
    jcfg = _cfgs(arch)[0]
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: split_params(jtf.init_model(k, jcfg))[0])(
            jax.random.key(0)))


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _normal(rng, shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def _cross_attn(arch: str) -> dict:
    """Layer 0 of the decoder's cross-attention (seamless: biases too)."""
    return {k: v[0] for k, v in _params(arch)["cross"]["x0"]["attn"].items()}


def test_cross_attention_takes_kv_x_without_rope():
    """Queries from x [2, 16, d], keys and values from kv_x [2, 8, d]:
    equal to JAX's ``attention_train(kv_x=..., causal=False)``; RoPE on
    neither side (a query's output does not move when the queries are
    permuted along the sequence, as it would with positions)."""
    jcfg, tcfg = _cfgs(SEAMLESS)
    p = _cross_attn(SEAMLESS)
    rng = np.random.default_rng(0)
    x, kv = _normal(rng, (2, 16, 128)), _normal(rng, (2, 8, 128))
    want = jattn.attention_train(p, jcfg.attn_cfg("attn_full"),
                                 jnp.asarray(x), kv_x=jnp.asarray(kv),
                                 causal=False)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    acfg = tcfg.attn_cfg("attn_full")
    assert acfg.use_rope
    got = tattn.attention_train(tp, acfg, torch.from_numpy(x),
                                kv_x=torch.from_numpy(kv), causal=False)
    assert got.shape == (2, 16, 128)
    _close(got, want)
    perm = np.random.default_rng(1).permutation(16)
    moved = tattn.attention_train(tp, acfg, torch.from_numpy(x[:, perm]),
                                  kv_x=torch.from_numpy(kv), causal=False)
    torch.testing.assert_close(moved, got[:, perm], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", [SEAMLESS, PALIGEMMA])
def test_non_causal_self_attention_matches_jax(arch):
    """``causal=False`` self-attention (RoPE on, every key visible) equals
    JAX's all-ones mask, and is bit-equal to the port's own ``_sdpa``
    applying that mask; the causal path differs from it."""
    jcfg, tcfg = _cfgs(arch)
    p = {k: v[0] for k, v in _params(arch)["blocks"]["b0_attn_full"][
        "attn"].items()}
    d = tcfg.d_model
    x = _normal(np.random.default_rng(2), (2, 12, d))
    want = jattn.attention_train(p, jcfg.attn_cfg("attn_full"),
                                 jnp.asarray(x), causal=False)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    acfg = tcfg.attn_cfg("attn_full")
    xt = torch.from_numpy(x)
    got = tattn.attention_train(tp, acfg, xt, causal=False)
    _close(got, want)
    q, k, v = tattn._qkv(tp, acfg, xt)
    sin, cos = rope_table(torch.arange(12), acfg.head_dim, acfg.rope_theta)
    q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    ones = torch.ones((1, 12, 12), dtype=torch.bool)
    masked = tattn._proj_out(tp, acfg, tattn._sdpa(acfg, q, k, v, ones))
    assert torch.equal(got, masked)
    causal = tattn.attention_train(tp, acfg, xt)
    assert not torch.allclose(causal[:, :-1], got[:, :-1], atol=1e-3)
    torch.testing.assert_close(causal[:, -1], got[:, -1], rtol=0, atol=0)


def test_encode_matches_jax():
    """The encoder over stub frames [2, 8, d]: its two non-causal blocks
    (LayerNorm, biases, the dense GELU MLP) and ``enc_final_ln``, and the
    gradient of ``sum(out * c)`` into the frames, against JAX's."""
    jcfg, tcfg = _cfgs(SEAMLESS)
    params = _params(SEAMLESS)
    rng = np.random.default_rng(3)
    frames, c = _normal(rng, (2, 8, 128)), _normal(rng, (2, 8, 128))
    out, vjp = jax.vjp(lambda f: jtf.encode(params, jcfg, f),
                       jnp.asarray(frames))
    (gf,) = vjp(jnp.asarray(c))
    ft = torch.from_numpy(frames).requires_grad_(True)
    got = ttf.encode(params_from_numpy(params), tcfg, ft)
    torch.sum(got * torch.from_numpy(c)).backward()
    # LayerNorm'd outputs of unit scale after 2 blocks of float32 products
    # summed in other orders: 1.3e-6 at most, measured
    _close(got, out, atol=1e-5)
    _close(ft.grad, gf, atol=1e-5)
    # non-causal: the last frame moves the first frame's output (a random
    # change: LayerNorm takes out a constant one)
    f2 = frames.copy()
    f2[:, -1] += _normal(rng, (2, 128))
    moved = ttf.encode(params_from_numpy(params), tcfg,
                       torch.from_numpy(f2))
    assert (moved[:, 0] - got[:, 0]).abs().max() > 1e-3


def _prefix_logits(params: dict, tcfg, tokens, prefix):
    return ttf.forward_train(params, tcfg, torch.from_numpy(tokens),
                             prefix=torch.from_numpy(prefix))[0]


def test_prefix_is_prepended_causal_and_sliced_off():
    """paligemma's smoke config, 8 patches before 16 tokens: the logits
    [2, 16, vocab] equal JAX's ``forward_train`` on the same batch; with
    the prefix dropped they differ (it is read); a changed token moves
    only its own and later logits, a changed patch moves every logit (the
    ``P + S`` sequence runs causal, the patches first); a prefix shifts
    the tokens' RoPE positions by P (the same logits as JAX's, which rope
    over ``0 .. P+S-1``)."""
    jcfg, tcfg = _cfgs(PALIGEMMA)
    assert tcfg.prefix_len == jcfg.prefix_len == 8
    params = _params(PALIGEMMA)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, tcfg.vocab, (2, 16))
    prefix = _normal(rng, (2, 8, tcfg.d_model))
    want, _ = jtf.forward_train(params, jcfg, {
        "tokens": jnp.asarray(tokens), "prefix": jnp.asarray(prefix)})
    tparams = params_from_numpy(params)
    got = _prefix_logits(tparams, tcfg, tokens, prefix)
    assert got.shape == (2, 16, tcfg.vocab)
    # logits up to 280 (the JAX init's scale): float32's eps there is
    # 3.4e-5, and 1.8e-4 the largest difference, measured (rtol 6.5e-7)
    _close(got, want, atol=2e-5)
    bare = ttf.forward_train(tparams, tcfg, torch.from_numpy(tokens))[0]
    assert (bare - got).abs().max() > 1e-2
    t2 = tokens.copy()
    t2[:, 10] = (t2[:, 10] + 1) % tcfg.vocab
    moved = _prefix_logits(tparams, tcfg, t2, prefix)
    assert torch.equal(moved[:, :10], got[:, :10])
    assert (moved[:, 10:] - got[:, 10:]).abs().amax(-1).min() > 1e-3
    p2 = prefix.copy()
    p2[:, -1] += _normal(rng, (2, tcfg.d_model))
    moved = _prefix_logits(tparams, tcfg, tokens, p2)
    assert (moved - got).abs().amax(-1).min() > 1e-3


@pytest.mark.parametrize("arch", [SEAMLESS, PALIGEMMA])
def test_batch_shapes_follow_the_jax_specs(arch):
    """At ``train_4k`` (4,096 tokens, 256 sequences) the port's stub
    inputs have the names, shapes and dtypes of JAX's
    ``train_batch_structs`` for the config of ``arch_model_for_shape``;
    at the launcher's 128 tokens seamless takes ``frames_for(128) == 64``
    frames, paligemma 256 patches; a smoke config keeps its own 8."""
    spec_j, spec_t = jregistry.get(arch), tregistry.get(arch)
    jcfg = jspecs.arch_model_for_shape(spec_j, "train_4k")
    tcfg = tspecs.model_for_seq(spec_t.model, 4096)
    assert tcfg.prefix_len == jcfg.prefix_len
    mesh = jax.make_mesh((1,), ("data",))
    structs = jspecs.train_batch_structs(jcfg, "train_4k", mesh, False)
    want = {k: (v.shape, str(v.dtype)) for k, v in structs.items()
            if k != "tokens"}
    got = {k: (shape, str(dtype).removeprefix("torch."))
           for k, (shape, dtype) in tspecs.stub_inputs(tcfg, 256).items()}
    assert got == want and len(got) == 1
    at_128 = tspecs.stub_inputs(tspecs.model_for_seq(spec_t.model, 128), 8)
    frames = {SEAMLESS: 64, PALIGEMMA: 256}[arch]
    assert [s for s, _ in at_128.values()] == [(8, frames,
                                               spec_t.model.d_model)]
    assert tseamless.frames_for(128) == jseamless.frames_for(128) == 64
    assert tseamless.frames_for(4096) == jseamless.frames_for(4096) == 1024
    assert spec_t.smoke.prefix_len == spec_j.smoke.prefix_len == 8
    text = tregistry.get("gemma-2b").model
    assert tspecs.stub_inputs(tspecs.model_for_seq(text, 128), 8) == {}


@pytest.mark.parametrize("arch", [SEAMLESS, PALIGEMMA])
def test_stub_inputs_are_fixed_by_the_seed(arch):
    """``train_batch`` draws the tokens first, as ``token_batch`` does from
    the same generator, then the stub inputs: standard normals in
    bfloat16, the same for the same seed, others for another; two
    launcher runs of one seed give the same losses, another seed
    others."""
    cfg = tregistry.get(arch).smoke
    batches = [tspecs.train_batch(torch.Generator().manual_seed(s), cfg, 4,
                                  16) for s in (0, 0, 1)]
    tokens = token_batch(torch.Generator().manual_seed(0), cfg.vocab, 4, 16)
    assert torch.equal(batches[0]["tokens"], tokens["tokens"])
    (name, (shape, dtype)), = tspecs.stub_inputs(cfg, 4).items()
    stub = batches[0][name]
    assert stub.shape == shape and stub.dtype == dtype == torch.bfloat16
    assert abs(float(stub.float().std()) - 1.0) < 0.1
    assert torch.equal(stub, batches[1][name])
    assert not torch.equal(stub, batches[2][name])

    def losses(seed):
        out = tlaunch.main(["--arch", arch, "--smoke", "--steps", "2",
                            "--device", "cpu", "--seed", str(seed),
                            "--batch", "2", "--seq", "16"])
        return [m["loss"] for m in out["metrics"]]

    first = losses(0)
    assert losses(0) == first != losses(1)


def test_encoder_needs_its_frames():
    """An encoder-decoder run without ``enc_embeds`` is refused (the JAX
    package's ``forward_train`` fails with a KeyError there)."""
    tcfg = _cfgs(SEAMLESS)[1]
    params = params_from_numpy(_params(SEAMLESS))
    with pytest.raises(ValueError, match="enc_embeds"):
        ttf.forward_train(params, tcfg, torch.zeros((1, 4), dtype=torch.long))
