"""The port's chunked (flash-style) attention (``repro_torch.models.
attention._sdpa_chunked``, ``_sdpa_dispatch``; ``impl="chunked"``)
against the JAX package's ``_sdpa_chunked`` on the same numpy inputs, on
the CPU, over the cases of ``tests/test_chunked_attention.py`` (GQA 8/2,
head_dim 16, q_chunk 8, kv_chunk 16):

- causal with window None, 8 and 24, softcap None and 30, sq 32 and 64;
  non-causal with sq 32 and sk 48; the ragged fallback (q_chunk 7) to the
  naive path; a non-zero ``q_offset``; float32 within ``RTOL`` and an
  atol of ``ATOL`` times the array's largest magnitude (at least 1;
  products summed in other orders: up to 1.4e-6 of it measured), one
  bfloat16 case within ``BF16_TOL`` (a bfloat16 ulp of the output);
- the gradients in q, k and v of ``sum(out * c)`` against ``jax.grad``;
- skipping the kv blocks masked for every row of a query batch: bit-equal
  to computing them, on shapes where blocks are skipped;
- the gemma2-9b smoke model with ``attn_impl="chunked"`` (q_chunk 8,
  kv_chunk 8, sequence 16 > window 8): loss and every gradient against
  JAX at the same config within ``test_torch_archs``' tolerances;
- the refusals: ``impl="seq_parallel"`` (queue A item 10d) and an
  unknown impl.
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
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro.train import step as jstep
from repro_torch.configs import registry as tregistry
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import step as tstep

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 2e-6        # float32, ATOL x the largest magnitude
BF16_TOL = 2 ** -7             # one bfloat16 ulp at the outputs' scale


def _close(got, want, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


def _cfgs(**kw):
    base = dict(d_model=64, num_heads=8, num_kv_heads=2, head_dim=16,
                impl="chunked", q_chunk=8, kv_chunk=16)
    base.update(kw)
    return jattn.AttnConfig(**base), tattn.AttnConfig(**base)


def _qkv(seed, b, sq, sk, h=8, kv=2, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32))


def _both(kw: dict, arrays, causal=True, q_offset=0, dispatch=False):
    jcfg, tcfg = _cfgs(**kw)
    if dispatch:
        want = jattn._sdpa_dispatch(jcfg, *map(jnp.asarray, arrays),
                                    causal=causal)
        got = tattn._sdpa_dispatch(tcfg, *map(torch.from_numpy, arrays),
                                   causal=causal)
    else:
        want = jattn._sdpa_chunked(jcfg, *map(jnp.asarray, arrays),
                                   causal=causal, q_offset=q_offset)
        got = tattn._sdpa_chunked(tcfg, *map(torch.from_numpy, arrays),
                                  causal=causal, q_offset=q_offset)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("window", [None, 8, 24])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("sq", [32, 64])
def test_chunked_matches_jax_causal(window, softcap, sq):
    got, want = _both(dict(window=window, logit_softcap=softcap),
                      _qkv(0, 2, sq, sq))
    _close(got, want)


def test_chunked_matches_jax_noncausal():
    got, want = _both({}, _qkv(1, 2, 32, 48), causal=False)
    _close(got, want)


def test_ragged_shape_falls_back_to_naive_as_jax():
    """q_chunk 7 does not divide 32: both packages run the naive path
    (the port's equal to its own ``_sdpa`` bit for bit)."""
    arrays = _qkv(2, 1, 32, 32)
    got, want = _both(dict(q_chunk=7), arrays, dispatch=True)
    _close(got, want)
    tcfg = _cfgs(q_chunk=7)[1]
    q, k, v = map(torch.from_numpy, arrays)
    assert torch.equal(torch.from_numpy(got), tattn._sdpa(
        tcfg, q, k, v, tattn.causal_mask(32, 32, "cpu")))


@pytest.mark.parametrize("window", [None, 24])
def test_q_offset_matches_jax(window):
    """Queries at positions 16 .. 47 against keys 0 .. 47 (a prompt's
    second half over the whole of it)."""
    got, want = _both(dict(window=window, logit_softcap=50.0),
                      _qkv(3, 2, 32, 48), q_offset=16)
    _close(got, want)


def test_bf16_matches_jax():
    """bfloat16 q, k, v (the scores cast to float32 after the product,
    ``p`` cast to bfloat16 before the second): within a bfloat16 ulp."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(4, 2, 64, 64))
    jcfg, tcfg = _cfgs(window=8, logit_softcap=30.0)
    want = jattn._sdpa_chunked(
        jcfg, *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                for t in (q, k, v)), causal=True)
    got = tattn._sdpa_chunked(tcfg, q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("kw", [dict(window=8, logit_softcap=30.0),
                                dict(window=None, logit_softcap=None)])
def test_gradients_match_jax(kw):
    arrays = _qkv(5, 2, 32, 32)
    c = np.random.default_rng(6).standard_normal((2, 32, 8, 16)).astype(
        np.float32)
    jcfg, tcfg = _cfgs(**kw)

    def f(q, k, v):
        return jnp.sum(jattn._sdpa_chunked(jcfg, q, k, v, causal=True) * c)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    (tattn._sdpa_chunked(tcfg, *ts, causal=True)
     * torch.from_numpy(c)).sum().backward()
    for name, t, w in zip("qkv", ts, want):
        _close(t.grad.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("case", [
    dict(window=8, sq=64, sk=64, q_offset=0, causal=True),
    dict(window=None, sq=64, sk=64, q_offset=0, causal=True),
    dict(window=24, sq=32, sk=64, q_offset=32, causal=True),
    dict(window=8, sq=32, sk=48, q_offset=0, causal=False),
])
def test_skipped_masked_blocks_are_bit_equal(case, monkeypatch):
    """Query blocks batched one at a time (``CHUNK_STEP_ELEMS`` at one
    block's scores), so that kv blocks masked for a whole block are
    skipped: bit-equal, in float32 and bfloat16, to computing every
    block, as JAX's scan does."""
    kw = dict(window=case["window"], logit_softcap=30.0)
    tcfg = _cfgs(**kw)[1]
    monkeypatch.setattr(tattn, "CHUNK_STEP_ELEMS", 2 * 8 * 8 * 16)
    nq, nk = case["sq"] // 8, case["sk"] // 16
    visited = sum(len(tattn._live_blocks(8, 16, nk, i, i + 1,
                                         case["q_offset"], case["causal"],
                                         case["window"]))
                  for i in range(nq))
    assert visited < nq * nk                      # some blocks skipped
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(
            7, 2, case["sq"], case["sk"]))
        run = functools.partial(tattn._sdpa_chunked, tcfg, q, k, v,
                                causal=case["causal"],
                                q_offset=case["q_offset"])
        assert torch.equal(run(skip_masked=True), run(skip_masked=False))


@functools.lru_cache(maxsize=None)
def _smoke_chunked():
    jcfg = dataclasses.replace(jregistry.get("gemma2-9b").smoke,
                               attn_impl="chunked", attn_q_chunk=8,
                               attn_kv_chunk=8)
    tcfg = dataclasses.replace(tregistry.get("gemma2-9b").smoke,
                               attn_impl="chunked", attn_q_chunk=8,
                               attn_kv_chunk=8)
    params = jax.jit(lambda k: split_params(jtf.init_model(k, jcfg))[0])(
        jax.random.key(0))
    return jcfg, tcfg, params


def test_chunked_smoke_model_matches_jax():
    """gemma2-9b's smoke model (window 8, softcaps, GQA 4/2) at sequence
    16 with ``attn_impl="chunked"``: the loss and every gradient equal
    JAX's at the same config (``test_torch_archs``' rtol 1e-5 / atol
    1e-6), and the port's logits equal its naive path's within
    ``RTOL``."""
    jcfg, tcfg, params = _smoke_chunked()
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 16))
    loss, grads = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jcfg)))(
        params, {"tokens": jnp.asarray(tokens)})
    model = ttf.Transformer(tcfg, params_from_numpy(
        jax.tree.map(np.asarray, params)))
    tloss, tgrads = tstep._local_grads(model, model.leaves(),
                                       tstep.make_loss_fn(tcfg),
                                       {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5,
                               atol=1e-6)
    for g, tg in zip(jax.tree.leaves(grads), tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-6)
    naive = dataclasses.replace(tcfg, attn_impl="naive")
    with torch.no_grad():
        got = ttf.forward_train(dict(model.params), tcfg,
                                torch.from_numpy(tokens))[0]
        ref = ttf.forward_train(dict(model.params), naive,
                                torch.from_numpy(tokens))[0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=1e-4)


def test_what_attention_refuses():
    with pytest.raises(NotImplementedError, match="queue A item 10d"):
        tattn.AttnConfig(d_model=64, num_heads=8, num_kv_heads=2,
                         head_dim=16, impl="seq_parallel")
    with pytest.raises(ValueError, match="impl="):
        tattn.AttnConfig(d_model=64, num_heads=8, num_kv_heads=2,
                         head_dim=16, impl="flash")
