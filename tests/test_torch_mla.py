"""The port's Multi-head Latent Attention (``repro_torch.models.attention``:
``MLAConfig``, ``init_mla``, ``mla_train``) against the JAX package's
(``repro/models/attention.py:379-439``) on the CPU, the JAX parameters
carried across by ``models.convert.params_from_numpy``:

- float32 at deepseek-v2's smoke dims (d_model 128, 4 heads, kv_lora 32,
  q_lora 48, qk_nope 16, qk_rope 8, v 16): the output and the gradients of
  ``sum(out * r)`` for x and every leaf within rtol 1e-5 / atol 1e-6 (the
  atol scaled by the leaf's largest gradient where that passes 1), with
  the causal mask biting (a later token changes no earlier output);
- bfloat16: the scaled scores, caught where each package hands them to
  ``softcap``, bit for bit. JAX multiplies the bf16 score sum by the scale
  as a weakly typed Python float, so by the scale rounded to bf16; one-hot
  projections and inputs in 64ths make every product and float32 sum
  exact (each einsum then rounds once to bf16, alike in both), so only the
  scale's product is compared, and a float32 product rounded once would
  differ;
- ``init_mla``'s shapes and the scale ``(qk_nope + qk_rope)^-0.5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax API shims first)
from repro.models import attention as jattn
from repro.models.common import Initializer as JInitializer
from repro.models.common import split_params
from repro_torch.models import attention as tattn
from repro_torch.models.common import Initializer
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

DIMS = dict(d_model=128, num_heads=4, kv_lora=32, q_lora=48, qk_nope=16,
            qk_rope=8, v_dim=16)
RTOL, ATOL = 1e-5, 1e-6


def _jax_params(dtype=jnp.float32, seed: int = 0) -> dict:
    tree = jattn.init_mla(JInitializer(jax.random.key(seed), dtype),
                          jattn.MLAConfig(**DIMS))
    return jax.tree.map(np.asarray, split_params(tree)[0])


def test_init_shapes_and_scale_match_jax():
    jp = _jax_params()
    tcfg = tattn.MLAConfig(**DIMS)
    tp = tattn.init_mla(Initializer(torch.Generator().manual_seed(0),
                                    torch.float32, torch.device("cpu")),
                        tcfg, layers=3)
    assert list(tp) == list(tattn.mla_shapes(tcfg))
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (3,) + v.shape, k
        # N(0, 1/fan-in): fan-in on axis 0, wo's on axis 1
        fan = v.shape[1] if k == "wo" else v.shape[0]
        assert abs(float(tp[k].std()) * fan ** 0.5 - 1.0) < 0.1, k
    assert tcfg.scale == jattn.MLAConfig(**DIMS).scale == 24 ** -0.5


def test_mla_train_matches_jax():
    jcfg, tcfg = jattn.MLAConfig(**DIMS), tattn.MLAConfig(**DIMS)
    params = _jax_params()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, DIMS["d_model"])).astype(np.float32)
    r = rng.standard_normal((2, 16, DIMS["d_model"])).astype(np.float32)

    def f(p, x):
        out = jattn.mla_train(p, jcfg, x)
        return jnp.sum(out * r), out
    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    p = {k: v.clone().requires_grad_(True)
         for k, v in params_from_numpy(params).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tattn.mla_train(p, tcfg, xt)
    torch.sum(out * torch.from_numpy(r)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL)
    for k, g in jgp.items():
        want = np.asarray(g)
        np.testing.assert_allclose(
            p[k].grad.numpy(), want, rtol=RTOL,
            atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=k)
    # causal: changing the last token leaves every earlier output as it was
    x2 = x.copy()
    x2[:, -1] += 1.0
    with torch.no_grad():
        out2 = tattn.mla_train(p, tcfg, torch.from_numpy(x2))
    assert torch.equal(out2[:, :-1], out.detach()[:, :-1])
    assert not torch.equal(out2[:, -1], out.detach()[:, -1])


def _one_hot(rows: int, *shape) -> np.ndarray:
    """A [rows, *shape] 0/1 matrix whose column j (flattened) picks row j %
    rows: the projection copies its input's coordinates."""
    n = int(np.prod(shape))
    w = np.zeros((rows, n), np.float32)
    w[np.arange(n) % rows, np.arange(n)] = 1.0
    return w.reshape((rows,) + shape)


def _captured_scores(mod, run):
    """``run()`` with ``mod.softcap`` wrapped to keep the scores it is
    handed (the scaled scores, cast to float32, before the mask)."""
    seen = []
    real = mod.softcap

    def keep(x, cap):
        seen.append(x)
        return real(x, cap)
    mod.softcap = keep
    try:
        run()
    finally:
        mod.softcap = real
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("dims", [DIMS, dict(DIMS, qk_nope=32, qk_rope=16)])
def test_bf16_scaled_scores_match_jax_bit_for_bit(dims):
    d, h, kvl, ql = (dims[k] for k in ("d_model", "num_heads", "kv_lora",
                                       "q_lora"))
    nope, rope, v = dims["qk_nope"], dims["qk_rope"], dims["v_dim"]
    rng = np.random.default_rng(2)
    p = {"q_down": _one_hot(d, ql), "q_up": _one_hot(ql, h, nope + rope),
         "kv_down": _one_hot(d, kvl),
         "k_rope": np.zeros((d, rope), np.float32),
         "k_up": _one_hot(kvl, h, nope), "v_up": _one_hot(kvl, h, v),
         "wo": rng.standard_normal((h, v, d)).astype(np.float32) / 8}
    x = rng.integers(-64, 65, (2, 12, d)) / 64
    jp = {k: jnp.asarray(a, jnp.bfloat16) for k, a in p.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    jcfg, tcfg = jattn.MLAConfig(**dims), tattn.MLAConfig(**dims)
    want = _captured_scores(jattn, lambda: jattn.mla_train(jp, jcfg, jx))
    tp = {k: tensor_from_numpy(np.asarray(a)) for k, a in jp.items()}
    got = _captured_scores(tattn, lambda: tattn.mla_train(
        tp, tcfg, tensor_from_numpy(np.asarray(jx))))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    # the score sums are exact; the scale's product is what is compared
    sums = torch.einsum("bshk,bthk->bhst", *(
        torch.from_numpy(np.einsum(
            "bsd,dl,lhk->bshk", x, p[a], p[b])[..., :nope]).to(
            torch.bfloat16) for a, b in (("q_down", "q_up"),
                                         ("kv_down", "k_up"))))
    bf16_scale = torch.tensor(tcfg.scale, dtype=torch.bfloat16)
    assert torch.equal((sums * bf16_scale).float(), got)
    once = (sums.float() * tcfg.scale).to(torch.bfloat16).float()
    assert not torch.equal(once, got)
    assert float(bf16_scale) != tcfg.scale
