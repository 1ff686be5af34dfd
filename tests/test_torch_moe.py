"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
(``repro.models.moe``), in float32 on the CPU, the JAX parameters carried
across by ``models.convert.params_from_numpy`` and the same numpy inputs:

- ``moe_ffn``'s output, auxiliary loss and the gradients of ``sum(y * r) +
  aux`` for x, the router, the experts and the shared experts, within
  rtol 1e-5 / atol 1e-6 (float32 products summed in other orders; a
  gradient's atol scaled by its leaf's largest magnitude where that
  passes 1: the router's, up to 21 here, sums 32 tokens' terms of both
  signs, 1.8e-5 apart at most), on the
  phi3.5-moe and deepseek-v2 smoke MoEs and ``tests/test_models.py``'s
  ``moe`` config, with ``normalize_weights=False`` and ``act="gelu"``;
- a capacity-dropping case (``capacity_factor`` 1.0, a router skewed to
  one expert): the kept choices, read off each package's output, are the
  same set, and the first ``capacity`` choices of each expert in token
  order;
- a router with two identical columns on inputs whose logits are exact,
  so the two experts tie exactly: the lower one is taken, as
  ``lax.top_k`` takes it;
- ``capacity()`` as in JAX.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax API shims first)
from repro.models import moe as jmoe
from repro.models.common import Initializer as JInitializer
from repro.models.common import split_params
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

# the smoke MoEs of phi3.5-moe and deepseek-v2, tests/test_models.py's
# "moe", and one without weight normalization, with GELU and shared experts
CONFIGS = {
    "phi3.5-moe-smoke": dict(d_model=256, d_expert=128, num_experts=4,
                             top_k=2, capacity_factor=2.0, act="silu"),
    "deepseek-v2-smoke": dict(d_model=128, d_expert=64, num_experts=4,
                              top_k=2, num_shared=1, capacity_factor=2.0,
                              act="silu"),
    "test_models-moe": dict(d_model=64, d_expert=96, num_experts=4, top_k=2,
                            capacity_factor=2.0),
    "unnormalized-gelu": dict(d_model=64, d_expert=48, num_experts=6,
                              top_k=3, num_shared=2, capacity_factor=1.5,
                              act="gelu", normalize_weights=False),
}
B, S = 2, 16
RTOL, ATOL = 1e-5, 1e-6


def _cfgs(kw: dict):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _jax_params(jcfg, seed: int = 0) -> dict:
    tree = jmoe.init_moe(JInitializer(jax.random.key(seed), jnp.float32),
                         jcfg)
    return jax.tree.map(np.asarray, split_params(tree)[0])


def _jax_run(jcfg, params, x, r):
    """JAX's y, aux and the gradients of sum(y * r) + aux for the
    parameters and x."""
    def f(p, x):
        y, aux = jmoe.moe_ffn(p, jcfg, x)
        return jnp.sum(y * r) + aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return np.asarray(y), float(aux), params_from_numpy(
        jax.tree.map(np.asarray, gp)), np.asarray(gx)


def _port_run(tcfg, params, x, r):
    p = {k: v.clone().requires_grad_(True)
         for k, v in params_from_numpy(params).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(p, tcfg, xt)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    return (y.detach().numpy(), float(aux.detach()),
            {k: v.grad for k, v in p.items()},
            xt.grad.numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_ffn_matches_jax(name):
    jcfg, tcfg = _cfgs(CONFIGS[name])
    params = _jax_params(jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jy, jaux, jgp, jgx = _jax_run(jcfg, params, x, r)
    ty, taux, tgp, tgx = _port_run(tcfg, params, x, r)
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(taux, jaux, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tgx, jgx, rtol=RTOL, atol=ATOL)
    assert sorted(tgp) == sorted(jgp) == sorted(tmoe.moe_shapes(tcfg))
    for k in jgp:
        want = jgp[k].numpy()
        np.testing.assert_allclose(
            tgp[k].numpy(), want, rtol=RTOL,
            atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=k)
    assert float(jgp["router"].abs().max()) > 0.0


def test_capacity_matches_jax():
    for tokens, kw in itertools.product((1, 7, 16, 128, 4096),
                                        CONFIGS.values()):
        jcfg, tcfg = _cfgs({**kw, "capacity_factor": 1.0})
        assert tcfg.capacity(tokens) == jcfg.capacity(tokens)
        assert tcfg.capacity(tokens) % 4 == 0 and tcfg.capacity(tokens) >= 4


def _choices64(params, cfg, x):
    """Each token's top-k experts (stable: the lower index first among
    equals), their routing weights and every expert's output, in float64
    numpy from the same float32 inputs."""
    x64 = x.astype(np.float64)
    logits = x64 @ params["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1, kind="stable")[..., :cfg.top_k]
    w = np.take_along_axis(probs, ids, -1)
    if cfg.normalize_weights:
        w = w / w.sum(-1, keepdims=True)
    wg, wu, wd = (params[k].astype(np.float64)
                  for k in ("w_gate", "w_up", "w_down"))
    g = np.einsum("bsd,edf->bsef", x64, wg)
    h = g / (1.0 + np.exp(-g)) * np.einsum("bsd,edf->bsef", x64, wu)
    return ids, w, np.einsum("bsef,efd->bsed", h, wd)


def _kept_sets(y, ids, w, out) -> np.ndarray:
    """Which of each token's k choices reached ``y``: the subset whose
    weighted expert outputs sum closest to the token's output (one subset
    per token, asserted unambiguous)."""
    b, s, k = ids.shape
    kept = np.zeros((b, s, k), bool)
    subsets = list(itertools.product((False, True), repeat=k))
    for i in range(b):
        for t in range(s):
            contrib = [w[i, t, j] * out[i, t, ids[i, t, j]] for j in range(k)]
            errs = [np.abs(y[i, t] - sum((c for c, m in zip(contrib, sub)
                                          if m), np.zeros_like(y[i, t]))
                           ).max() for sub in subsets]
            best = int(np.argmin(errs))
            assert errs[best] < 1e-4 and sorted(errs)[1] > 1e-3, (i, t, errs)
            kept[i, t] = subsets[best]
    return kept


def test_capacity_drops_the_same_choices_as_jax():
    """capacity_factor 1.0 and a router whose column 0 is lifted, so expert
    0 takes more than its capacity of 12 choices in each batch row: the
    same choices drop in both packages, the ones past the first 12 of
    expert 0 in token order (the stable sort by expert id)."""
    kw = {**CONFIGS["test_models-moe"], "capacity_factor": 1.0}
    jcfg, tcfg = _cfgs(kw)
    params = _jax_params(jcfg, seed=3)
    params["router"] = params["router"].copy()
    params["router"][:, 0] += 0.03
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((B, S, jcfg.d_model)) + 0.5).astype(np.float32)
    r = np.ones_like(x)
    cap = tcfg.capacity(S)
    assert cap == 12
    ids, w, out = _choices64(params, jcfg, x)
    jy = _jax_run(jcfg, params, x, r)[0]
    ty = _port_run(tcfg, params, x, r)[0]
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    jkept, tkept = _kept_sets(jy, ids, w, out), _kept_sets(ty, ids, w, out)
    np.testing.assert_array_equal(tkept, jkept)
    want = np.zeros_like(jkept)
    for i in range(B):
        seen = np.zeros(jcfg.num_experts, int)
        for t in range(S):
            for j in range(jcfg.top_k):
                want[i, t, j] = seen[ids[i, t, j]] < cap
                seen[ids[i, t, j]] += 1
        assert seen[0] > cap                  # expert 0 overflows each row
    np.testing.assert_array_equal(jkept, want)
    assert (~jkept).sum() >= 2


def test_exact_router_ties_take_the_lower_expert():
    """Router columns 1 and 2 identical and every product exact (inputs in
    quarters, the router in sixteenths), so experts 1 and 2 tie exactly below expert 0 (or above it,
    past expert 3): ``lax.top_k`` takes expert 1 and never 2; the port's
    output and aux equal JAX's, and an output that took expert 2 differs."""
    kw = {**CONFIGS["test_models-moe"], "capacity_factor": 4.0}
    jcfg, tcfg = _cfgs(kw)
    params = _jax_params(jcfg, seed=5)
    rng = np.random.default_rng(7)
    c = rng.integers(-4, 5, jcfg.d_model) / 16
    params["router"] = np.stack([2 * c, c, c, -c], 1).astype(np.float32)
    x = (rng.integers(-4, 5, (B, S, jcfg.d_model)) / 4).astype(np.float32)
    s = x.astype(np.float64) @ c
    assert np.all(s != 0.0)
    r = np.ones_like(x)
    jy, jaux = _jax_run(jcfg, params, x, r)[:2]
    ty, taux = _port_run(tcfg, params, x, r)[:2]
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(taux, jaux, rtol=RTOL, atol=ATOL)
    ids, w, out = _choices64(params, jcfg, x)
    assert (ids == 1).any(axis=-1).all() and not (ids == 2).any()
    assert _kept_sets(jy, ids, w, out).all()
    # the other tie-break: expert 2 in place of expert 1
    swapped = np.where(ids == 1, 2, ids)
    y2 = np.einsum("bsk,bskd->bsd", w, np.take_along_axis(
        out, swapped[..., None], 2))
    assert np.abs(y2 - jy).max() > 1e-2
