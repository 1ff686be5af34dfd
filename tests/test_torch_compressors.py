"""The port's compressor zoo (``repro_torch.core._compressors``) against the
JAX package's (``repro.core._compressors``), the configurations this port
accepts and refuses, and agspar's fitted density.

Each compressor of the zoo maps ``(generator, g)`` to a ``CompressedGrad``
through the dense wire's path on one row. The JAX reference is the JAX
zoo's computation, ``Scheme.compress`` (``apply_dense``, ``message_bits``,
``finish_compressed``), with its two draws replaced by the port's (re-made
from an identically seeded generator), as ``tests/test_torch_compositions.py``
builds it.

Tolerances, with their reasons: p, bits, var_ratio and the scalars within
rtol 1e-6 (gspar's p is the JAX package's per-coordinate solver there,
``min(lambda |g|, 1)`` here: equal up to the rounding of the rescales);
q equal away from the draws within 1e-5 of p or of an integer codec's
rounding point, and there within rtol 1e-6 or one ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import _compressors as jzoo
from repro.core import schemes as jschemes
from repro.core.api import CompressionConfig as JConfig
from repro_torch.core import _compressors as tzoo
from repro_torch.core import codecs as tcodecs
from repro_torch.core import schemes as tschemes
from repro_torch.core.api import CompressionConfig as TConfig
from repro_torch.core.api import compress_leaf
from repro_torch.core.sparse import KernelBackend, dense_group
from repro_torch.kernels.sparsify import ops as tops

torch.set_num_threads(1)

D, SEED, NEAR = 6_000, 17, 1e-5

# (registry name or composition, keyword options)
ZOO = [("gspar", {}), ("gspar", dict(algo="closed", eps=0.5)),
       ("unisp", {}), ("topk", {}), ("qsgd", dict(bits=4)),
       ("qsgd", dict(bits=8)), ("terngrad", {}), ("none", {}),
       ("gspar+qsgd8", {}), ("unisp+bf16", {}), ("topk+ternary", {})]


def _g(dtype=torch.float32, seed: int = 3) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(D) * np.exp(rng.standard_normal(D))).astype(
        np.float32)
    g[:300] = 0.0
    return torch.from_numpy(g).to(dtype)


def _jax_scheme(name: str, kw: dict):
    """The JAX zoo's scheme for a registry name and its options."""
    legacy = {"qsgd": "qsgd", "terngrad": "terngrad", "none": "none"}
    opts = dict(rho=0.1)
    opts.update({k: v for k, v in kw.items() if k in ("algo", "eps")})
    if "bits" in kw:
        opts["qsgd_bits"] = kw["bits"]
    return jschemes.make_scheme(legacy.get(name, name), **opts)


def _jax_compress(scheme, g: torch.Tensor, u, u_cod):
    """``Scheme.compress`` with the draws fed in: (q, p, bits, var)."""
    jg = jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16 if g.dtype == torch.bfloat16 else jnp.float32)
    sel, codec = scheme.selector, scheme.codec
    p = sel.probabilities(jg)
    if sel.name in ("gspar", "unisp", "bernoulli"):
        v = (jnp.asarray(u) < p).astype(jnp.float32)
        from repro.core import sparsify as jsp
        v = jsp.apply_mask(jg, p, v)
    else:
        v = sel.sample(None, jg, p)
    scale = codec.scale(v)
    if codec.rounds_values or codec.integer_coded:
        wire = codec.encode(v, scale, jnp.asarray(u_cod)
                            if codec.stochastic else None)
        q = codec.decode(wire, scale).astype(jg.dtype)
    else:
        q = v.astype(jg.dtype)
    bits = scheme.message_bits(q, p, D)
    cg = jzoo.finish_compressed(jg, q, p, bits)
    return (np.asarray(q, np.float32), np.asarray(p), float(cg.bits),
            float(cg.var_ratio), float(scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(ZOO)))
def test_zoo_matches_jax(case, dtype):
    """Every registry name, and three compositions, against the JAX zoo's
    computation fed the same draws: q, p, bits and var_ratio."""
    name, kw = ZOO[case]
    g = _g(dtype)
    got = tzoo.make_compressor(name, **({"rho": 0.1} if name not in (
        "qsgd", "terngrad", "none") else {}), **kw)(
        torch.Generator().manual_seed(SEED), g)
    scheme = _jax_scheme(name, kw)
    port_scheme = tschemes.make_scheme(
        {"qsgd": "qsgd", "terngrad": "terngrad", "none": "none"}.get(
            name, name), rho=0.1, qsgd_bits=kw.get("bits", 4),
        algo=kw.get("algo", "greedy"), eps=kw.get("eps", 1.0))
    gen = torch.Generator().manual_seed(SEED)
    u = (torch.rand(D, generator=gen).numpy()
         if port_scheme.selector.samples else np.zeros(D, np.float32))
    u_cod = (torch.rand(D, generator=gen).numpy()
             if port_scheme.codec.stochastic else np.zeros(D, np.float32))
    q, p, bits, var, scale = _jax_compress(scheme, g, u, u_cod)
    assert got.q.shape == g.shape and got.q.dtype == g.dtype
    np.testing.assert_allclose(got.p.numpy(), p, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(got.bits), bits, rtol=1e-6)
    np.testing.assert_allclose(float(got.var_ratio), var, rtol=1e-6)
    exempt = np.zeros(D, bool)
    if port_scheme.selector.samples:
        exempt |= np.abs(u - p) < NEAR
    codec = port_scheme.codec
    if codec.integer_coded:
        # the codec's rounding point of a kept value v = g / p
        levels = getattr(codec, "levels", 1.0)
        frac = np.abs(g.float().numpy()) / p.clip(1e-30) / max(
            scale, 1e-30) * levels
        exempt |= np.abs(u_cod - (frac - np.floor(frac))) < NEAR
    keep = ~exempt
    assert keep.mean() > 0.99
    gq = got.q.float().numpy()[keep]
    np.testing.assert_array_equal(gq != 0, q[keep] != 0)
    ulp = np.spacing(np.abs(q[keep])) * (65536 if dtype == torch.bfloat16
                                         else 1)
    np.testing.assert_array_less(np.abs(gq - q[keep]),
                                 np.maximum(1e-6 * np.abs(q[keep]), ulp)
                                 + 1e-30)


def test_registry_and_make_compressor():
    assert set(tzoo.REGISTRY) == set(jzoo.REGISTRY)
    with pytest.raises(ValueError):
        tzoo.make_compressor("nosuch")
    cg = tzoo.make_compressor("bernoulli+ternary")(torch.Generator(), _g())
    assert cg.p.shape == (D,) and float(cg.var_ratio) > 1.0


def test_compress_leaf_is_the_scheme_on_one_row():
    cfg = TConfig(name="unisp+qsgd8", rho=0.1)
    g = _g().reshape(20, 300)
    a = compress_leaf(cfg, torch.Generator().manual_seed(1), g)
    b = cfg.scheme().compress(torch.Generator().manual_seed(1), g)
    assert a.q.shape == g.shape and torch.equal(a.q, b.q)
    assert float(a.bits) == float(b.bits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gain,floor", [(1.0, 0.1), (0.5, 0.1),
                                        (0.05, 0.5), (1.0, 0.0)])
def test_agspar_fitted_rho_matches_jax(gain, floor, dtype):
    """agspar's density target (``ops.fitted_rho``, from a row's sums)
    against the JAX selector's ``rho_fitted``."""
    g = _g(dtype, seed=5)
    g[1000:] = g[1000:] * 1e-3                  # a heavier tail
    jg = jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = float(jschemes.AdaptiveGsparSelector(
        rho=0.1, density_gain=gain, density_floor=floor).rho_fitted(jg))
    l1 = g.float().abs().sum(dtype=torch.float64)
    l2 = (g.float() ** 2).sum(dtype=torch.float64)
    rows = tops.fitted_rho(l1[None], l2[None], D, 0.1, gain, floor)
    np.testing.assert_allclose(float(rows[0]), want, rtol=1e-6)


# --- what the configuration accepts and refuses ----------------------------

@pytest.mark.parametrize("codec", list(tcodecs.CODEC_NAMES))
@pytest.mark.parametrize("selector", list(tschemes.SELECTOR_NAMES))
def test_dense_wire_takes_every_selector_and_codec(selector, codec):
    """Every selector with every codec on the dense wire, with EF where the
    JAX config takes it; and the group runs through the backend."""
    ef = not (selector == "identity" and codec == "f32")
    JConfig(name=selector, codec=codec, error_feedback=ef)
    cfg = TConfig(name=selector, codec=codec, error_feedback=ef, rho=0.1)
    assert cfg.scheme().name == f"{selector}+{codec}"
    g = _g().reshape(2, D // 2)
    u = torch.rand(g.shape, generator=torch.Generator().manual_seed(2))
    cg, res = KernelBackend().compress_dense(
        cfg, u if cfg.scheme().selector.samples else None, g.clone(), ef,
        u_cod=u if cfg.scheme().codec.stochastic else None)
    assert cg.q.shape == g.shape and (res is not None) == ef
    assert bool(torch.isfinite(cg.bits).all())


@pytest.mark.parametrize("kw", [
    dict(name="qsgd"), dict(name="qsgd", qsgd_bits=8), dict(name="none"),
    dict(name="terngrad", error_feedback=True),
    dict(algo="closed", eps=0.0), dict(algo="closed", eps=4.0),
    dict(algo="closed", eps=0.5, wire="gather"),
    dict(name="agspar", density_gain=0.5, density_floor=0.2),
    dict(density_gain=0.5), dict(density_floor=0.2), dict(eps=0.5)])
def test_config_accepts_what_this_port_runs(kw):
    """The aliases, Algorithm 2 at any eps >= 0 on either wire, and agspar's
    density fit: the JAX config's values, accepted as they are."""
    JConfig(**kw)
    cfg = TConfig(**kw)
    for k, v in kw.items():
        assert getattr(cfg, k) == v


@pytest.mark.parametrize("wire", ["dense", "gather"])
def test_describe_names_algorithm_2_and_its_eps(wire):
    """A closed config's one-line summary says so, with its eps (and still
    rho, which sizes the gather wire's capacity); a greedy one does not."""
    d = TConfig(algo="closed", eps=0.5, wire=wire).describe()
    assert "algo=closed eps=0.5" in d and "rho=0.1" in d
    assert "algo=" not in TConfig(wire=wire).describe()


@pytest.mark.parametrize("name", ["identity", "qsgd", "none", "agspar",
                                  "agspar+qsgd8", "identity+ternary"])
def test_gather_wire_refuses_identity_and_agspar(name):
    """The JAX package runs them on its reference backend on the gather
    wire. The port refused them there until it had that backend (queue A
    item 4); now the config takes them, and the kernel backend hands them
    to the reference backend, whose buffers scatter to the dense wire's Q
    on the same uniforms (its codec's drawn ``[rows, d]``)."""
    cfg = TConfig(name=name, wire="gather")
    g = _g().reshape(2, D // 2)
    scheme = cfg.scheme()
    assert KernelBackend.uses_dense(scheme)
    u = torch.rand(g.shape) if scheme.selector.samples else None
    u_cod = torch.rand(g.shape) if scheme.codec.stochastic else None
    k_cap = cfg.capacity(D // 2)
    sg = KernelBackend().compress_sparse(cfg, u, g, k_cap, u_cod)
    want = dense_group(scheme, u, g, False, u_cod=u_cod).q
    got = torch.zeros(g.shape)
    for r in range(2):
        n = int(min(int(sg.nnz[r]), k_cap))
        got[r, sg.idx[r, :n].long()] = sg.decode_values()[r, :n]
    assert torch.equal(got.to(want.dtype), want)


def test_identity_with_a_lossless_codec_refuses_error_feedback():
    for name in ("none", "identity", "identity+f32"):
        with pytest.raises(ValueError, match="silent no-op"):
            TConfig(name=name, error_feedback=True)
    TConfig(name="identity+bf16", error_feedback=True)
