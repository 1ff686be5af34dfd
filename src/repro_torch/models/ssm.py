"""Recurrent sequence mixers (port of ``repro.models.ssm``): RWKV-6
"Finch" (data-dependent per-channel decay) and Mamba-2 (SSD, a scalar
decay per head), each in its chunked form.
Within a chunk of ``L`` tokens the recurrence is a set of products with
relative-decay factors; a Python loop over the ``T // L`` chunks carries
the state ``S`` (zero, or carried in), as the JAX package's ``lax.scan``
carries it (``unroll``, a scan option, has no counterpart).

Numerics follow the JAX package: the recurrence in float32 with the decays
in log space, the projections in the parameter dtype and cast where JAX
casts them; ``_group_norm`` takes the population variance (``jnp.var``),
softplus is ``logaddexp(x, 0)`` (``jax.nn.softplus``; ``F.softplus``
switches to ``x`` past 20 and rounds otherwise for x > 0), and
``_causal_conv`` sums its taps left to right from 0, then adds the bias,
as Python's ``sum`` does in JAX.

Leaves keep the JAX names (``tm/*``, ``cm/*``, ``mix/*``). Each module
has a ``*_shapes`` function and an ``init_*`` one with the JAX
distributions, as ``models.moe`` and ``models.attention``'s MLA; the
block assembler (``models.transformer``) stacks them over the periods.

Each mixer returns ``(out, new_state)``, as in JAX, and takes a carried
state (prefill and decode): RWKV-6's ``x_tm``, ``x_cm`` (the last token,
the shifts' first input) and ``S`` [B, H, hd, hd] float32, Mamba-2's
``conv`` (the last ``W - 1`` inputs of the convolution) and ``S`` [B, H,
N, hd] float32 (``init_rwkv6_state``, ``init_mamba2_state``); ``None``
starts from the zero state. Decode is ``rwkv6_time_mix_step`` (the exact
one-token recurrence) and ``mamba2_mix`` at T = 1.

Past one model worker (``dist.tensor_parallel``, training only) the
mixers take their ``MixSplit`` and the ``ModelAxis`` and run on this
worker's heads: RWKV-6's time mix forms the five token-shift streams and
the decay from its whole leaves, copies them into the split (one stacked
``copy_to``), and runs its heads' columns of ``wr``, ``wk``, ``wv`` and
``wg``, its heads of the WKV scan and of the group norm (its columns of
the whole ``ln_scale`` and ``ln_bias``, copied in), and ``wo``'s rows,
summed over the workers; the channel mix runs ``wk``'s columns and
``wv``'s rows between ``copy_to`` and ``reduce_from``, then the whole
receptance gate. The Mamba-2 mixer puts ``in_proj``, ``conv_w`` and
``conv_b`` together (``gather_summed``) and reads its heads' columns of
z, x and dt inside the split, forms B and C (their projection,
convolution and SiLU) alike on every worker and copies them into the
split in float32, runs the convolution on its x channels, the SSD scan on
its heads, the gated RMSNorm with the sum of
squares summed over the workers (``reduce_both``, float32, divided by the
whole ``d_inner``), then its block of ``norm_scale`` and ``out_proj``'s
rows, summed over the workers. As every split branch does, a mixer's
column-parallel products of its copied input go through
``tensor_parallel.columns`` and its row-parallel product through ``row``,
which keep the partials in float32 until their sum.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor_parallel as tp

F32 = torch.float32


def _draw(ini, shapes: dict, constants: dict, stddevs: dict,
          layers: int | None, keep=None) -> dict[str, torch.Tensor]:
    """Each leaf of ``shapes``, in order: a constant, N(0, stddev), or
    else N(0, 1/fan-in) with the fan-in on axis 0; ``layers`` stacks that
    many layers on a leading axis. ``keep(name, leaf)`` takes each leaf
    as it is drawn (a split model's shard of it)."""
    out = {}
    for name, shape in shapes.items():
        full = shape if layers is None else (layers,) + shape
        if name in constants:
            t = ini.constant(constants[name], full)
        elif name in stddevs:
            t = ini.normal(full, stddev=stddevs[name])
        else:
            t = ini.fan_in(shape, 0, layers=layers)
        out[name] = t if keep is None else keep(name, t)
    return out


def _shift(x: torch.Tensor, last: torch.Tensor | None = None
           ) -> torch.Tensor:
    """Token shift: y_t = x_{t-1}, y_0 = ``last`` [B, d] (or 0). x [B, T,
    d]."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _chunks(t: int, chunk: int) -> int:
    """The chunk length: ``min(chunk, t)``, which must divide ``t``."""
    L = min(chunk, t)
    if t % L:
        raise ValueError(f"seq {t} not divisible by chunk {L}")
    return L


# ===========================================================================
# RWKV-6
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    head_dim: int = 64
    d_ff: int = 0                 # channel-mix hidden (3.5x d_model in Finch)
    tm_lora: int = 32             # token-mix lora rank
    w_lora: int = 64              # decay lora rank
    chunk: int = 64

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim


# the logical axes of each leaf (``repro.models.ssm``'s init functions)
RWKV6_TIME_MIX_AXES = {
    "mu_x": ("embed",), "mu": (None, "embed"), "lora_a": ("embed", None),
    "lora_b": (None, None, "embed"), "w0": ("embed",),
    "w_lora_a": ("embed", None), "w_lora_b": (None, "embed"),
    "wr": ("embed", "heads"), "wk": ("embed", "heads"),
    "wv": ("embed", "heads"), "wg": ("embed", "heads"),
    "u": ("heads", "head_dim"), "ln_scale": ("embed",),
    "ln_bias": ("embed",), "wo": ("heads", "embed")}
RWKV6_CHANNEL_MIX_AXES = {"mu_k": ("embed",), "mu_r": ("embed",),
                          "wk": ("embed", "mlp"), "wv": ("mlp", "embed"),
                          "wr": ("embed", "embed")}
MAMBA2_AXES = {"in_proj": ("embed", "mlp"), "conv_w": ("conv", "mlp"),
               "conv_b": ("mlp",), "a_log": ("heads",),
               "dt_bias": ("heads",), "d_skip": ("heads",),
               "norm_scale": ("mlp",), "out_proj": ("mlp", "embed")}


def rwkv6_time_mix_shapes(cfg: RWKV6Config) -> dict[str, tuple[int, ...]]:
    """The time mix's leaves (under ``tm/``) and their shapes, in the JAX
    order."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {"mu_x": (d,), "mu": (5, d), "lora_a": (d, 5 * cfg.tm_lora),
            "lora_b": (5, cfg.tm_lora, d), "w0": (d,),
            "w_lora_a": (d, cfg.w_lora), "w_lora_b": (cfg.w_lora, d),
            "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d),
            "u": (h, hd), "ln_scale": (d,), "ln_bias": (d,), "wo": (d, d)}


def init_rwkv6_time_mix(ini, cfg: RWKV6Config, layers: int | None = None,
                        keep=None) -> dict[str, torch.Tensor]:
    """The JAX package's distributions: the shift mixes 0, ``w0`` -4 (a
    mild initial decay), the group norm's scale 1 and bias 0, the LoRAs
    N(0, 0.01), the bonus ``u`` N(0, 0.5), the projections N(0, 1/fan-in)
    on axis 0; ``layers`` stacks that many copies on a leading axis, and
    ``keep(name, leaf)`` takes each leaf as it is drawn."""
    return _draw(ini, rwkv6_time_mix_shapes(cfg),
                 {"mu_x": 0.0, "mu": 0.0, "w0": -4.0, "ln_scale": 1.0,
                  "ln_bias": 0.0},
                 {"lora_a": 0.01, "lora_b": 0.01, "w_lora_a": 0.01,
                  "w_lora_b": 0.01, "u": 0.5}, layers, keep)


def rwkv6_channel_mix_shapes(cfg: RWKV6Config
                             ) -> dict[str, tuple[int, ...]]:
    """The channel mix's leaves (under ``cm/``) and their shapes."""
    d, f = cfg.d_model, cfg.d_ff
    return {"mu_k": (d,), "mu_r": (d,), "wk": (d, f), "wv": (f, d),
            "wr": (d, d)}


def init_rwkv6_channel_mix(ini, cfg: RWKV6Config, layers: int | None = None,
                           keep=None) -> dict[str, torch.Tensor]:
    """The shift mixes 0, the projections N(0, 1/fan-in) on axis 0;
    ``keep`` as ``init_rwkv6_time_mix``'s."""
    return _draw(ini, rwkv6_channel_mix_shapes(cfg),
                 {"mu_k": 0.0, "mu_r": 0.0}, {}, layers, keep)


def _rwkv_mix_streams(p: dict, x: torch.Tensor, xprev: torch.Tensor):
    """Data-dependent token-shift interpolation for the 5 streams (r, k,
    v, w, g); ``lora_a``'s columns split stream-major into [5, rank]."""
    dx = xprev - x
    xxx = x + dx * p["mu_x"]
    lora = torch.tanh(xxx @ p["lora_a"])
    lora = lora.reshape(*lora.shape[:-1], 5, -1)              # [B, T, 5, r]
    dyn = torch.einsum("btfm,fmd->btfd", lora, p["lora_b"])   # [B, T, 5, d]
    mixed = x[..., None, :] + dx[..., None, :] * (p["mu"] + dyn)
    return mixed.unbind(-2)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 64e-5) -> torch.Tensor:
    """Per-head layer norm with the population variance: x [..., h, hd],
    scale and bias [h * hd]."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    n = (x - mean) * torch.rsqrt(var + eps)
    return n.reshape(*n.shape[:-2], -1) * scale + bias


def _wkv_chunk(S: torch.Tensor, r, k, v, logw, u):
    """One chunk, batched over [B, H]: r, k, v, logw [B, L, H, hd] float32
    (logw <= 0), u [H, hd], state S [B, H, hd_k, hd_v]. Returns (S_new,
    out [B, L, H, hd])."""
    L = r.shape[1]
    logA = torch.cumsum(logw, dim=1)                  # [B, L, H, K]
    a_prev = torch.exp(logA - logw)                   # A_{t-1}
    a_end = torch.exp(logA[:, -1])                    # [B, H, K]
    rp = r * a_prev
    kd = k * torch.exp(-logA)
    scores = torch.einsum("blhk,bmhk->bhlm", rp, kd)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                     -1)
    scores = torch.where(tri, scores, 0.0)            # strictly causal
    diag = torch.einsum("blhk,blhk,hk->blh", r, k, u)  # the bonus term
    out = torch.einsum("bhlm,bmhv->blhv", scores, v)
    out = out + torch.einsum("blhk,bhkv->blhv", rp, S)
    out = out + diag[..., None] * v
    k_end = k * torch.exp(logA[:, -1][:, None] - logA)   # decay to chunk end
    S_new = a_end[..., None] * S + torch.einsum("blhk,blhv->bhkv", k_end, v)
    return S_new, out


def rwkv6_time_mix(p: dict, cfg: RWKV6Config, x: torch.Tensor,
                   state: dict | None = None, split=None, model_axis=None):
    """x [B, T, d] from ``state`` (None: zeros) -> (out [B, T, d] in x's
    dtype, {"x_tm": x[:, -1], "S": the state after x}). ``split`` (a
    ``tensor_parallel.MixSplit``) and ``model_axis``: this worker's heads
    of a split model (``p`` then holds its shards; module docstring)."""
    b, t, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    L = _chunks(t, cfg.chunk)
    last = state["x_tm"] if state is not None else None
    xr, xk, xv, xw, xg = _rwkv_mix_streams(p, x, _shift(x, last))
    logw = -torch.exp(p["w0"] + torch.tanh(xw @ p["w_lora_a"])
                      @ p["w_lora_b"])
    ln = p["ln_scale"], p["ln_bias"]
    if split is not None:
        lo, hi = split.heads
        cols = slice(lo * hd, hi * hd)
        r, k, v, g = tp.columns([(xr, p["wr"]), (xk, p["wk"]),
                                 (xv, p["wv"]), (xg, p["wg"])], model_axis)
        logw = tp.copy_to(logw, model_axis)[..., cols]
        ln = tp.copy_to(torch.stack(ln), model_axis)[:, cols].unbind(0)
        h = hi - lo
    else:
        r, k, v, g = xr @ p["wr"], xk @ p["wk"], xv @ p["wv"], xg @ p["wg"]
    r = r.reshape(b, t, h, hd).to(F32)
    k = k.reshape(b, t, h, hd).to(F32)
    v = v.reshape(b, t, h, hd).to(F32)
    g = F.silu(g)
    logw = logw.reshape(b, t, h, hd).to(F32)

    u = p["u"].to(F32)
    S = (state["S"] if state is not None
         else torch.zeros((b, h, hd, hd), dtype=F32, device=x.device))
    outs = []
    for c in range(0, t, L):
        S, o = _wkv_chunk(S, r[:, c:c + L], k[:, c:c + L], v[:, c:c + L],
                          logw[:, c:c + L], u)
        outs.append(o)
    out = torch.cat(outs, dim=1)
    out = _group_norm(out, ln[0].to(F32), ln[1].to(F32))
    y = out.to(x.dtype) * g
    y = y @ p["wo"] if split is None else tp.row(y, p["wo"], model_axis)
    return y, {"x_tm": x[:, -1], "S": S}


def rwkv6_time_mix_step(p: dict, cfg: RWKV6Config, x: torch.Tensor,
                        state: dict):
    """The exact one-token recurrence: x [B, 1, d] from ``state`` ->
    (out [B, 1, d], the new state)."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    xr, xk, xv, xw, xg = _rwkv_mix_streams(p, x, state["x_tm"][:, None])
    r = (xr @ p["wr"]).reshape(b, h, hd).to(F32)
    k = (xk @ p["wk"]).reshape(b, h, hd).to(F32)
    v = (xv @ p["wv"]).reshape(b, h, hd).to(F32)
    g = F.silu(xg @ p["wg"])[:, 0]
    w = torch.exp(-torch.exp(p["w0"] + torch.tanh(xw @ p["w_lora_a"])
                             @ p["w_lora_b"]))
    w = w.reshape(b, h, hd).to(F32)
    S = state["S"]                                    # [B, H, K, V]
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    att = S + p["u"].to(F32)[None, :, :, None] * kv
    out = torch.einsum("bhk,bhkv->bhv", r, att)
    S_new = w[..., None] * S + kv
    out = _group_norm(out, p["ln_scale"].to(F32), p["ln_bias"].to(F32))
    out = (out.to(x.dtype) * g) @ p["wo"]
    return out[:, None], {"x_tm": x[:, -1], "S": S_new}


def rwkv6_channel_mix(p: dict, x: torch.Tensor, state: dict | None = None,
                      model_axis=None):
    """x [B, T, d] from ``state`` (None: zeros) -> (the token-shifted
    squared-ReLU FFN, gated by sigmoid of its receptance, [B, T, d],
    {"x_cm": x[:, -1]}). ``model_axis``: a split model's (``wk``'s
    columns and ``wv``'s rows, the receptance whole)."""
    last = state["x_cm"] if state is not None else None
    dx = _shift(x, last) - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    if model_axis is None:
        kv = torch.square(torch.relu(xk @ p["wk"])) @ p["wv"]
    else:
        kv = tp.row(torch.square(torch.relu(tp.columns(
            [(xk, p["wk"])], model_axis)[0])), p["wv"], model_axis)
    return torch.sigmoid(xr @ p["wr"]) * kv, {"x_cm": x[:, -1]}


def init_rwkv6_state(cfg: RWKV6Config, batch: int, dtype=torch.bfloat16,
                     device="cpu") -> dict:
    """The zero state: x_tm, x_cm [B, d] in ``dtype``, S [B, H, hd, hd]
    float32."""
    h, hd = cfg.num_heads, cfg.head_dim
    return {"x_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
            "x_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
            "S": torch.zeros((batch, h, hd, hd), dtype=F32, device=device)}


# ===========================================================================
# Mamba-2 (SSD)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


def mamba2_shapes(cfg: Mamba2Config) -> dict[str, tuple[int, ...]]:
    """The mixer's leaves (under ``mix/``) and their shapes, in the JAX
    order."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.num_heads
    return {"in_proj": (d, 2 * di + 2 * n + h),
            "conv_w": (cfg.conv_width, cfg.conv_dim),
            "conv_b": (cfg.conv_dim,), "a_log": (h,), "dt_bias": (h,),
            "d_skip": (h,), "norm_scale": (di,), "out_proj": (di, d)}


def init_mamba2(ini, cfg: Mamba2Config, layers: int | None = None,
                keep=None) -> dict[str, torch.Tensor]:
    """The JAX package's distributions: the convolution N(0, 0.1) with
    bias 0, ``a_log`` 0 (A = -1), ``dt_bias`` -2 (a small initial dt),
    ``d_skip`` and the norm's scale 1, the projections N(0, 1/fan-in) on
    axis 0; ``layers`` stacks that many copies on a leading axis, and
    ``keep(name, leaf)`` takes each leaf as it is drawn."""
    return _draw(ini, mamba2_shapes(cfg),
                 {"conv_b": 0.0, "a_log": 0.0, "dt_bias": -2.0,
                  "d_skip": 1.0, "norm_scale": 1.0},
                 {"conv_w": 0.1}, layers, keep)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal convolution: x [B, T, C], w [W, C], b [C], from
    ``state`` [B, W-1, C] (None: zeros); the taps summed left to right
    from 0, then the bias, in x's dtype. Returns (out, the last W-1
    inputs)."""
    width, t = w.shape[0], x.shape[1]
    pad = (torch.zeros((x.shape[0], width - 1, x.shape[-1]), dtype=x.dtype,
                       device=x.device) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + t] * w[i] for i in range(width)) + b
    return out, xp[:, -(width - 1):]


def _ssd_chunk(S: torch.Tensor, x, Bm, Cm, loga, dt):
    """One SSD chunk, batched: x [B, L, H, hd]; Bm, Cm [B, L, N]; loga, dt
    [B, L, H]; state S [B, H, N, hd]. Returns (S_new, y [B, L, H, hd])."""
    L = x.shape[1]
    logA = torch.cumsum(loga, dim=1)                   # [B, L, H]
    decay_end = torch.exp(logA[:, -1])                 # [B, H]
    # intra-chunk: scores[t, s] = exp(logA_t - logA_s) (C_t . B_s) dt_s
    rel = logA[:, :, None, :] - logA[:, None, :, :]    # [B, L, L, H]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    rel = torch.where(tri[None, :, :, None], rel, -torch.inf)
    cb = torch.einsum("bln,bmn->blm", Cm, Bm)          # [B, L, L]
    scores = torch.exp(rel) * cb[..., None] * dt[:, None, :, :]
    y = torch.einsum("blmh,bmhd->blhd", scores, x)
    # inter-chunk: y_t += exp(logA_t) C_t^T S
    y = y + torch.exp(logA)[..., None] * torch.einsum("bln,bhnd->blhd",
                                                      Cm, S)
    w_end = torch.exp(logA[:, -1][:, None] - logA) * dt     # [B, L, H]
    S_new = (decay_end[..., None, None] * S
             + torch.einsum("blh,bln,blhd->bhnd", w_end, Bm, x))
    return S_new, y


def _mamba_split_in(p: dict, cfg: Mamba2Config, x: torch.Tensor, split,
                    ma) -> tuple:
    """A split mixer's inputs to the scan on this worker's heads: the
    leaves ``in_proj``, ``conv_w`` and ``conv_b`` put together
    (``gather_summed``; in_proj's columns [z | x | B | C | dt], the
    convolution's [x | B | C]); its heads' columns of z, x and dt through
    the split (``columns``), the convolution on its x channels; B and C
    formed alike on every worker from ``x`` before the split, then copied
    into it in float32 (their gradient, summed over every worker's heads,
    rounds once to x's dtype). Returns (z, xs, dt, Bm32, Cm32, the
    convolution's last inputs)."""
    lo, hi = split.heads
    di, n, hd = cfg.d_inner, cfg.d_state, cfg.head_dim
    dev = x.device
    xs = torch.arange(lo * hd, hi * hd, device=dev)
    bc = torch.arange(di, di + 2 * n, device=dev)
    own = {"in_proj": torch.cat([xs, di + xs, torch.arange(
               2 * di + 2 * n + lo, 2 * di + 2 * n + hi, device=dev)]),
           "conv_w": xs, "conv_b": xs}
    same = {"in_proj": di + bc, "conv_w": bc, "conv_b": bc}
    w = {k: tp.gather_summed(p[k], spec, ma, same[k])
         for k, spec in split.gather.items()}

    def part(k, cols):
        return w[k].index_select(-1, cols)
    m = hd * (hi - lo)
    z, xs_, dt = torch.split(tp.columns([(x, part("in_proj", own["in_proj"]))],
                                        ma)[0], [m, m, hi - lo], dim=-1)
    xs_, conv_x = _causal_conv(xs_, part("conv_w", xs), part("conv_b", xs))
    bm, conv_bc = _causal_conv(x @ part("in_proj", same["in_proj"]),
                               part("conv_w", bc), part("conv_b", bc))
    Bm32, Cm32 = torch.split(tp.copy_to(F.silu(bm).to(F32), ma), [n, n],
                             dim=-1)
    return (z, F.silu(xs_), dt, Bm32, Cm32,
            torch.cat([conv_x, conv_bc], dim=-1))


def mamba2_mix(p: dict, cfg: Mamba2Config, x: torch.Tensor,
               state: dict | None = None, split=None, model_axis=None):
    """x [B, T, d] from ``state`` (None: zeros) -> (out [B, T, d] in x's
    dtype, {"conv": the convolution's last inputs in x's dtype, "S"}).
    ``split`` (a ``tensor_parallel.MixSplit``) and ``model_axis``: this
    worker's heads of a split model (module docstring)."""
    b, t, _ = x.shape
    n, h, hd = cfg.d_state, cfg.num_heads, cfg.head_dim
    if split is not None:
        h = split.heads[1] - split.heads[0]
        z, xs, dt, Bm32, Cm32, conv = _mamba_split_in(p, cfg, x, split,
                                                      model_axis)
    di = h * hd
    L = _chunks(t, cfg.chunk)
    if split is None:
        z, xbc, dt = torch.split(x @ p["in_proj"], [di, di + 2 * n, h],
                                 dim=-1)
        xbc, conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 state["conv"] if state is not None
                                 else None)
        xs, Bm, Cm = torch.split(F.silu(xbc), [di, n, n], dim=-1)
        Bm32, Cm32 = Bm.to(F32), Cm.to(F32)

    dt = softplus(dt.to(F32) + p["dt_bias"])                       # [B, T, H]
    loga = -torch.exp(p["a_log"].to(F32)) * dt
    xh = xs.reshape(b, t, h, hd).to(F32)

    S = (state["S"] if state is not None
         else torch.zeros((b, h, n, hd), dtype=F32, device=x.device))
    ys = []
    for c in range(0, t, L):
        S, y = _ssd_chunk(S, xh[:, c:c + L], Bm32[:, c:c + L],
                          Cm32[:, c:c + L], loga[:, c:c + L],
                          dt[:, c:c + L])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + p["d_skip"].to(F32)[:, None] * xh
    y = y.reshape(b, t, di).to(x.dtype)

    # gated RMSNorm (mamba2: no 1 + scale), then the out projection
    y = y * F.silu(z)
    sq = torch.square(y.to(F32))
    if split is None:
        var = sq.mean(-1, keepdim=True)
    else:           # the mean over all of d_inner: the workers' sums summed
        var = tp.reduce_both(sq.sum(-1, keepdim=True),
                             model_axis) / cfg.d_inner
    y = (y.to(F32) * torch.rsqrt(var + 1e-6)).to(x.dtype)
    y = y * p["norm_scale"]
    out = (y @ p["out_proj"] if split is None
           else tp.row(y, p["out_proj"], model_axis))
    return out, {"conv": conv.to(x.dtype), "S": S}


def init_mamba2_state(cfg: Mamba2Config, batch: int, dtype=torch.bfloat16,
                      device="cpu") -> dict:
    """The zero state: conv [B, W-1, conv_dim] in ``dtype``, S [B, H, N,
    hd] float32."""
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, cfg.conv_dim),
                                dtype=dtype, device=device),
            "S": torch.zeros((batch, cfg.num_heads, cfg.d_state,
                              cfg.head_dim), dtype=F32, device=device)}
