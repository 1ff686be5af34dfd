"""Paper section 5.1: distributed SGD and SVRG on l2-regularized logistic
regression with per-worker gradient sparsification, M workers simulated in
one process (port of ``repro.experiments.convex``).

  * M = 4 workers, minibatch 8 per worker (the paper's defaults);
  * step sizes: GSpar and UniSp SGD ``eta_t = lr0 / ((t + 1) var)``, the
    others ``lr0 / (t + 1)``; SVRG ``eta = lr0 / var``, with ``var =
    sum ||Q(g)||^2 / sum ||g||^2`` accumulated over workers and steps;
  * SVRG sparsifies the correction ``g(w) - g(w~)`` and adds the dense
    reference gradient after (the paper's equation 15), charging ``d b M``
    bits a reference broadcast;
  * bits: the coding model of each message (section 3.3).

A step compresses the M workers' gradients as one ``[M, d]`` batch
(``Compressor.rows``: the dense wire's kernels, one launch each, lambda per
row). The minibatch indices and the uniforms are drawn from one
``torch.Generator`` seeded by ``seed`` (indices, then the selector's
``[M, d]`` uniforms, then a stochastic codec's) and handed to the step
functions (``make_sgd_step``, ``make_svrg_step``) as inputs. Scalars that
the JAX package forms as float32 arrays are float32 tensors here, divided
as tensors; nothing is read back to the host until a run ends.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core._compressors import Compressor, make_compressor
from repro_torch.devices import resolve_device
from repro_torch.optim.optimizers import SVRG, sgd

F32 = torch.float32
F64 = torch.float64


def logreg_loss(w, x, y, lam2):
    """Mean logistic loss plus ``lam2 ||w||^2``."""
    margins = -y * (x @ w)
    return (torch.logaddexp(margins.new_zeros(()), margins).mean()
            + lam2 * torch.sum(w * w))


def logreg_grad(w, x, y, lam2):
    """The gradient of ``logreg_loss`` in w, in closed form (the tests hold
    it to ``jax.grad``): ``-x^T (y sigmoid(margins)) / B + 2 lam2 w``. With
    ``x [..., B, d]`` and ``y [..., B]`` each minibatch of the leading axes
    gives its own gradient ``[..., d]``."""
    s = y * torch.sigmoid(-y * (x @ w))
    return -(s.unsqueeze(-2) @ x).squeeze(-2) / x.shape[-2] + 2 * lam2 * w


def _scalar(x, device) -> torch.Tensor:
    return torch.full((), x, dtype=F32, device=device)


def solve_reference(x, y, lam2, iters: int = 4000, lr: float = 1.0):
    """Near-optimal ``w*`` by full-batch gradient descent (the problem is
    strongly convex), on x's device; returns ``(w*, f*)``."""
    w = torch.zeros(x.shape[1], dtype=F32, device=x.device)
    for _ in range(iters):
        w = w - lr * logreg_grad(w, x, y, lam2)
    return w, float(logreg_loss(w, x, y, lam2))


@dataclasses.dataclass
class RunResult:
    passes: np.ndarray         # data passes at each record point
    subopt: np.ndarray         # f(w_t) - f*
    bits: np.ndarray           # cumulative communicated bits (all workers)
    var_ratio: float           # the paper's reported `var`
    density: float             # the target density


def _worker_grads(w, x, y, lam2, idx):
    """Per-worker minibatch gradients ``[M, d]`` for indices ``[M, B]``."""
    return logreg_grad(w, x[idx], y[idx], lam2)


def _compressor(method: str, rho: float, b_bits: int,
                qsgd_bits: int = 4) -> Compressor:
    if method == "gspar":
        return make_compressor("gspar", algo="greedy", rho=rho, b=b_bits)
    if method == "unisp":
        return make_compressor("unisp", rho=rho, b=b_bits)
    if method == "qsgd":
        return make_compressor("qsgd", bits=qsgd_bits)
    return make_compressor("none", b=b_bits)


def draw(generator: torch.Generator, comp: Compressor, M: int, batch: int,
         n: int, d: int):
    """One step's random inputs: minibatch indices ``[M, batch]``, then the
    selector's ``[M, d]`` float32 uniforms and a stochastic codec's (None
    where the scheme draws none)."""
    dev = generator.device
    idx = torch.randint(0, n, (M, batch), generator=generator, device=dev)
    rand = dict(generator=generator, dtype=F32, device=dev)
    u = torch.rand((M, d), **rand) if comp.scheme.selector.samples else None
    u_cod = torch.rand((M, d), **rand) if comp.scheme.codec.stochastic \
        else None
    return idx, u, u_cod


def _var(var_num, var_den):
    return torch.where(var_den > 0, var_num / var_den, 1.0)


def make_sgd_step(x, y, lam2, comp: Compressor, *, lr0: float,
                  adaptive: bool):
    """``step(w, t, var_num, var_den, idx, u, u_cod) -> (w, bits, var_num,
    var_den)``: one distributed-SGD step (``t`` the step count, from 0),
    with ``eta = lr0 / ((t + 1) max(var, 1))`` when ``adaptive``, else
    ``lr0 / (t + 1)``."""
    def step(w, t, var_num, var_den, idx, u=None, u_cod=None):
        grads = _worker_grads(w, x, y, lam2, idx)
        cg = comp.rows(grads, u, u_cod)
        q_mean = cg.q.mean(0)
        var_num = var_num + (cg.q ** 2).sum(-1).sum()
        var_den = var_den + (grads ** 2).sum(-1).sum()
        t1 = _scalar(t, w.device) + 1.0
        num = _scalar(lr0, w.device)
        eta = num / (t1 * torch.clamp_min(_var(var_num, var_den), 1.0)) \
            if adaptive else num / t1
        return w - eta * q_mean, cg.bits.sum(), var_num, var_den
    return step


def make_svrg_step(x, y, lam2, comp: Compressor, svrg: SVRG):
    """``step(w, state, var_num, var_den, idx, u) -> (w, state, bits,
    var_num, var_den)``: one SVRG inner step on ``svrg``'s reference
    (``state``): the workers' corrections ``g(w) - g(w~)`` sparsified, the
    dense reference gradient added, ``eta = lr0 / max(var, 1)`` (the inner
    ``sgd`` at ``var_scale = max(var, 1)``). ``w`` is updated in place."""
    def step(w, state, var_num, var_den, idx, u=None):
        g_w = _worker_grads(w, x, y, lam2, idx)
        g_r = _worker_grads(state["ref_params"][0], x, y, lam2, idx)
        corr = svrg.correct(state, [g_w], [g_r])[0]
        g_ref = state["ref_grad"][0]
        cg = comp.rows(corr, u)
        vr = cg.q.mean(0) + g_ref
        var_num = var_num + ((cg.q + g_ref) ** 2).sum(-1).sum()
        var_den = var_den + ((corr + g_ref) ** 2).sum(-1).sum()
        var = torch.clamp_min(_var(var_num, var_den), 1.0)
        (w,), state = svrg.update([vr], state, [w], var_scale=var)
        return w, state, cg.bits.sum(), var_num, var_den
    return step


def _curves(x, y, lam2, f_star, record, increments):
    """Host copies at the end of a run: suboptimality at the record points
    and the cumulative bits there (a float64 running sum, in step order)."""
    losses = torch.stack([logreg_loss(w, x, y, lam2) for _, w in record])
    subopt = [max(float(v) - f_star, 1e-12) for v in losses.cpu()]
    cum = torch.stack(increments).to(F64).cpu().cumsum(0).numpy()
    return np.array(subopt), cum[[k for k, _ in record]]


def run_sgd(x, y, lam2, *, method="gspar", rho=0.1, M=4, batch=8,
            epochs=30, lr0=0.5, f_star=0.0, seed=0, b_bits=32,
            qsgd_bits=4, record_every=8, device=None) -> RunResult:
    """One distributed-SGD run. method: gspar | unisp | dense | qsgd."""
    dev = resolve_device(device)
    x, y = x.to(dev), y.to(dev)
    n, d = x.shape
    steps_per_epoch = max(1, n // (M * batch))
    total_steps = epochs * steps_per_epoch
    comp = _compressor(method, rho, b_bits, qsgd_bits)
    step = make_sgd_step(x, y, lam2, comp, lr0=lr0,
                         adaptive=method in ("gspar", "unisp"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.zeros(d, dtype=F32, device=dev)
    van = vad = torch.zeros((), dtype=F32, device=dev)
    passes, record, bits = [], [], []
    for t in range(total_steps):
        w, b, van, vad = step(w, t, van, vad, *draw(gen, comp, M, batch, n,
                                                    d))
        bits.append(b)
        if t % record_every == 0 or t == total_steps - 1:
            passes.append(t * M * batch / n)
            record.append((len(bits) - 1, w))
    subopt, cum = _curves(x, y, lam2, f_star, record, bits)
    return RunResult(np.array(passes), subopt, cum,
                     float(_var(van, vad)), rho)


def run_svrg(x, y, lam2, *, method="gspar", rho=0.1, M=4, batch=8,
             outer=12, inner=None, lr0=0.2, f_star=0.0, seed=0, b_bits=32,
             record_every=8, device=None) -> RunResult:
    """Distributed SVRG with sparsified variance-reduced corrections.
    method: gspar | unisp | dense."""
    dev = resolve_device(device)
    x, y = x.to(dev), y.to(dev)
    n, d = x.shape
    inner = inner or max(1, n // (M * batch))
    comp = _compressor(method if method in ("gspar", "unisp") else "none",
                       rho, b_bits)
    svrg = SVRG(sgd(lr0))
    step = make_svrg_step(x, y, lam2, comp, svrg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.zeros(d, dtype=F32, device=dev)
    state = svrg.init([w])
    van = vad = torch.zeros((), dtype=F32, device=dev)
    broadcast = torch.full((), float(d * b_bits * M), dtype=F64, device=dev)
    passes, record, bits = [], [], []
    data_passes, t = 0.0, 0
    for _ in range(outer):
        state = svrg.set_reference(state, [w],
                                   [logreg_grad(w, x, y, lam2)])
        data_passes += 1.0                      # the full gradient's pass
        bits.append(broadcast)                  # its dense broadcast
        for _ in range(inner):
            idx, u, _ = draw(gen, comp, M, batch, n, d)
            w, state, b, van, vad = step(w, state, van, vad, idx, u)
            bits.append(b)
            data_passes += M * batch / n
            if t % record_every == 0:
                passes.append(data_passes)
                record.append((len(bits) - 1, w.clone()))
            t += 1
    subopt, cum = _curves(x, y, lam2, f_star, record, bits)
    return RunResult(np.array(passes), subopt, cum,
                     float(_var(van, vad)), rho)
