"""Paper section 5.3 (adapted): asynchronous shared-memory SVM (port of
``repro.experiments.conflicts``).

The JAX package simulates the shared-memory atomic updates, as a TPU has
none, and keeps the paper's claim (sparsification cuts the write conflicts
between workers, the more so the more workers) with:

  1. an analytic and Monte Carlo conflict model: coordinate i is
     conflicted when at least 2 of M workers select it in one update
     window (``conflict_stats``);
  2. a sequential simulation of Algorithm 4 training an l2-regularized SVM
     on the paper's synthetic data, where each conflicted write costs an
     atomic retry (``run_async_svm``).

The port runs both as the JAX package does, with the pure solvers of
``core.sparsify`` (``vmap`` over the workers), and the JAX benchmark's
backend check (``backend_parity``: the kernels' lambda against the pure
solver's). Algorithm 4
with real atomics on the card is a later option (ROADMAP.md queue A item
5). The Monte Carlo draws, the minibatch indices and the sampling uniforms
come from explicit ``torch.Generator`` streams seeded by ``seed``; the
analytic model is float64 numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import sparsify
from repro_torch.data.synthetic import svm_data
from repro_torch.devices import resolve_device
from repro_torch.kernels.sparsify import ops

F32 = torch.float32


def svm_loss(w, x, y, lam2):
    """Mean hinge loss plus ``lam2 ||w||^2``."""
    return torch.relu(1.0 - y * (x @ w)).mean() + lam2 * torch.sum(w * w)


def svm_grad(w, x, y, lam2):
    """The gradient of ``svm_loss`` in w, in closed form (the tests hold it
    to ``jax.grad``; relu's derivative is 0 at 0, as in JAX): ``-x^T (y
    [1 - y x w > 0]) / B + 2 lam2 w``, one per minibatch of the leading
    axes of ``x [..., B, d]``, ``y [..., B]``."""
    s = y * (1.0 - y * (x @ w) > 0).to(x.dtype)
    return -(s.unsqueeze(-2) @ x).squeeze(-2) / x.shape[-2] + 2 * lam2 * w


def _mc_uniforms(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, dtype=F32, device=device)


def conflict_stats(p: torch.Tensor, workers: int, trials: int = 256,
                   seed: int = 0) -> dict:
    """Per-step write traffic for the per-coordinate selection probability
    ``p`` (the same law for every worker), on p's device:

      writes            E[# coordinate writes]  (= M sum p)
      conflicted_writes E[# writes to a coordinate another worker also
                        writes]  (Monte Carlo over ``trials`` windows and
                        the float64 analytic model)

    plus the Monte Carlo means' standard errors (``*_se``: the per-window
    standard deviation over sqrt(trials))."""
    u = _mc_uniforms((trials, workers, p.shape[0]), seed, p.device)
    hits = (u < p[None, None, :]).to(F32).sum(1)            # [trials, d]
    conf = torch.where(hits >= 2, hits, 0.0).sum(-1)
    writes = hits.sum(-1)
    pn = p.double().cpu().numpy()
    collide = 1.0 - (1.0 - pn) ** (workers - 1)
    return {"writes": float(writes.mean()),
            "conflicted_mc": float(conf.mean()),
            "conflicted_analytic": float((pn * workers * collide).sum()),
            "writes_analytic": float(pn.sum() * workers),
            "writes_se": float(writes.double().std() / trials ** 0.5),
            "conflicted_se": float(conf.double().std() / trials ** 0.5)}


def backend_parity(g: torch.Tensor, rho: float = 0.05, workers: int = 32,
                   num_iters: int = 4, trials: int = 256,
                   seed: int = 0) -> dict:
    """The JAX benchmark's backend check on one gradient ``g``: the pure
    solver's p against ``p = min(lambda |g|, 1)`` with the kernels' lambda
    (``ops.gspar_lambda``: the stats and tail passes), the conflict model
    of each, and ``p_maxdiff``."""
    p_ref = sparsify.greedy_probabilities(g, rho, num_iters=num_iters)
    lam = ops.gspar_lambda(g, rho=rho, num_iters=num_iters)
    a = g.abs().to(F32)
    p_ker = torch.where(a > 0, torch.clamp_max(lam * a, 1.0), 0.0)
    return {"reference": conflict_stats(p_ref, workers, trials, seed),
            "kernel": conflict_stats(p_ker, workers, trials, seed),
            "p_maxdiff": float((p_ref - p_ker).abs().max())}


def make_svm_step(x, y, lam2, *, method: str, rho: float, lr0: float,
                  conflict_penalty: float):
    """``step(w, t, idx, u) -> (w, time_cost, conflict_rate)``: window t
    (from 0) of Algorithm 4 for the workers' index rows ``idx [workers,
    batch]``; gspar samples each worker's greedy p (2 rescales) with the
    uniforms ``u [workers, d]`` (dense takes none); ``eta = lr0 / (t +
    1)``. Every write costs 1 time unit, a conflicted one ``1 +
    conflict_penalty``."""
    def step(w, t, idx, u=None):
        g = svm_grad(w, x[idx], y[idx], lam2)
        if method == "dense":
            q, masks = g, torch.ones_like(g)
        else:
            p = vmap(lambda r: sparsify.greedy_probabilities(r, rho, 2))(g)
            q = sparsify.sparsify(u, g, p)
            masks = (q.abs() > 0).to(F32)
        hits = masks.sum(0)
        writes = hits.sum()
        conflicted = torch.where(hits >= 2, hits, 0.0).sum()
        f32 = dict(dtype=F32, device=w.device)
        eta = torch.full((), lr0, **f32) / (torch.full((), t, **f32) + 1.0)
        w = w - eta * q.mean(0)
        return (w, writes + conflict_penalty * conflicted,
                conflicted / torch.clamp_min(writes, 1.0))
    return step


def run_async_svm(*, method="gspar", rho=0.1, workers=16, steps=400,
                  batch=32, lr0=0.5, reg=0.1, conflict_penalty=4.0, seed=0,
                  n=8192, d=256, record_every=20, device=None):
    """Sequential simulation of Algorithm 4. Returns the (simulated time,
    loss) curves and the mean conflict rate."""
    dev = resolve_device(device)
    x, y, _ = svm_data(seed, n=n, d=d, device=dev)
    step = make_svm_step(x, y, reg, method=method, rho=rho, lr0=lr0,
                         conflict_penalty=conflict_penalty)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    w = torch.zeros(d, dtype=F32, device=dev)
    costs, rates, record = [], [], []
    for t in range(steps):
        idx = torch.randint(0, n, (workers, batch), generator=gen,
                            device=dev)
        u = None if method == "dense" else torch.rand(
            (workers, d), generator=gen, dtype=F32, device=dev)
        w, cost, rate = step(w, t, idx, u)
        costs.append(cost)
        rates.append(rate)
        if t % record_every == 0 or t == steps - 1:
            record.append((t, w))
    sim_time = torch.stack(costs).double().cpu().cumsum(0).numpy()
    losses = torch.stack([svm_loss(w, x, y, reg) for _, w in record])
    return (sim_time[[t for t, _ in record]],
            losses.cpu().numpy().astype(np.float64),
            float(torch.stack(rates).double().mean()))
