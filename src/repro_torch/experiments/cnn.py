"""Paper section 5.2: a convolutional network on CIFAR-shaped data with
per-layer gradient sparsification and Adam (lr 0.02), M = 4 workers
simulated in one process (port of ``repro.experiments.cnn``).

The network is the JAX package's: three 3x3 SAME convolutions, each with
batch-statistics batch norm (biased variance, eps 1e-5, no running
statistics) and relu, two 2x2 VALID max-pools (after the first two), a
256-wide fully-connected layer with relu and the softmax head. The
parameters keep the JAX layout (HWIO kernels, ``fc`` rows in NHWC flatten
order) and its flatten order (sorted names), so weights carry across by
name (``models.convert.cnn_params_from_jax``) and a worker's gradient
leaves are the JAX ones coordinate for coordinate. The forward runs in NCHW
(cuDNN's layout) on a permuted view of each kernel and permutes back to
NHWC before the flatten. Run it in float32: chip_smoke turns TF32 off, as
cuDNN allows it by default.

A step takes each worker's gradient (one backward pass per worker's index
row, batch norm over that worker's batch as under the JAX ``vmap``),
compresses every worker's leaves with ``compress_tree`` on the dense wire,
the worker axis as the stacked axis (each worker's leaf one row of its
shape group: one launch per kernel and group for all M workers, lambda per
row), averages over the workers and applies ``adam``. The minibatch
indices and the compression uniforms come from one ``torch.Generator``
seeded by ``seed + 1`` (indices first; ``compress_tree`` draws the uniforms
per shape group, in group order).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.api import CompressionConfig, compress_tree
from repro_torch.data.synthetic import image_data
from repro_torch.devices import resolve_device
from repro_torch.optim.optimizers import adam

F32 = torch.float32


def cnn_shapes(channels: int = 32, classes: int = 10) -> dict:
    """``{name: shape}`` in the JAX flatten order."""
    c = channels
    shapes = {"fc/b": (256,), "fc/w": (8 * 8 * c, 256),
              "head/b": (classes,), "head/w": (256, classes)}
    for i, cin in ((1, 3), (2, c), (3, c)):
        shapes.update({f"conv{i}/b": (c,), f"conv{i}/bn_b": (c,),
                       f"conv{i}/bn_s": (c,), f"conv{i}/w": (3, 3, cin, c)})
    return dict(sorted(shapes.items()))


def init_cnn(generator: torch.Generator, channels: int = 32,
             classes: int = 10) -> dict[str, torch.Tensor]:
    """He-normal kernels, zero biases, unit batch-norm scales, on the
    generator's device (the JAX package draws from a key)."""
    dev = generator.device
    out = {}
    for name, shape in cnn_shapes(channels, classes).items():
        if name.endswith("/w"):
            fan = int(np.prod(shape[:-1]))
            out[name] = torch.randn(shape, generator=generator, device=dev
                                    ) * (2.0 / fan) ** 0.5
        else:
            fill = 1.0 if name.endswith("bn_s") else 0.0
            out[name] = torch.full(shape, fill, dtype=F32, device=dev)
    return out


def _conv_bn_relu(params: dict, layer: str, x: torch.Tensor) -> torch.Tensor:
    p = {k: params[f"{layer}/{k}"] for k in ("w", "b", "bn_s", "bn_b")}
    y = F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding="same")
    mean = y.mean((0, 2, 3), keepdim=True)
    var = (y - mean).square().mean((0, 2, 3), keepdim=True)
    y = ((y - mean) * torch.rsqrt(var + 1e-5) * p["bn_s"][:, None, None]
         + p["bn_b"][:, None, None])
    return torch.relu(y)


def cnn_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits for NHWC images ``x``."""
    y = _conv_bn_relu(params, "conv1", x.permute(0, 3, 1, 2))
    y = F.max_pool2d(y, 2)
    y = _conv_bn_relu(params, "conv2", y)
    y = F.max_pool2d(y, 2)
    y = _conv_bn_relu(params, "conv3", y)
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)   # NHWC flatten
    y = torch.relu(y @ params["fc/w"] + params["fc/b"])
    return y @ params["head/w"] + params["head/b"]


def cnn_loss(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(cnn_forward(params, x), dim=-1)
    return -torch.gather(logp, 1, y[:, None]).mean()


def make_cnn_step(x, y, comp: CompressionConfig, opt):
    """``step(params, opt_state, idx, generator) -> (opt_state, bits,
    density)``: every worker's gradient on its rows of ``idx [M, B]``,
    compressed (uniforms from ``generator``), averaged, and the update
    applied to ``params`` (a dict in the flatten order) in place."""
    def step(params, opt_state, idx, generator):
        names = list(params)
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        per_worker = [torch.autograd.grad(cnn_loss(live, x[ix], y[ix]),
                                          list(live.values()))
                      for ix in idx]
        leaves = [torch.stack(g) for g in zip(*per_worker)]
        del per_worker
        q, _, stats = compress_tree(comp, generator, leaves,
                                    stacked=[True] * len(leaves))
        avg = [t.mean(0) for t in q]
        _, opt_state = opt.update(avg, opt_state,
                                  [params[k] for k in names])
        return opt_state, stats.bits, stats.density
    return step


def run_cnn(*, method="gspar", rho=0.05, channels=24, steps=150, M=4,
            batch_per=16, lr=0.02, seed=0, n_data=2048, record_every=10,
            device=None):
    """Returns (loss curve, cumulative bits curve, mean density)."""
    dev = resolve_device(device)
    x, y = image_data(seed, n=n_data, device=dev)
    params = init_cnn(torch.Generator(device=dev).manual_seed(seed),
                      channels)
    opt = adam(lr)
    state = opt.init(list(params.values()))
    comp = CompressionConfig(
        name=("none" if method == "dense" else method), rho=rho,
        min_leaf_size=0 if method != "dense" else 1 << 30)
    step = make_cnn_step(x, y, comp, opt)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    losses, bits, dens = [], [], []
    for t in range(steps):
        idx = torch.randint(0, n_data, (M, batch_per), generator=gen,
                            device=dev)
        state, b, density = step(params, state, idx, gen)
        bits.append(b)
        if t % record_every == 0 or t == steps - 1:
            losses.append(cnn_loss(params, x[:512], y[:512]))
            dens.append(density)
    cum = torch.stack(bits).double().cpu().cumsum(0).numpy()
    at = [t for t in range(steps) if t % record_every == 0 or t == steps - 1]
    return (torch.stack(losses).cpu().numpy().astype(np.float64), cum[at],
            float(torch.stack(dens).double().mean()))
