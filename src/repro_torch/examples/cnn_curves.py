"""The CNN experiment's loss curves (``experiments.cnn.run_cnn``, the
paper's section 5.2 at ``bench_cnn.py``'s size: 24 channels, 200 steps),
one line per seed, through the kernels or through their plain versions.

    PYTHONPATH=src python -m repro_torch.examples.cnn_curves --device cpu \\
        --seeds 0 1 2
    PYTHONPATH=src python -m repro_torch.examples.cnn_curves --seeds 0 1 \\
        --plain --deterministic

On the CPU the wrappers take their plain versions. On the card ``--plain``
makes them take the plain versions too (on the card's tensors), so the
two curves of one seed differ only by the kernels; ``--deterministic``
selects cuDNN's deterministic algorithms, without which a seed's curve
moves between runs. Each line gives the seed, the first record, the
median and the largest of the records after it, the last, and the curve.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.experiments.cnn import run_cnn
from repro_torch.kernels.sparsify import kernel as K


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="gspar")
    ap.add_argument("--rho", type=float, default=0.02)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--channels", type=int, default=24)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--plain", action="store_true",
                    help="the kernels' plain versions on the card")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = args.deterministic
        torch.backends.cudnn.benchmark = False
    if args.plain:
        K._on_card = lambda *a, **k: False
    for seed in args.seeds:
        losses, _, _ = run_cnn(method=args.method, rho=args.rho,
                               channels=args.channels, steps=args.steps,
                               seed=seed, device=device)
        print(json.dumps({
            "seed": seed, "plain": args.plain or device.type == "cpu",
            "first": float(losses[0]),
            "median_after_first": float(np.median(losses[1:])),
            "max_after_first": float(losses[1:].max()),
            "last": float(losses[-1]), "losses": losses.tolist()}),
            flush=True)


if __name__ == "__main__":
    main()
