"""Device-time breakdown of the training launcher under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile --out prof.json -- \\
        --arch gemma-2b --steps 2 --compressor gspar --rho 0.05 \\
        --wire gather --error-feedback

Runs ``repro_torch.launch.train`` with the given arguments (after ``--``)
inside a profiler that traces the CPU and the card, and prints one JSON
line: the run's wall seconds, the device time summed over every traced
device event (kernels, copies, memsets), and the ``--top`` device events
by time (milliseconds, and calls). The whole run is traced, model
initialisation included; the launcher's own step times are in
``train.step_seconds``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None,
                    help="also write the JSON and the profiler table here")
    ap.add_argument("train_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    train_args = [a for a in args.train_args if a != "--"]
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        summary = train.main(train_args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, memsets): the CPU ops that
    # launched them report the same time again
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    result = {
        "wall_s": wall, "device_ms": device_ms,
        "train": {"step_seconds": summary["step_seconds"],
                  "max_memory_allocated": summary.get(
                      "max_memory_allocated")},
        "top": [{"name": e.key[:120],
                 "device_ms": e.self_device_time_total / 1e3,
                 "calls": e.count}
                for e in events[:args.top] if e.self_device_time_total > 0],
    }
    print(json.dumps({"profile": result}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        with open(args.out + ".txt", "w") as f:
            f.write(prof.key_averages().table(row_limit=40))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
