"""The runs behind ``chip_smoke.py`` phase 7t's gate (d), on the card.

Gate (d) trains zamba2-7b's first group (6 layers at full width, bf16,
B 2 x T 4,096 of the Markov pipeline, 20 AdamW steps, warm-up 5,
``remat=False``) from each of its seeds through the kernels and through
the plain versions, and asks of the means over the seeds that the loss
falls (the mean of the first 3 losses less the mean of the last 3) and
that the kernels' losses stay near the plain versions'.  This script
runs chip_smoke's own training (``train_run`` through the kernels,
``plain_losses`` through the plain versions, ``learn_stats``) at other
learning rates and seeds, so that the gate's learning rate and margins
can be set from runs of a correct gradient:

    PYTHONPATH=src python -m repro_torch.bench.learn_gate \\
        [--lr 1e-3 3e-4] [--seeds 82 83 84]

Prints the card's ``nvidia-smi`` name and power limit, one line per run
(the kernels' 20 losses, the plain versions', the fall and the mean
|loss - plain loss|), then per learning rate the means over the seeds.
About 11 s a run with the kernels, 17 s with the plain versions.  Needs a
CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-3, 3e-4])
    ap.add_argument("--seeds", type=int, nargs="+", default=[82, 83, 84])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("learn_gate: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.training import optimizer as opt
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = build.library()
    print(f"built {lib.path} in {lib.build_s:.2f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = cs.model_config("zamba2-7b", n_layers=6)
    summary = []
    for lr in args.lr:
        ocfg = opt.AdamWConfig(lr=lr, warmup_steps=5,
                               total_steps=cs.TRAIN_STEPS)
        stats = []
        for seed in args.seeds:
            got, *rest = cs.train_run(
                f"lr {lr:g} seed {seed}", cfg, ocfg, dev, cs.TRAIN_B,
                cs.TRAIN_T, cs.TRAIN_STEPS, cs.GROUP_STEP_LAUNCHES, seed)
            del rest
            torch.cuda.empty_cache()
            plain = cs.plain_losses(cfg, ocfg, dev, seed)
            stats.append(cs.learn_stats(got, plain))
            print(f"lr {lr:g} seed {seed}: kernels "
                  f"{[round(x, 4) for x in got]}, plain "
                  f"{[round(x, 4) for x in plain]}; fell {stats[-1][0]:.4f} "
                  f"(plain {cs.learn_stats(plain, plain)[0]:.4f}), mean "
                  f"|loss - plain| {stats[-1][1]:.4f}", flush=True)
        summary.append(f"lr {lr:g} seeds {args.seeds}: mean fall "
                       f"{sum(f for f, _ in stats) / len(stats):.4f}, mean "
                       f"|loss - plain| "
                       f"{sum(d for _, d in stats) / len(stats):.4f}")
    print("\n".join(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
