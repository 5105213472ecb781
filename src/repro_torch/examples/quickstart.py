"""Quickstart: train a linear SVM with DSO (the paper's algorithm).

    python -m repro_torch.examples.quickstart [--device cpu|cuda]
"""

from __future__ import annotations

import argparse

from repro_torch.data.synthetic import make_classification
from repro_torch.engine import solve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    # A sparse binary classification problem (real-sim-like)
    prob = make_classification(m=2000, d=800, density=0.01, loss="hinge",
                               lam=1e-4, seed=0, device=args.device)
    print(f"m={prob.m} d={prob.d} |Omega|={int(prob.nnz)} lam={prob.lam}")
    print("running DSO (4 simulated processors, block-cyclic schedule)...")
    # backend="auto" picks the block-ELL sparse layout at this density (on
    # the card its kernel); schedule/backend are pluggable — see
    # repro_torch/engine/__init__.py
    w, alpha, hist = solve(prob, backend="auto", schedule="cyclic", p=4,
                           epochs=30, eta0=0.5, eval_every=5,
                           device=args.device)[:3]
    for h in hist:
        print(f"  epoch {h['epoch']:3d}  primal={h['primal']:.5f}  "
              f"duality gap={h['gap']:.5f}")
    acc = float(((prob.X @ w) * prob.y > 0).float().mean())
    print(f"train accuracy: {acc:.3f}")
    assert hist[-1]["gap"] < hist[0]["gap"]
    return hist


if __name__ == "__main__":
    main()
