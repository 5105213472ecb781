"""Reproduce the paper's comparison (Sec. 5): DSO vs SGD vs PSGD vs BMRM on
SVM and logistic regression, with the paper's lambda sweep.

    python -m repro_torch.examples.svm_vs_baselines [--full]
        [--device cpu|cuda]

DSO runs through ``run_dso_grid(impl="auto")``: on the card the layout's
kernel backend (block-ELL at this density), where the reference's example
runs the dense plain path (``impl="jnp"``); the layouts agree to 1e-5 per
trajectory.  SGD, PSGD and BMRM are ``repro_torch.baselines``.
"""

from __future__ import annotations

import argparse

from repro_torch.baselines.bmrm import run_bmrm
from repro_torch.baselines.psgd import run_psgd
from repro_torch.baselines.sgd import run_sgd
from repro_torch.core.dso import run_dso_grid
from repro_torch.data.synthetic import paper_like


def compare(prob, *, device="cuda") -> dict:
    """Each method's last history entry on ``prob`` (the reference
    example's settings): DSO's primal and gap, SGD's, PSGD's and BMRM's
    primal."""
    a0 = 0.0005 if prob.loss_name == "logistic" else 0.0   # App. B init
    _, _, h_dso = run_dso_grid(prob, p=4, epochs=30, eta0=0.5, alpha0=a0,
                               impl="auto", device=device)
    _, h_sgd = run_sgd(prob, epochs=15, eta0=0.3, device=device)
    _, h_psgd = run_psgd(prob, p=4, epochs=15, eta0=0.3, device=device)
    _, h_bmrm = run_bmrm(prob, iters=25, device=device)
    return dict(dso=h_dso[-1]["primal"], dso_gap=h_dso[-1]["gap"],
                sgd=h_sgd[-1]["primal"], psgd=h_psgd[-1]["primal"],
                bmrm=h_bmrm[-1]["primal"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="sweep all lambdas of App. D/E")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    lambdas = [1e-3, 1e-4, 1e-5, 1e-6] if args.full else [1e-4]
    rows = []
    for loss in ("hinge", "logistic"):
        for lam in lambdas:
            prob = paper_like("real-sim", loss=loss, lam=lam,
                              device=args.device)
            r = compare(prob, device=args.device)
            rows.append((loss, lam, r))
            print(f"{loss:9s} lam={lam:g}  "
                  f"DSO={r['dso']:.5f} "
                  f"(gap {r['dso_gap']:.4f})  "
                  f"SGD={r['sgd']:.5f}  "
                  f"PSGD={r['psgd']:.5f}  "
                  f"BMRM={r['bmrm']:.5f}")
    return rows


if __name__ == "__main__":
    main()
