"""BMRM — Bundle Methods for Regularized risk Minimization (Teo et al. [19]).

Batch cutting-plane method for  min_w  lam * ||w||^2 + R_emp(w)  where
R_emp(w) = (1/m) sum_i l_i(<w, x_i>).  At iterate w_t, add the plane
(a_t, b_t) with a_t = grad R_emp(w_t), b_t = R_emp(w_t) - <a_t, w_t>; then

    w_{t+1} = argmin_w  lam ||w||^2 + max_k { <a_k, w> + b_k }

whose dual over the simplex (beta in Delta_K) is the small QP

    max_beta  -(1/(4 lam)) || A beta ||^2 + <b, beta>

solved here by exponentiated-gradient ascent (adequate at K <= ~100).
Recover w = -A beta / (2 lam).  (phi(w) = w^2, matching the paper's
square-norm regularizer convention.)

On the card the full-batch products ``X @ w`` and ``X.T @ g`` are cuBLAS
matrix-vector products and the ascent is eager torch (no kernel of the
port's own: the reference computes all of it outside any Pallas kernel).
The planes stay on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.baselines import problem_device
from repro_torch.core.saddle import Problem, primal_objective


def _risk_and_grad(prob: Problem, w):
    loss = prob.loss
    u = prob.X @ w
    risk = torch.mean(loss.value(u, prob.y))
    grad = (prob.X.T @ loss.grad(u, prob.y)) / prob.m
    return risk, grad


def _solve_bundle_dual(A, b, lam, n_iter=300, lr=0.5):
    """max_{beta in simplex} -||A beta||^2/(4 lam) + <b, beta> via EG ascent."""
    K = b.shape[0]
    beta = torch.full((K,), 1.0 / K, dtype=torch.float32, device=A.device)
    for _ in range(n_iter):
        g = -(A.T @ (A @ beta)) / (2.0 * lam) + b
        beta = beta * torch.exp(lr * g)
        beta = beta / beta.sum()
    return beta


def run_bmrm(prob: Problem, iters: int = 50, eval_every: int = 1,
             max_planes: int = 100, *, device="cuda"):
    """Returns (w, history). One iteration = one full batch pass (O(md))."""
    dev = problem_device(prob, device)
    lam = prob.lam
    w = torch.zeros(prob.d, dtype=torch.float32, device=dev)
    A = []  # cutting-plane gradients (columns)
    b = []
    history = []
    for t in range(1, iters + 1):
        risk, grad = _risk_and_grad(prob, w)
        A.append(grad)
        b.append(float(risk) - float(torch.dot(grad, w)))
        if len(A) > max_planes:
            A.pop(0), b.pop(0)
        Amat = torch.stack(A, dim=1)  # (d, K)
        bvec = torch.tensor(np.asarray(b, np.float32), device=dev)
        beta = _solve_bundle_dual(Amat, bvec, lam)
        w = -(Amat @ beta) / (2.0 * lam)
        if t % eval_every == 0 or t == iters:
            history.append(dict(epoch=t,
                                primal=float(primal_objective(prob, w))))
    return w, history
