"""Synthetic datasets with planted ground truth.

The generators draw with numpy exactly as the reference's do, so the same
seed gives an identical ``X, y``; only the returned ``Problem`` lives on a
torch device (``device``, default the card).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.saddle import Problem, make_problem


def make_classification(m: int = 2000, d: int = 500, density: float = 0.05,
                        loss: str = "hinge", lam: float = 1e-4,
                        noise: float = 0.1, seed: int = 0,
                        reg: str = "l2", *, device="cuda") -> Problem:
    """Sparse linear-separable-ish binary classification."""
    rng = np.random.default_rng(seed)
    X = np.zeros((m, d), np.float32)
    nnz_per_row = max(1, int(density * d))
    for i in range(m):
        cols = rng.choice(d, size=nnz_per_row, replace=False)
        X[i, cols] = rng.normal(0, 1, size=nnz_per_row).astype(np.float32)
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    X /= np.maximum(norms, 1e-8)
    w_star = rng.normal(0, 1, size=d).astype(np.float32)
    margin = X @ w_star + noise * rng.normal(0, 1, size=m).astype(np.float32)
    y = np.where(margin >= 0, 1.0, -1.0).astype(np.float32)
    return make_problem(X, y, lam, loss=loss, reg=reg, device=device)


def powerlaw_columns(rng, m: int, d: int, nnz_per_row: int,
                     alpha: float) -> np.ndarray:
    """(m, nnz_per_row) column indices, ascending within each row, with
    column j drawn ~ (j+1)^-alpha (the reference's shared skew model)."""
    pop = np.arange(1, d + 1, dtype=np.float64) ** (-alpha)
    pop /= pop.sum()
    cols = np.empty((m, nnz_per_row), np.int64)
    for i in range(m):
        cols[i] = np.sort(rng.choice(d, size=nnz_per_row, replace=False,
                                     p=pop))
    return cols


def make_skewed_classification(m: int = 2000, d: int = 500,
                               density: float = 0.05, alpha: float = 1.1,
                               loss: str = "hinge", lam: float = 1e-4,
                               noise: float = 0.1, seed: int = 0,
                               reg: str = "l2", *, device="cuda") -> Problem:
    """Power-law column popularity (webspam/kdda-like), with the
    ``make_classification`` planted-truth labels."""
    rng = np.random.default_rng(seed)
    X = np.zeros((m, d), np.float32)
    nnz_per_row = max(1, int(density * d))
    cols = powerlaw_columns(rng, m, d, nnz_per_row, alpha)
    for i in range(m):
        X[i, cols[i]] = rng.normal(0, 1, size=nnz_per_row) \
            .astype(np.float32)
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    X /= np.maximum(norms, 1e-8)
    w_star = rng.normal(0, 1, size=d).astype(np.float32)
    margin = X @ w_star + noise * rng.normal(0, 1, size=m).astype(np.float32)
    y = np.where(margin >= 0, 1.0, -1.0).astype(np.float32)
    return make_problem(X, y, lam, loss=loss, reg=reg, device=device)


def make_dense_classification(m: int = 2000, d: int = 128,
                              loss: str = "hinge", lam: float = 1e-4,
                              noise: float = 0.1, seed: int = 0, *,
                              device="cuda") -> Problem:
    """Dense features (ocr/alpha-like)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1.0 / np.sqrt(d), size=(m, d)).astype(np.float32)
    w_star = rng.normal(0, 1, size=d).astype(np.float32)
    margin = X @ w_star + noise * rng.normal(0, 1, size=m).astype(np.float32)
    y = np.where(margin >= 0, 1.0, -1.0).astype(np.float32)
    return make_problem(X, y, lam, loss=loss, reg="l2", device=device)


def make_regression(m: int = 1000, d: int = 200, density: float = 0.1,
                    lam: float = 1e-3, seed: int = 0,
                    reg: str = "l1", *, device="cuda") -> Problem:
    """LASSO-style problem (square loss, L1 regularizer by default)."""
    rng = np.random.default_rng(seed)
    X = (rng.random((m, d)) < density).astype(np.float32)
    X *= rng.normal(0, 1, size=(m, d)).astype(np.float32)
    w_star = np.zeros(d, np.float32)
    support = rng.choice(d, size=max(1, d // 10), replace=False)
    w_star[support] = rng.normal(0, 2, size=len(support)).astype(np.float32)
    y = (X @ w_star + 0.05 * rng.normal(0, 1, size=m)).astype(np.float32)
    return make_problem(X, y, lam, loss="square", reg=reg, device=device)


# Named CPU-scale stand-ins for the paper's datasets (Table 2 shape ratios).
PAPER_LIKE = {
    "real-sim": (2000, 800, 0.0025),
    "news20": (800, 4000, 0.0005),
    "kdda": (4000, 8000, 0.0002),
    "ocr": (2000, 256, 1.0),
    "alpha": (1000, 128, 1.0),
    "worm": (1600, 64, 0.25),
}


def paper_like(name: str, loss: str = "hinge", lam: float = 1e-4,
               seed: int = 0, *, device="cuda") -> Problem:
    m, d, density = PAPER_LIKE[name]
    if density >= 1.0:
        return make_dense_classification(m, d, loss=loss, lam=lam, seed=seed,
                                         device=device)
    return make_classification(m, d, density, loss=loss, lam=lam, seed=seed,
                               device=device)
