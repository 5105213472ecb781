"""Randomized-schedule DSO — the paper's §6 'natural next step' (NOMAD-style).

The paper's convergence proof only needs an *equivalent serial sequence of
updates* (Lemma 2), which holds for ANY schedule that assigns, at each inner
iteration, a permutation of blocks to processors (no shared row/column).
Algorithm 1 uses the cyclic shift sigma_r(q) = (q+r) mod p; asynchronous
NOMAD-style execution visits blocks in a data-dependent order. We model that
with a *uniformly random permutation per inner iteration* — the schedule
distribution NOMAD approaches under homogeneous processors.

A thin wrapper: the random schedule lives in ``engine.schedules``
("random", drawn from a ``torch.Generator`` seeded with ``seed``, so its
permutations differ from the reference's ``jax.random`` ones), driven by
the same epoch loop as every other mode (``engine.solve(schedule=
"random")``), and composes with every registered tile backend.
"""

from __future__ import annotations

from repro_torch.core.saddle import Problem
from repro_torch.engine.driver import solve
from repro_torch.engine.evaluate import problem_eval_hook


def run_dso_random(prob: Problem, p: int = 4, epochs: int = 10,
                   eta0: float = 0.1, use_adagrad: bool = True,
                   row_batches: int = 1, alpha0: float = 0.0, seed: int = 0,
                   eval_every: int = 1, impl: str = "jnp", *,
                   device="cuda"):
    """DSO with uniformly random block permutations per inner iteration.

    The per-epoch schedules are drawn by the engine's "random" schedule;
    ``impl`` selects any registered tile backend (dense by default).
    """
    res = solve(prob, backend=impl, schedule="random", p=p, epochs=epochs,
                eta0=eta0, use_adagrad=use_adagrad, row_batches=row_batches,
                alpha0=alpha0, eval_every=eval_every, seed=seed,
                eval_hook=problem_eval_hook(prob, saddle=False),
                device=device)
    return res.w, res.alpha, res.history
