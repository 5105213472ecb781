"""PSGD — Parallelized SGD of Zinkevich et al. [22].

Each of p workers runs independent SGD on its shard of the data for one
epoch; the parameter vectors are then averaged.  The paper parallelizes
its SGD baseline this way for the multi-machine experiments.

Shards are ``pad_to_multiple(m, p) / p`` rows, the last ones padded with
zero rows of label 0, as in the reference; the port does not copy X for
that: each worker gets its rows' global ids, -1 for a padding row.  On
the card an epoch of all p workers is ONE launch of the SGD kernel (p
thread-block clusters, ``ops.sgd_epoch``).  A padding row still takes its step (the
regularizer's gradient and the AdaGrad update move w).
"""

from __future__ import annotations

import torch

from repro_torch.baselines import problem_device
from repro_torch.core.saddle import Problem, primal_objective
from repro_torch.core.schedule import pad_to_multiple
from repro_torch.kernels import ops


def _draw_perms(key: torch.Generator, p: int, mb: int) -> torch.Tensor:
    """The next epoch's visit orders, (p, mb): one permutation of each
    worker's shard (host)."""
    return torch.stack([torch.randperm(mb, generator=key)
                        for _ in range(p)])


def shard_rows(perms, m: int, batch: int) -> torch.Tensor:
    """Each worker's row ids for one epoch, (p, nsteps * batch) int32 on
    ``perms``' device: worker q visits its shard's rows q * mb + perms[q]
    (mb = perms.shape[1]) in steps of ``batch``, the trailing mb % batch
    dropped; a padding row (id >= m) is -1."""
    p, mb = perms.shape
    rows = torch.arange(p, device=perms.device)[:, None] * mb \
        + perms[:, :mb // batch * batch]
    return torch.where(rows < m, rows, -1).to(torch.int32).contiguous()


def run_psgd(prob: Problem, p: int = 4, epochs: int = 10, eta0: float = 0.1,
             batch: int = 1, seed: int = 0, eval_every: int = 1, *,
             device="cuda"):
    """Returns (w, history)."""
    dev = problem_device(prob, device)
    mb = pad_to_multiple(prob.m, p) // p
    w = torch.zeros((p, prob.d), dtype=torch.float32, device=dev)
    acc = torch.zeros_like(w)
    key = torch.Generator().manual_seed(int(seed))
    history = []
    for t in range(1, epochs + 1):
        rows = shard_rows(_draw_perms(key, p, mb).to(dev), prob.m, batch)
        ops.sgd_epoch(prob.X, prob.y, rows, w, acc, eta0,
                      prob.lam, loss_name=prob.loss_name,
                      reg_name=prob.reg_name, batch=batch)
        # Zinkevich averaging step
        w_avg = w.mean(dim=0)
        w.copy_(w_avg.expand_as(w))
        if t % eval_every == 0 or t == epochs:
            history.append(dict(epoch=t,
                                primal=float(primal_objective(prob, w_avg))))
    return w[0], history
