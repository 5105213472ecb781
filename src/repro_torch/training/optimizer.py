"""AdamW with decoupled weight decay and global-norm clipping (the port of
``repro.training.optimizer``).

Parameters, gradients and the moments are nested dicts of tensors (the
parameter pytree of ``models.model``).  The arithmetic follows the
reference line for line: every update in float32 and written back in the
parameter's type, the bias corrections as float32 powers of the step,
weight decay on leaves of two or more dimensions only.  ``apply`` returns
new trees and changes none of its arguments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: object          # tree like the parameters, float32
    nu: object
    step: torch.Tensor  # int32, 0-d


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, with the matching leaves of
    ``rest`` (dicts of the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, keys in sorted order (the reference's
    flattening order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree like ``tree`` with its leaves, in ``tree_leaves`` order,
    replaced by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        return next(it)
    return build(tree)


def init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    step_dev = tree_leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=step_dev))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor), float32: linear warmup
    to ``lr``, then a cosine decay to ``min_lr_frac * lr``."""
    step = step.to(torch.float32)
    warm = torch.clamp_max((step + 1) / cfg.warmup_steps, 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree, sharded=None, tp=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree``.  Under tensor parallelism
    ``sharded`` (a tree of bools like ``tree``) marks the leaves that are
    this rank's slices: their squares are summed over ``tp``'s group with
    one all-reduce, and the whole leaves (the same on every rank) count
    once."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    if sharded is None:
        return torch.sqrt(sum(sq))
    flags = tree_leaves(sharded)
    part = torch.stack([s for s, f in zip(sq, flags) if f]).sum()
    rest = sum(s for s, f in zip(sq, flags) if not f)
    return torch.sqrt(tp.all_reduce_(part) + rest)


def apply(cfg: AdamWConfig, params, grads, state: OptState, *,
          gnorm=None):
    """Returns (new_params, new_state, metrics); ``gnorm`` is the
    gradients' ``global_norm`` when the caller has it (under tensor
    parallelism)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    step_f = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, step_f)
    b2c = 1 - torch.pow(cfg.b2, step_f)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu / b1c
        nhat = nu / b2c
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (not norms/biases)
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), OptState(pick(1), pick(2), step), {
        "grad_norm": gnorm, "lr": lr}
