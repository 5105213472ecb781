"""Schedule layer: per-inner-iteration block permutations.

A schedule reduces to a ``(n_epochs, p, p)`` int32 tensor ``perms`` with
``perms[e, r, q]`` = the block processor q owns at inner iteration r of
epoch e, each ``perms[e, r]`` a permutation of 0..p-1 (Lemma 2's only
requirement).  ``draw(key, t0, n, p)`` returns ``(key', perms)`` on the
host; the driver moves the chunk's permutations to the device once.

  cyclic  — Algorithm 1's sigma_r(q) = (q + r) mod p; ``ring=True``.
  random  — a uniformly random permutation per inner iteration.  The
            reference draws from a ``jax.random`` key, whose threefry
            stream torch cannot reproduce; the port draws from a
            ``torch.Generator`` (the ``key``), so its permutations differ
            from the reference's for the same seed.  Equivalence with the
            reference is shown by replaying its permutations through
            ``fixed_schedule``.
  lpt     — load-balanced greedy LPT Latin square over the per-tile nnz
            costs (``balanced=True``: the driver passes ``tile_nnz``).
  fixed   — any explicit ``perms`` array.

Resume contract (kept from the reference, schedules.py:71-131):
``draw`` is CHUNK-INVARIANT — drawing n1 epochs and then n2 more while
threading the returned key gives the same ``(n1 + n2, p, p)`` stream as
one draw of n1 + n2.  Cyclic and lpt are pure functions of (t0, p,
costs); random consumes exactly p permutations of its generator per
epoch, never per chunk.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class Schedule(NamedTuple):
    name: str
    #: (key, t0, n, p) -> (key', perms (n, p, p) int32 host tensor)
    draw: Callable
    ring: bool
    balanced: bool = False


def cyclic_perms(n: int, p: int) -> torch.Tensor:
    """(n, p, p) cyclic schedule: perms[e, r, q] = (q + r) mod p."""
    r = torch.arange(p, dtype=torch.int32)
    perm = (r[:, None] + r[None, :]) % p
    return perm.expand(n, p, p).contiguous()


def _draw_cyclic(key, t0, n, p):
    return key, cyclic_perms(n, p)


def _draw_random(key, t0, n, p):
    """``key`` is a ``torch.Generator`` (advanced in place and returned)."""
    perms = torch.empty((n, p, p), dtype=torch.int32)
    for e in range(n):
        for r in range(p):
            perms[e, r] = torch.randperm(p, generator=key)
    return key, perms


def fixed_schedule(perms, name: str = "fixed") -> Schedule:
    """Schedule replaying an explicit ``(n_epochs, p, p)`` (or single-epoch
    ``(p, p)``) permutation array — epoch t draws ``perms[t]``."""
    perms = np.asarray(perms, np.int32)
    if perms.ndim == 2:
        perms = perms[None]
    p = perms.shape[-1]
    if perms.ndim != 3 or perms.shape[1] != p or not np.array_equal(
            np.sort(perms, axis=-1), np.broadcast_to(np.arange(p),
                                                     perms.shape)):
        raise ValueError("a fixed schedule is (n_epochs, p, p) with every "
                         "row a permutation of 0..p-1 (Lemma 2)")
    perms = torch.tensor(perms)

    def draw(key, t0, n, p):
        if t0 + n > perms.shape[0]:
            raise ValueError(
                f"fixed schedule has {perms.shape[0]} epochs of "
                f"permutations, epochs {t0}..{t0 + n} requested")
        if tuple(perms.shape[1:]) != (p, p):
            raise ValueError(f"fixed schedule is for p={perms.shape[1]}, "
                             f"grid has p={p}")
        return key, perms[t0:t0 + n].contiguous()

    return Schedule(name, draw, ring=False)


def lpt_latin_square(tile_nnz) -> np.ndarray:
    """Greedy LPT Latin square over the (p, p) per-tile costs.

    Round by round, workers are served in descending order of their
    heaviest remaining tile and each takes its costliest block still free
    this round; conflicts are repaired with augmenting paths (Kuhn), which
    always succeed because the remaining worker-block graph is regular.
    Returns ``perms (p, p)`` with ``perms[r, q]`` = block of worker q at
    inner iteration r.
    """
    cost = np.asarray(tile_nnz, np.float64)
    p = cost.shape[0]
    if cost.shape != (p, p):
        raise ValueError(f"tile_nnz must be (p, p), got {cost.shape}")
    remaining = [set(range(p)) for _ in range(p)]
    perms = np.empty((p, p), np.int32)
    for r in range(p):
        assign: dict[int, int] = {}

        def try_assign(q, visited):
            for b in sorted(remaining[q], key=lambda b: (-cost[q, b], b)):
                if b in visited:
                    continue
                visited.add(b)
                if b not in assign or try_assign(assign[b], visited):
                    assign[b] = q
                    return True
            return False

        order = sorted(range(p),
                       key=lambda q: (-max(cost[q, b]
                                           for b in remaining[q]), q))
        for q in order:
            if not try_assign(q, set()):
                raise AssertionError("regular bipartite graph must match")
        for b, q in assign.items():
            perms[r, q] = b
            remaining[q].remove(b)
    return perms


def _draw_lpt(key, t0, n, p, *, tile_nnz=None):
    if tile_nnz is None:
        raise ValueError(
            "schedule 'lpt' needs the per-tile nnz costs: pass "
            "tile_nnz=data.tile_row_nnz_g.sum(-1) to draw()")
    sq = torch.as_tensor(lpt_latin_square(tile_nnz))
    return key, sq[None].expand(n, p, p).contiguous()


SCHEDULES = {
    "cyclic": Schedule("cyclic", _draw_cyclic, ring=True),
    "random": Schedule("random", _draw_random, ring=False),
    "lpt": Schedule("lpt", _draw_lpt, ring=False, balanced=True),
}


def get_schedule(schedule) -> Schedule:
    """Name or ``Schedule`` instance -> ``Schedule`` (ValueError on
    unknown)."""
    if isinstance(schedule, Schedule):
        return schedule
    try:
        return SCHEDULES[schedule]
    except KeyError:
        raise ValueError(
            f"unknown schedule {schedule!r}: registered schedules are "
            f"{sorted(SCHEDULES)} (or pass a Schedule, e.g. "
            f"fixed_schedule(perms))") from None
