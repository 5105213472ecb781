"""Block-cyclic schedule of Algorithm 1.

At inner iteration r (0-indexed), processor q owns the w-block
``sigma(q, r, p) = (q + r) mod p`` — the 0-indexed form of the paper's
``sigma_r(q) = ((q + r - 2) mod p) + 1``. After each inner iteration the
w-blocks move one step around the ring: processor q receives the block held
by processor (q + 1) mod p.
"""

from __future__ import annotations

import numpy as np


def sigma(q: int, r: int, p: int) -> int:
    """0-indexed owner schedule: block owned by processor q at inner iter r."""
    return (q + r) % p


def ring_perm(p: int) -> list[tuple[int, int]]:
    """Ring permutation advancing the schedule: q's block goes to q-1.

    After the permute, processor q holds the block that was at q+1, i.e.
    block (q + 1 + r) mod p = sigma(q, r+1, p).  Entries are (src, dst).
    """
    return [(q, (q - 1) % p) for q in range(p)]


def partition_even(n: int, p: int) -> list[slice]:
    """p contiguous near-equal slices of range(n) (|I_q| ~ n/p, Thm 1 ass. 1)."""
    bounds = np.linspace(0, n, p + 1).astype(int)
    return [slice(int(bounds[k]), int(bounds[k + 1])) for k in range(p)]


def pad_to_multiple(n: int, p: int) -> int:
    return ((n + p - 1) // p) * p
