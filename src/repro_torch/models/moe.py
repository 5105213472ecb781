"""Mixture-of-Experts with top-k token-choice routing, dbrx / phi3.5 style
(the port of ``repro.models.moe``), in plain PyTorch.

Dispatch with a static per-expert capacity C = round(N k 1.25 / E): slots
are ranked within their expert, scattered into an (E, C, d) buffer, and
slots past capacity are dropped (their gate weight is zeroed, so the
residual stream passes them through unchanged).  Both of the reference's
rank rules are kept: ``moe_dispatch="sort"`` (a stable sort by expert) and
``"cumsum"`` (a running count of a one-hot matrix); a stable sort keeps
the slot order within an expert, so both drop the same slots.

Top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
does: the k largest router probabilities are taken by a stable descending
sort, since ``torch.topk`` promises no order among equal values.

The router aux loss is the standard load-balance term
(mean_tokens_per_expert . mean_router_prob_per_expert) * E.

**Over the data group** (``dp``, ``dist.tensor_parallel``: the data
ranks of the sharded train step, each with its rows of the batch) every
statistic is the whole batch's, as the reference's GSPMD step computes
it: the capacity from the whole batch's N, each slot's rank within its
expert in the whole batch's order (the slots of lower data ranks' rows
first: an exclusive prefix over the group of the per-expert slot
counts), and the aux loss's ``me`` and ``ce`` summed over the group.

**Over the model group** (``tp``) the layout is the fitted specs'
(``dist.sharding``).  The router's logits are made whole on every rank:
its expert columns gathered, or (when E does not divide 16) its rows of
d summed.  The routing then runs alike on every rank.  With E a multiple
of 16 each rank holds E/n whole experts (expert parallelism): it fills
only its experts' (E/n, C, d) buffer, runs them and adds its slots'
gated outputs into an (N, d) float32 partial; the output is the sum over
the group (``reduce``: every rank already holds every token, so no
all-to-all is needed).  Otherwise the experts' d_ff columns are split,
and each expert runs as the dense MLP does under ``tp`` (its h and its
output gathered).  The aux loss, computed alike from the whole routing,
passes 1/n of its gradient on (``share``), so that the router's
gradient counts it once.  ``moe_weight_gather`` and
``moe_shard_capacity`` pin layouts of the reference's GSPMD step; the
layout here is the one above, so both change nothing.

``recording()`` collects each call's routing (the whole batch's slots
per expert and the slots dropped at capacity) for a check that the
ranks route alike.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.dist.tensor_parallel import SINGLE
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamInit, _dense_init, mlp_apply

_routes: list | None = None      # ``recording()``'s list, or None


def moe_init(init: ParamInit, cfg: ModelConfig, dtype):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": _dense_init(init, (d, e), dtype=torch.float32)}
    if cfg.mlp == "swiglu":
        p["w_gate"] = _dense_init(init, (e, d, f), dtype=dtype)
    p["w_up"] = _dense_init(init, (e, d, f), dtype=dtype)
    p["w_down"] = _dense_init(init, (e, f, d), dtype=dtype)
    return p


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of each row, in
    descending order, ties toward the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@contextlib.contextmanager
def recording():
    """Within the block, each ``moe_apply`` call appends (the whole
    batch's slots per expert, (E,) int64 on the host; the slots dropped
    at capacity) to the list it yields.  A backward's recomputation
    (``remat``) appends again, after the forward's."""
    global _routes
    outer, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = outer


def _router_logits(w, xt, e: int, tp):
    """(N, E) float32 logits of ``xt`` (N, d), whole on every rank of
    ``tp``: the rank's expert columns of ``w`` gathered, or its rows of d
    summed over the group."""
    d = xt.shape[1]
    if w.shape[0] != d:
        return tp.reduce(tp.part(xt.float(), d) @ w)
    return tp.whole(xt.float() @ w, e)


def moe_apply(p, x, cfg: ModelConfig, *, capacity_factor: float = 1.25,
              tp=SINGLE, dp=SINGLE):
    """x: (B, T, d), whole on every rank of ``tp``; this rank's rows of
    the batch under ``dp``.  Returns (out (B, T, d), aux_loss scalar)."""
    B, T, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    N = B * T
    n_all = N * dp.n                       # the whole batch's tokens
    xt = x.reshape(N, d)

    probs = torch.softmax(_router_logits(p["router"], xt, e, tp), dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                    # (N, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # slots per expert: the data ranks' before this one, the whole batch's
    before, counts = dp.exclusive_sum(
        F.one_hot(expert_idx, e).sum(dim=(0, 1)))
    # load-balance auxiliary loss (Switch/DBRX style)
    me = dp.reduce(probs.sum(dim=0)) / n_all                   # (E,)
    ce = counts.float() / (n_all * k)
    aux = tp.share(e * torch.sum(me * ce))

    # ---- dispatch with static capacity ----
    C = int(max(1, round(n_all * k * capacity_factor / e)))
    if _routes is not None:
        _routes.append((counts.cpu(), int((counts - C).clamp_min(0).sum())))
    flat_expert = expert_idx.reshape(N * k)
    flat_gate = gate_vals.reshape(N * k)
    flat_tok = torch.arange(N, device=x.device).repeat_interleave(k)
    if cfg.moe_dispatch == "cumsum":
        # rank of slot i within its expert = #earlier slots of same expert
        onehot = F.one_hot(flat_expert, e)                     # (Nk, E)
        rank = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                            flat_expert[:, None])[:, 0]
        sorted_e, sorted_tok, sorted_gate = flat_expert, flat_tok, flat_gate
    else:
        order = torch.sort(flat_expert, stable=True).indices
        sorted_e = flat_expert[order]
        sorted_tok = flat_tok[order]
        sorted_gate = flat_gate[order]
        starts = torch.searchsorted(sorted_e, torch.arange(e,
                                                           device=x.device))
        rank = torch.arange(N * k, device=x.device) - starts[sorted_e]
    rank = rank + before[sorted_e]
    # the slots kept at capacity on this rank's experts (all of them, or
    # under expert parallelism its E/n from lo)
    el = p["w_up"].shape[0]
    lo = tp.coord * el if el != e else 0
    own = (rank < C) & (sorted_e >= lo) & (sorted_e < lo + el)
    e_own = torch.where(own, sorted_e - lo, 0)
    slot = torch.where(own, rank, 0)

    # scatter tokens into the (E, C, d) expert buffer (drop on overflow)
    buf = torch.zeros((el, C, d), dtype=x.dtype, device=x.device)
    buf.index_put_((e_own, slot),
                   torch.where(own[:, None], xt[sorted_tok], 0.0).to(x.dtype),
                   accumulate=True)
    experts = {w: t for w, t in p.items() if w != "router"}
    y = mlp_apply(experts, buf, cfg.mlp, tp if el == e else SINGLE)

    # gather back and combine with gates
    slot_out = torch.where(own[:, None], y[e_own, slot], 0.0)
    out = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, sorted_tok, slot_out.float() * sorted_gate[:, None])
    if el != e:
        out = tp.reduce(out)
    return out.reshape(B, T, d).to(x.dtype), aux
