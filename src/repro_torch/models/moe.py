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

``moe_weight_gather`` and ``moe_shard_capacity`` pin layouts on a mesh in
the reference; on one device they change nothing.

The router aux loss is the standard load-balance term
(mean_tokens_per_expert . mean_router_prob_per_expert) * E.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamInit, _dense_init, gelu


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


def moe_apply(p, x, cfg: ModelConfig, *, capacity_factor: float = 1.25):
    """x: (B, T, d). Returns (out (B, T, d), aux_loss scalar)."""
    B, T, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    N = B * T
    xt = x.reshape(N, d)

    probs = torch.softmax(xt.float() @ p["router"], dim=-1)   # (N, E)
    gate_vals, expert_idx = top_k(probs, k)                    # (N, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance auxiliary loss (Switch/DBRX style)
    me = probs.mean(dim=0)                                     # (E,)
    ce = F.one_hot(expert_idx, e).float().sum(dim=(0, 1)) / (N * k)
    aux = e * torch.sum(me * ce)

    # ---- dispatch with static capacity ----
    C = int(max(1, round(N * k * capacity_factor / e)))
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
    keep = rank < C
    slot = torch.where(keep, rank, 0)

    # scatter tokens into the (E, C, d) expert buffer (drop on overflow)
    buf = torch.zeros((e, C, d), dtype=x.dtype, device=x.device)
    buf.index_put_((sorted_e, slot),
                   torch.where(keep[:, None], xt[sorted_tok], 0.0).to(x.dtype),
                   accumulate=True)

    if cfg.mlp == "swiglu":
        h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    else:
        h = gelu(torch.bmm(buf, p["w_up"]))
    y = torch.bmm(h, p["w_down"])                              # (E, C, d)

    # gather back and combine with gates
    slot_out = torch.where(keep[:, None], y[sorted_e, slot], 0.0)
    out = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, sorted_tok, slot_out.float() * sorted_gate[:, None])
    return out.reshape(B, T, d).to(x.dtype), aux
