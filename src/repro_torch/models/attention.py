"""Attention: GQA/MQA/MHA with RoPE, causal / sliding-window / cross
variants (the port of ``repro.models.attention``).

Prefill (``self_attention``) is one call of the sliding-window kernel,
``kernels.ops.swa_attention``, in place of the reference's three jnp paths
(direct, triangle, windowed; ``attention.py:112-163``), which compute the
same masked softmax.  q, k and v go to the kernel's (B, H, T, Dh) layout
as contiguous tensors after RoPE; grouped-query attention needs no repeat,
since the kernel maps query head h to kv head ``h // (Hq // Hkv)``, the
reference's (G, R) grouping.  On CPU tensors the wrapper runs its plain
version; on CUDA tensors it launches the kernel or raises.

Cross-attention and one-token decode (full cache or a ring buffer of
``window`` slots) stay plain PyTorch: the reference computes them in jnp
outside any Pallas kernel.  Cross-attention takes ``tp`` as
self-attention does, and so does decode, on a cache that every rank of
the group holds whole.  The decode caches are updated in place.

Under tensor parallelism (``tp``, ``dist.tensor_parallel``) wq, wk and wv
hold the rank's columns and wo its columns of d.  When the rank's columns
fall on whole heads (Hq and Hkv both multiples of the group's size) the
kernel runs on the rank's heads, made contiguous, and the heads are
gathered for wo; otherwise q, k and v are gathered and every rank attends
on every head (the reference's ``_constrain`` keeps few KV heads whole
too).  The output's columns are gathered.

Layout: activations (B, T, d); q heads grouped as (G kv groups, R
repeats) in the plain paths.
"""

from __future__ import annotations

import torch

from repro_torch.dist.tensor_parallel import SINGLE
from repro_torch.kernels.ops import swa_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamInit, _dense_init, apply_rope

_NEG_INF = -1e30


def attn_init(init: ParamInit, cfg: ModelConfig, dtype, cross: bool = False):
    d, hq, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    g = cfg.n_kv_heads or hq
    p = {
        "wq": _dense_init(init, (d, hq * dh), dtype=dtype),
        "wk": _dense_init(init, (d, g * dh), dtype=dtype),
        "wv": _dense_init(init, (d, g * dh), dtype=dtype),
        "wo": _dense_init(init, (hq * dh, d), dtype=dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = init.full((hq * dh,), 0.0, dtype)
        p["bk"] = init.full((g * dh,), 0.0, dtype)
        p["bv"] = init.full((g * dh,), 0.0, dtype)
    return p


def _project(x, w, b, heads: int, dh: int, tp, split: bool):
    """x @ w (+ b) as (B, T, heads, Dh): every head, gathered under ``tp``
    if w is the rank's columns, or with ``split`` the rank's heads."""
    full = heads * dh
    if split:
        y = x @ tp.part(w, full)
        b = tp.part(b, full)
    else:
        y = tp.whole(x @ w, full)
    if b is not None:
        y = y + b
    return y.reshape(*x.shape[:2], -1, dh)


def _project_q(p, x, cfg: ModelConfig, tp=SINGLE, split=False):
    return _project(x, p["wq"], p.get("bq"), cfg.n_heads, cfg.head_dim,
                    tp, split)


def _project_kv(p, x, cfg: ModelConfig, tp=SINGLE, split=False):
    g = cfg.n_kv_heads or cfg.n_heads
    return (_project(x, p["wk"], p.get("bk"), g, cfg.head_dim, tp, split),
            _project(x, p["wv"], p.get("bv"), g, cfg.head_dim, tp, split))


def _constrain(t, cfg: ModelConfig):
    """The reference pins attention activations to a mesh layout
    (``attn_shard``, ``attention.py:73-87``).  The port decides the layout
    from the shapes (``self_attention``: the rank's heads when they divide,
    else every head), which is what the knob's settings select, so every
    setting leaves ``t`` as it is."""
    return t


def _attend(q, k, v, mask):
    """Plain float32 attention.  q: (B,Tq,G,R,Dh), k/v: (B,Tk,G,Dh), mask:
    (Tq,Tk) or None; returns (B,Tq,G,R,Dh) float32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())


def _grouped(q, g):
    B, T, H, Dh = q.shape
    return q.reshape(B, T, g, H // g, Dh)


def _finish(p, o, cfg: ModelConfig, dtype, tp=SINGLE):
    """o: (B, T, ..., Dh) heads -> (B, T, d) through ``wo``.  Under ``tp``
    the rank's heads are gathered first, and the output's columns."""
    B, T = o.shape[:2]
    o = tp.whole(o.reshape(B, T, -1).to(dtype), cfg.n_heads * cfg.head_dim)
    return tp.whole(o @ p["wo"], cfg.d_model)


def self_attention(p, x, cfg: ModelConfig, *, positions=None,
                   window: int | None = None, q_chunk: int = 2048,
                   tp=SINGLE):
    """Causal self-attention over x (B, T, d): training / prefill.

    ``window`` None is full causal attention (the kernel's window is then
    T).  ``q_chunk`` selects among the reference's jnp paths and has no
    effect here: one kernel call covers every T.  ``tp``: see the module
    docstring."""
    B, T, _ = x.shape
    pos = positions if positions is not None else torch.arange(
        T, device=x.device)
    split = tp.splits(cfg.n_heads, cfg.n_kv_heads or cfg.n_heads)
    q = _project_q(p, x, cfg, tp, split)
    k, v = _project_kv(p, x, cfg, tp, split)
    if cfg.pos == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    q, k, v = (_constrain(t, cfg).transpose(1, 2).contiguous()
               for t in (q, k, v))
    o = swa_attention(q, k, v, window=T if window is None else window,
                      causal=True)
    return _finish(p, o.transpose(1, 2), cfg, x.dtype, tp)


def cross_attention(p, x, kv_embeds, cfg: ModelConfig, tp=SINGLE):
    """x (B,T,d) attends to kv_embeds (B,S,d): no mask, no rope on kv.
    Under ``tp`` as ``self_attention``: the rank's query and KV heads when
    they divide (the image tokens' K and V from the rank's columns of wk,
    wv), else every head from gathered projections; the plain
    ``_attend`` either way."""
    g = cfg.n_kv_heads or cfg.n_heads
    split = tp.splits(cfg.n_heads, g)
    q = _project_q(p, x, cfg, tp, split)
    k, v = _project_kv(p, kv_embeds, cfg, tp, split)
    o = _attend(_grouped(q, k.shape[2]), k, v, None)
    return _finish(p, o, cfg, x.dtype, tp)


# ------------------------------------------------------------------ decode --


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, *,
               device, stack: tuple = ()):
    """KV cache for one layer (with ``stack`` leading axes for a stack of
    layers).  Ring-buffered if seq_len exceeds the full-attention budget
    (long-context)."""
    g = cfg.n_kv_heads or cfg.n_heads
    S = seq_len if seq_len <= cfg.full_attn_max else cfg.sliding_window
    shape = tuple(stack) + (batch, S, g, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(p, x, cache, pos: int, cfg: ModelConfig, *,
                          seq_len: int, tp=SINGLE):
    """One-token decode. x: (B, 1, d); pos: the current position.

    Writes the new key and value into ``cache`` in place and returns
    (out (B,1,d), cache).  The cache is a ring buffer when seq_len >
    cfg.full_attn_max (slot = pos % window).  Under ``tp`` every rank
    holds the whole cache of its rows: the new key and value come from
    gathered projections, so every rank writes the same row; the query
    is the rank's heads when they divide (attending on its KV heads of
    the cache), else gathered, and ``_finish`` gathers as in the
    prefill."""
    g = cfg.n_kv_heads or cfg.n_heads
    S = cache["k"].shape[1]
    windowed = seq_len > cfg.full_attn_max
    split = tp.splits(cfg.n_heads, g)
    q = _project_q(p, x, cfg, tp, split)
    k, v = _project_kv(p, x, cfg, tp)
    if cfg.pos == "rope":
        pvec = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        q = apply_rope(q, pvec, cfg.rope_theta)
        k = apply_rope(k, pvec, cfg.rope_theta)
    slot = pos % S if windowed else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    slots = torch.arange(S, device=x.device)
    if windowed:
        # position currently held by slot s: pos - ((pos - s) mod S)
        valid = pos - torch.remainder(pos - slots, S) >= 0
    else:
        valid = slots <= pos
    ck, cv = cache["k"], cache["v"]
    if split:                        # the rank's KV heads of the cache
        ck, cv = tp.part(ck, g, 2), tp.part(cv, g, 2)
    o = _attend(_grouped(q, ck.shape[2]), ck, cv, valid[None, :])
    return _finish(p, o, cfg, x.dtype, tp), cache
