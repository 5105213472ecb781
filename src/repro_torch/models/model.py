"""Model assembly for all six architecture families (the port of
``repro.models.model``).

Parameters are the reference's pytree as nested dicts of tensors, with the
same keys; homogeneous layer stacks stay **stacked tensors** (leading axis
= layer), as the reference's ``vmap``-initialised stacks are, and the
forward walks them with a Python loop over views ``a[i]`` (no copy).  The
hybrid's shared block and the vlm's cross layers keep the reference's
places (``shared_attn``, ``cross_layers``), so ``models.convert`` maps the
reference's parameters leaf for leaf.

Forward modes:
  * ``forward``      — training / prefill: full sequence, returns logits+aux.
  * ``decode_step``  — one token against a KV/SSM cache (serve path); the
                       caches are updated in place and the state returned.

Every self-attention prefill is one ``kernels.ops.swa_attention`` call and
every Mamba2 scan one ``kernels.ops.ssd_scan`` call (``models.attention``,
``models.mamba2``).  ``remat=True`` runs each block (attention, Mamba2,
cross, the hybrid's shared block) under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, the
counterpart of the reference's ``jax.checkpoint`` per layer: the backward
recomputes the block's forward, kernels included, and keeps only its
input.  ``cfg.remat_policy`` has no counterpart (every block is
recomputed whole), and ``unroll`` and ``q_chunk`` change nothing: there is
no scan to unroll, and one kernel call covers every T.

``forward(..., tp=)`` runs under tensor parallelism over a mesh's
``model`` axis (``dist.tensor_parallel``): the parameters are the rank's
shards, the blocks take ``tp`` (the MoE layer's experts split or their
d_ff columns, ``models.moe``; the vlm's cross-attention on the rank's
heads), the embedding's columns are gathered and the logits are the
rank's slice of the vocabulary.  ``dp=`` is the data group of the
sharded train step: the MoE routing's statistics are the whole batch's
over it.  ``decode_step(..., tp=, dp=)`` is the sharded serve step's
(``serving.engine.make_sharded_serve_step``): every rank of a ``model``
group holds the whole caches of its rows, and the logits are gathered.

Inputs (per arch family):
  dense/moe/ssm/hybrid: batch["tokens"]       (B, T) int
  vlm:   batch["tokens"] + batch["image_embeds"]  (B, n_img, d)
  audio: batch["embeds"] (B, T, d) — stub codec frontend
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.tensor_parallel import SINGLE
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamInit, embed, embedding_init,
                                       mlp_apply, mlp_init, rmsnorm,
                                       rmsnorm_init, sinusoidal_pos,
                                       torch_dtype, unembed, unembed_init)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views ``a[i]`` of every leaf."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ================================================================= params --


def _attn_block_init(init: ParamInit, cfg: ModelConfig, dtype, cross=False):
    p = {
        "ln1": rmsnorm_init(init, cfg.d_model),
        "attn": attn.attn_init(init, cfg, dtype, cross=cross),
        "ln2": rmsnorm_init(init, cfg.d_model),
    }
    if cfg.is_moe and not cross:
        p["moe"] = moe.moe_init(init, cfg, dtype)
    else:
        p["mlp"] = mlp_init(init, cfg.d_model, cfg.d_ff, cfg.mlp, dtype)
    return p


def _mamba_block_init(init: ParamInit, cfg: ModelConfig, dtype):
    return {"ln": rmsnorm_init(init, cfg.d_model),
            "mamba": mamba2.mamba2_init(init, cfg, dtype)}


def _build_params(init: ParamInit, cfg: ModelConfig):
    dtype = _dtype(cfg)
    params: dict[str, Any] = {}
    if not cfg.inputs_embeds:
        params["embed"] = embedding_init(init, cfg.padded_vocab,
                                         cfg.d_model, dtype)
    if cfg.arch_type in ("dense", "moe", "audio"):
        params["layers"] = _attn_block_init(init.stacked(cfg.n_layers), cfg,
                                            dtype)
    elif cfg.arch_type == "ssm":
        params["layers"] = _mamba_block_init(init.stacked(cfg.n_layers), cfg,
                                             dtype)
    elif cfg.arch_type == "hybrid":
        params["layers"] = _mamba_block_init(init.stacked(cfg.n_layers), cfg,
                                             dtype)
        params["shared_attn"] = _attn_block_init(init, cfg, dtype)
    elif cfg.arch_type == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        params["layers"] = _attn_block_init(
            init.stacked(cfg.n_layers - n_cross), cfg, dtype)
        params["cross_layers"] = _attn_block_init(init.stacked(n_cross), cfg,
                                                  dtype, cross=True)
    else:
        raise ValueError(cfg.arch_type)
    params["final_norm"] = rmsnorm_init(init, cfg.d_model)
    params["unembed"] = unembed_init(init, cfg.d_model, cfg.padded_vocab,
                                     dtype)
    return params


def init_params(key, cfg: ModelConfig, *, device="cuda"):
    """Random parameters on ``device`` (default the card) from ``key``, a
    seed or a ``torch.Generator`` on that device, at the reference's
    scales."""
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(key))
    with torch.no_grad():
        return _build_params(ParamInit(gen, dev), cfg)


def param_specs(cfg: ModelConfig):
    """The parameters' shapes and types on the ``meta`` device: nothing is
    drawn or allocated (dbrx-132b's 132 B parameters included)."""
    return _build_params(ParamInit(None, torch.device("meta")), cfg)


# ================================================================ forward --


def _attn_block_apply(p, x, cfg: ModelConfig, *, window, q_chunk=2048,
                      tp=SINGLE, dp=SINGLE):
    h = x + attn.self_attention(p["attn"], rmsnorm(p["ln1"], x), cfg,
                                window=window, q_chunk=q_chunk, tp=tp)
    z = rmsnorm(p["ln2"], h)
    if cfg.is_moe and "moe" in p:
        y, aux = moe.moe_apply(p["moe"], z, cfg, tp=tp, dp=dp)
    else:
        y, aux = mlp_apply(p["mlp"], z, cfg.mlp, tp), 0.0
    return h + y, aux


def _cross_block_apply(p, x, kv, cfg: ModelConfig, tp=SINGLE):
    h = x + attn.cross_attention(p["attn"], rmsnorm(p["ln1"], x), kv, cfg,
                                 tp)
    return h + mlp_apply(p["mlp"], rmsnorm(p["ln2"], h), cfg.mlp, tp)


def _mamba_block_apply(p, x, cfg: ModelConfig, tp=SINGLE):
    return x + mamba2.mamba2_apply(p["mamba"], rmsnorm(p["ln"], x), cfg,
                                   chunk=cfg.ssm_chunk, tp=tp)


def _window_for(cfg: ModelConfig, T: int):
    return cfg.sliding_window if (cfg.has_attention
                                  and T > cfg.full_attn_max) else None


def _hybrid_groups(cfg: ModelConfig):
    """[(mamba layer ids, shared block after them?)]: groups of
    ``shared_attn_every`` layers each followed by the shared block, then
    the remainder's layers alone (``model.py:325-361``)."""
    k = cfg.shared_attn_every
    n_groups, rem = divmod(cfg.n_layers, k)
    out = [(range(g * k, (g + 1) * k), True) for g in range(n_groups)]
    if rem:
        out.append((range(n_groups * k, cfg.n_layers), False))
    return out


def _run(block, remat: bool):
    """``block()``, under activation checkpointing when ``remat`` and grad
    mode is on (without grad mode there is nothing to keep)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, use_reentrant=False)
    return block()


def forward(params, batch, cfg: ModelConfig, *, remat: bool = True,
            q_chunk: int = 2048, last_only: bool = False,
            unroll: bool = False, tp=SINGLE, dp=SINGLE):
    """Returns (logits, aux dict), logits in ``cfg.logits_dtype``.
    ``last_only`` emits logits for the final position only — the prefill
    contract (next-token after the prompt) that avoids materializing
    (B, T, vocab).  Under ``tp`` (a ``TensorParallel`` of more than one
    rank) the logits are the rank's slice of the padded vocabulary;
    ``dp`` is the data group the batch's rows are split over."""
    if cfg.inputs_embeds:
        x = batch["embeds"]
    else:
        x = tp.whole(embed(params["embed"], batch["tokens"]), cfg.d_model)
    T = x.shape[1]
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_pos(torch.arange(T, device=x.device),
                               cfg.d_model).to(x.dtype)
    window = _window_for(cfg, T)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = params["layers"]

    def attn_block(p, x):
        return _run(lambda: _attn_block_apply(p, x, cfg, window=window,
                                              q_chunk=q_chunk, tp=tp, dp=dp),
                    remat)

    def mamba_block(p, x):
        return _run(lambda: _mamba_block_apply(p, x, cfg, tp), remat)

    def cross_block(p, x):
        return _run(lambda: _cross_block_apply(p, x, batch["image_embeds"],
                                               cfg, tp), remat)

    if cfg.arch_type in ("dense", "moe", "audio"):
        for i in range(cfg.n_layers):
            x, aux = attn_block(layer(layers, i), x)
            if cfg.is_moe:
                aux_total = aux_total + aux
    elif cfg.arch_type == "ssm":
        for i in range(cfg.n_layers):
            x = mamba_block(layer(layers, i), x)
    elif cfg.arch_type == "hybrid":
        for ids, shared in _hybrid_groups(cfg):
            for i in ids:
                x = mamba_block(layer(layers, i), x)
            if shared:
                x, _ = attn_block(params["shared_attn"], x)
    elif cfg.arch_type == "vlm":
        ce = cfg.cross_attn_every
        for g in range(cfg.n_layers // ce):
            for j in range(ce - 1):
                x, _ = attn_block(layer(layers, g * (ce - 1) + j), x)
            x = cross_block(layer(params["cross_layers"], g), x)
    else:
        raise ValueError(cfg.arch_type)

    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x)
    logits = unembed(params["unembed"], x, dtype=cfg.logits_dtype)
    return logits, {"aux_loss": aux_total}


# ================================================================= decode --


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int, *,
                      device="cuda"):
    """Zeroed caches on ``device`` (default the card), stacked per layer as
    the reference's are (a rank of the sharded serve step: its rows)."""
    return _decode_state(cfg, batch, seq_len, resolve_device(device))


def decode_state_specs(cfg: ModelConfig, batch: int, seq_len: int):
    """The decode caches' shapes and types on the ``meta`` device."""
    return _decode_state(cfg, batch, seq_len, torch.device("meta"))


def _decode_state(cfg: ModelConfig, batch: int, seq_len: int, dev):
    dtype = _dtype(cfg)
    kv = lambda n: attn.init_cache(cfg, batch, seq_len, dtype,  # noqa: E731
                                   device=dev, stack=(n,))
    if cfg.arch_type in ("dense", "moe", "audio"):
        return {"layers": kv(cfg.n_layers)}
    if cfg.arch_type == "ssm":
        return {"layers": mamba2.init_ssm_cache(cfg, batch, dtype, device=dev,
                                                stack=(cfg.n_layers,))}
    if cfg.arch_type == "hybrid":
        return {"layers": mamba2.init_ssm_cache(cfg, batch, dtype, device=dev,
                                                stack=(cfg.n_layers,)),
                "shared": kv(cfg.n_layers // cfg.shared_attn_every)}
    if cfg.arch_type == "vlm":
        return {"layers": kv(cfg.n_layers
                             - cfg.n_layers // cfg.cross_attn_every)}
    raise ValueError(cfg.arch_type)


def decode_step(params, state, inp, pos, cfg: ModelConfig, *, seq_len: int,
                image_embeds=None, unroll: bool = False, tp=SINGLE,
                dp=SINGLE):
    """One decode step. inp: tokens (B, 1) or embeds (B, 1, d); pos: the
    position (an int or a 0-d tensor).

    Updates the caches of ``state`` in place and returns (logits float32
    (B, 1, vocab), state).  Under ``tp`` the parameters are the rank's
    shards and the caches whole on every rank of the group (each block
    takes ``tp`` as in ``forward``); the logits are the whole padded
    vocabulary, gathered.  ``dp`` is the data group the batch's rows are
    split over: the MoE routing's statistics are the whole batch's."""
    pos = int(pos)
    x = inp if cfg.inputs_embeds else tp.whole(embed(params["embed"], inp),
                                               cfg.d_model)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_pos(torch.full((1,), pos, device=x.device),
                               cfg.d_model).to(x.dtype)

    def attn_step(x, layer_p, cache):
        h, _ = attn.decode_self_attention(
            layer_p["attn"], rmsnorm(layer_p["ln1"], x), cache, pos, cfg,
            seq_len=seq_len, tp=tp)
        h = x + h
        z = rmsnorm(layer_p["ln2"], h)
        if cfg.is_moe and "moe" in layer_p:
            y, _ = moe.moe_apply(layer_p["moe"], z, cfg, tp=tp, dp=dp)
        else:
            y = mlp_apply(layer_p["mlp"], z, cfg.mlp, tp)
        return h + y

    def mamba_step(x, layer_p, cache):
        h, _ = mamba2.mamba2_decode(layer_p["mamba"],
                                    rmsnorm(layer_p["ln"], x), cache, cfg,
                                    tp)
        return x + h

    layers, caches = params["layers"], state["layers"]
    if cfg.arch_type in ("dense", "moe", "audio"):
        for i in range(cfg.n_layers):
            x = attn_step(x, layer(layers, i), layer(caches, i))
    elif cfg.arch_type == "ssm":
        for i in range(cfg.n_layers):
            x = mamba_step(x, layer(layers, i), layer(caches, i))
    elif cfg.arch_type == "hybrid":
        for g, (ids, shared) in enumerate(_hybrid_groups(cfg)):
            for i in ids:
                x = mamba_step(x, layer(layers, i), layer(caches, i))
            if shared:
                x = attn_step(x, params["shared_attn"],
                              layer(state["shared"], g))
    elif cfg.arch_type == "vlm":
        ce = cfg.cross_attn_every
        for g in range(cfg.n_layers // ce):
            for j in range(ce - 1):
                i = g * (ce - 1) + j
                x = attn_step(x, layer(layers, i), layer(caches, i))
            x = _cross_block_apply(layer(params["cross_layers"], g), x,
                                   image_embeds, cfg, tp)
    else:
        raise ValueError(cfg.arch_type)

    x = rmsnorm(params["final_norm"], x)
    return tp.whole(unembed(params["unembed"], x), cfg.padded_vocab), state
