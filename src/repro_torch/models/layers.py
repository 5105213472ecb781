"""Shared neural building blocks on tensors (the port of
``repro.models.layers``): parameters are nested dicts of tensors, the same
keys as the reference's pytrees, and every block is a plain function.

Weights are drawn by a ``ParamInit`` from an explicit ``torch.Generator``
at the reference's scales (``1/sqrt(fan_in)`` with ``fan_in`` the first
axis of the per-layer shape, 0.02 for the embedding, 0.5 for the
convolutions).  The streams differ from ``jax.random``'s; weights that must
equal the reference's come through ``models.convert.params_from_reference``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.tensor_parallel import SINGLE


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a config's dtype name or a dtype."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


class ParamInit:
    """Draws parameters on ``device`` from ``gen``, each with the leading
    ``stack`` axes (the reference's ``vmap`` over a stack of layers).  On
    the ``meta`` device nothing is drawn or allocated."""

    def __init__(self, gen: torch.Generator | None, device: torch.device,
                 stack: tuple = ()):
        self.gen, self.device, self.stack = gen, torch.device(device), stack

    def stacked(self, n: int) -> "ParamInit":
        return ParamInit(self.gen, self.device, self.stack + (n,))

    def _empty(self, shape, dtype):
        return torch.empty(self.stack + tuple(shape), dtype=dtype,
                           device=self.device)

    def normal(self, shape, scale: float, dtype) -> torch.Tensor:
        t = self._empty(shape, dtype)
        if self.device.type != "meta":
            t.normal_(0.0, scale, generator=self.gen)
        return t

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        t = self._empty(shape, dtype)
        if self.device.type != "meta":
            t.fill_(value)
        return t


def _dense_init(init: ParamInit, shape, scale=None, dtype=torch.float32):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return init.normal(shape, scale, dtype)


# ------------------------------------------------------------------ norm --


def rmsnorm_init(init: ParamInit, d: int, dtype=torch.float32):
    return {"scale": init.full((d,), 1.0, dtype)}


def rmsnorm(params, x, eps: float = 1e-6):
    """float32 inside, the output in x's type (``layers.py:24-30``)."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


# ------------------------------------------------------------------ rope --


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, Dh); positions: (..., T) integers.  The half-split
    rotation in float32 angles, cast back to x's type (``layers.py:40-51``)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * freqs    # (..., T, half)
    cos = torch.cos(angles)[..., :, None, :]            # (..., T, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d_model: int):
    """MusicGen-style fixed sinusoidal embeddings: (..., T, d_model)."""
    half = d_model // 2
    freqs = 1.0 / (10_000.0 ** (torch.arange(
        half, dtype=torch.float32, device=positions.device) / half))
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ------------------------------------------------------------------- mlp --


def mlp_init(init: ParamInit, d_model: int, d_ff: int, kind: str,
             dtype=torch.float32):
    if kind == "swiglu":
        return {
            "w_gate": _dense_init(init, (d_model, d_ff), dtype=dtype),
            "w_up": _dense_init(init, (d_model, d_ff), dtype=dtype),
            "w_down": _dense_init(init, (d_ff, d_model), dtype=dtype),
        }
    return {
        "w_up": _dense_init(init, (d_model, d_ff), dtype=dtype),
        "w_down": _dense_init(init, (d_ff, d_model), dtype=dtype),
    }


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(params, x, kind: str, tp=SINGLE):
    """x (B, T, d) whole.  Under tensor parallelism (``tp``) w_gate and
    w_up hold the rank's columns of d_ff and w_down its columns of d, so h
    is gathered for w_down, then the output."""
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = gelu(x @ params["w_up"])
    h = tp.whole(h, params["w_down"].shape[-2])
    return tp.whole(h @ params["w_down"], x.shape[-1])


# -------------------------------------------------------------- embedding --


def embedding_init(init: ParamInit, vocab: int, d_model: int,
                   dtype=torch.float32):
    return {"table": _dense_init(init, (vocab, d_model), scale=0.02,
                                 dtype=dtype)}


def embed(params, tokens):
    return F.embedding(tokens, params["table"])


def unembed_init(init: ParamInit, d_model: int, vocab: int,
                 dtype=torch.float32):
    return {"w": _dense_init(init, (d_model, vocab), dtype=dtype)}


def unembed(params, x, dtype=torch.float32):
    """Logits in ``dtype`` (float32 by default, bf16 selectable); the
    product accumulates in float32 either way (``layers.py:105-110``)."""
    dtype = torch_dtype(dtype)
    return x.to(dtype) @ params["w"].to(dtype)
