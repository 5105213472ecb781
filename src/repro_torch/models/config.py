"""Model configuration covering all six assigned architecture families
(the port's own copy of ``repro.models.config``: same fields, defaults and
counts; the port imports nothing of the JAX package).  The mesh knobs
(``attn_shard``, ``moe_weight_gather``, ``moe_shard_capacity``) are
accepted and have no effect on one device."""

from __future__ import annotations

import dataclasses
from typing import Literal

ArchType = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: ArchType
    n_layers: int
    d_model: int
    vocab: int
    # attention (ignored for pure SSM)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0            # defaults to d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    pos: Literal["rope", "sinusoidal", "none"] = "rope"
    # mlp
    d_ff: int = 0
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    # moe
    n_experts: int = 0
    top_k: int = 0
    router_aux_weight: float = 0.01
    # ssm / hybrid (Mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    shared_attn_every: int = 0   # hybrid: one shared attn block every k layers
    # vlm
    cross_attn_every: int = 0    # every k-th layer is a cross-attn layer
    n_image_tokens: int = 0      # image patch embeddings from the stub frontend
    # audio
    inputs_embeds: bool = False  # frontend stub provides (B, T, d_model)
    # long-context variant
    sliding_window: int = 8192   # used when seq_len > full_attn_max
    full_attn_max: int = 65536   # above this, dense archs switch to SWA
    # numerics
    dtype: str = "bfloat16"
    # ---- perf knobs (§Perf hillclimbing; defaults = paper-faithful base) --
    moe_dispatch: str = "sort"     # 'sort' (argsort) | 'cumsum' (sort-free)
    ssm_chunk: int = 128           # SSD intra-chunk length
    remat_policy: str = "nothing"  # 'nothing' | 'dots' (save matmul outputs)
    loss_impl: str = "logsoftmax"  # 'logsoftmax' | 'lse' (no (N,V) log-probs)
    logits_dtype: str = "float32"  # 'float32' | 'bfloat16' unembed output
    # force FSDP weight all-gather before the expert einsums instead of
    # letting the partitioner all-reduce the (E,C,f) activations (needs an
    # ambient mesh; production/dry-run path only)
    moe_weight_gather: bool = False
    # pin the (E, C, d) dispatch buffer to P('model','data',None): expert-
    # parallel over 'model', capacity over 'data' — each device computes its
    # 1/256 slice of expert work (needs ambient mesh)
    moe_shard_capacity: bool = False
    # explicit attention-activation sharding (ambient mesh required):
    # 'none' | 'heads' (q heads over 'model') | 'batch' (batch over
    # data x model — for head counts that don't divide the model axis)
    attn_shard: str = "none"
    # split the fused Mamba2 in_proj/conv into per-component projections so
    # no sharded-axis slicing happens (keeps activations sharded)
    ssm_split_proj: bool = False
    ssd_dtype: str = "float32"     # SSD intra-chunk math precision
    # notes / provenance (source paper or model card)
    source: str = ""

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/LM-head can
        shard over the 16-way model axis (standard TP padding)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Approximate total parameters (for roofline MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        kvd = (self.n_kv_heads or 1) * self.head_dim if self.n_heads else 0
        qd = self.n_heads * self.head_dim if self.n_heads else 0
        attn = d * qd + 2 * d * kvd + qd * d
        if self.mlp == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.is_moe:
            mlp *= self.n_experts
            mlp += d * self.n_experts  # router
        ssm = 0
        if self.arch_type in ("ssm", "hybrid"):
            di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = (d * (2 * di + 2 * n + h)   # in_proj (z,x,B,C,dt)
                   + di * d                    # out_proj
                   + self.ssm_conv * (di + 2 * n) + 3 * h + di)
        per_layer = 0
        n_attn_layers = self.n_layers
        if self.arch_type == "ssm":
            per_layer = ssm
            total = self.n_layers * per_layer
        elif self.arch_type == "hybrid":
            total = self.n_layers * ssm
            n_shared = 1  # one shared block reused
            total += n_shared * (attn + mlp)
        else:
            total = self.n_layers * (attn + mlp)
            if self.cross_attn_every:
                n_cross = self.n_layers // self.cross_attn_every
                total += n_cross * (attn + mlp)
        total += v * d  # embedding
        total += v * d  # lm head (untied)
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = (3 if self.mlp == "swiglu" else 2) * d * f
        inactive = self.n_layers * (self.n_experts - self.top_k) * per_expert
        return int(self.param_count() - inactive)
