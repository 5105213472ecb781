"""The dry run: what each (architecture x input shape) pair costs on the
production meshes, priced from ``meta`` specs (the port's counterpart of
``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --all --out DIR
    python -m repro_torch.launch.dryrun --arch zamba2-7b --shape train_4k \\
        [--multi-pod] [--out DIR]

The reference AOT-compiles each pair's jitted step for 256 or 512
placeholder XLA devices and reads XLA's analyses.  PyTorch has no
counterpart to that compile (no GSPMD), so this dry run computes, for
every pair on the 16 x 16 mesh and the 2 x 16 x 16 mesh, what the specs
determine:

* ``params`` and ``active_params`` (the configs' counts, as the
  reference records them) and ``param_numel``, the sum of the ``meta``
  tree's elements;
* ``bytes``: parameters, gradients and the AdamW moments (train), the
  decode cache (decode) and the batch, and ``per_device_bytes`` of each
  under the shardings ``dist.sharding`` fits to the mesh;
* ``flops``: the step's operations, counted from the shapes.
  Projections, MLP and MoE at 2 operations per active weight and token
  (the experts at top_k of n_experts; the unembedding at the positions
  that are scored: all in training, the last in a prefill, one in a
  decode step; the cross layers' K and V at the image tokens), attention
  at 4 Hq Dh per attended (query, key) pair under the window the kernel
  uses, the SSD scan at 5 n dh per step and head (the operation count of
  its bound in ``PERF.md``), and a train step's backward at twice its
  forward.  ``cost.flops`` holds the total, as the reference's record;
* ``collectives``: what the port's sharded train step
  (``training.train.make_sharded_train_step``) makes: one all-reduce of
  each device's gradients over the data group, priced at the ring's
  2 (n-1)/n of their bytes; and under ``model`` the tensor-parallel
  step's all-gathers, reduce-scatters and all-reduces
  (``tp_collectives``: counted from the shapes as
  ``dist.tensor_parallel`` counts them, with ``remat``'s recomputed
  forward; for ``moe`` the router's logits, the combine of the experts
  split over ``model`` or the gathers of their d_ff columns, and the
  routing's few bytes over the data group; for ``vlm`` the cross
  layers' heads), (n-1)/n of the whole tensors' bytes for a gather or a
  scatter.  A prefill or decode record has no data all-reduce (there is
  no gradient) and, under ``model``, the sharded serving steps'
  collectives (``serve_collectives``: ``serving.engine.
  make_sharded_prefill`` and ``make_sharded_serve_step``, one forward
  and the logits' gather over the vocabulary).

It cannot compute what the reference reads from XLA: the compiled
step's ``memory_analysis`` (temporaries included), the HLO parse of the
collectives (``benchmarks/report.py``), and lower and compile times.
Each record lists these under ``not_computed``.  Nothing runs on a
device, and records are written only under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

from repro_torch.configs.registry import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpm
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype

NOT_COMPUTED = ("memory_analysis", "hlo_collectives", "lower_s",
                "compile_s")


def _sharded_bytes(mesh, tree, spec_tree, itemsize=None) -> tuple[int, int]:
    """(total bytes, bytes on one device) of ``tree`` under the fitted
    ``spec_tree``, at ``itemsize`` bytes an element (default: each
    leaf's own)."""
    specs = dict(shd.leaves_with_paths(spec_tree))
    total = per = 0
    for path, t in shd.leaves_with_paths(tree):
        n = t.numel() * (itemsize or t.element_size())
        total += n
        per += shd.spec_bytes_per_device(mesh, specs[path], n)
    return total, per


def attended_pairs(T: int, window: int) -> int:
    """(query, key) pairs of causal attention over T positions, each
    query seeing its last ``window`` keys."""
    w = min(window, T)
    return w * (w + 1) // 2 + (T - w) * w


def forward_flops(cfg: ModelConfig, shape, params) -> dict:
    """Operations of one forward over the batch, by part."""
    B, T = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens = 1 if decode else T
    scored = T if shape.kind == "train" else 1
    n_img = cfg.n_image_tokens if cfg.arch_type == "vlm" else 0
    matmul = 0
    for path, t in shd.leaves_with_paths(params):
        if t.dim() < 2 or path == "embed":
            continue
        per_seq = tokens
        if path.startswith("unembed"):
            per_seq = scored
        elif path in ("cross_layers/attn/wk", "cross_layers/attn/wv"):
            per_seq = n_img
        n = t.numel()
        if "moe/w_" in path:
            n = n * cfg.top_k // cfg.n_experts
        matmul += 2 * n * per_seq
    matmul *= B
    attn = cross = ssd = 0
    if cfg.has_attention:
        qk = 4 * cfg.n_heads * cfg.head_dim
        if cfg.arch_type == "hybrid":
            n_self = cfg.n_layers // cfg.shared_attn_every
        elif cfg.arch_type == "vlm":
            n_self = cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
            cross = (cfg.n_layers // cfg.cross_attn_every) * qk * tokens \
                * n_img * B
        else:
            n_self = cfg.n_layers
        if decode:      # one query against the full cache
            pairs = T if T <= cfg.full_attn_max else cfg.sliding_window
        else:
            window = cfg.sliding_window if T > cfg.full_attn_max else T
            pairs = attended_pairs(T, window)
        attn = n_self * qk * pairs * B
    if cfg.arch_type in ("ssm", "hybrid"):
        ssd = cfg.n_layers * 5 * cfg.ssm_state * cfg.ssm_head_dim \
            * cfg.ssm_heads * tokens * B
    return dict(matmul=matmul, attention=attn, cross_attention=cross,
                ssd=ssd, forward=matmul + attn + cross + ssd)


def _gather(nbytes: int) -> tuple:
    """An all-gather of a whole tensor of ``nbytes`` (``TensorParallel.
    gather``), a reduce-scatter of its size in the backward."""
    return ("all-gather", nbytes, "reduce-scatter")


def _reduce(nbytes: int) -> tuple:
    """An all-reduce whose backward is one too (``TensorParallel.reduce``)."""
    return ("all-reduce", nbytes, "all-reduce")


def _attn_part(cfg: ModelConfig, split, prefix: str, n: int, bt: int,
               e: int, kv_rows: int = 0, decode: bool = False) -> list:
    """The collectives of one forward of an attention (``models.attention.
    self_attention``, or ``cross_attention`` over ``kv_rows`` image tokens
    when given, or with ``decode`` one token of ``decode_self_attention``,
    whose new key and value are gathered for the whole cache): the heads'
    (or the projections') gathers, then the output's."""
    hq, dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    g = cfg.n_kv_heads or hq
    kv = kv_rows or bt
    heads = tpm.heads_split(n, hq, g)
    # the projections gathered: all three unless the rank runs its heads;
    # in a decode step the new key and value always
    out = [_gather(e * rows * cols) for w, rows, cols in (
        ("wq", bt, hq * dh), ("wk", kv, g * dh), ("wv", kv, g * dh))
        if (not heads or (decode and w != "wq"))
        and split(f"{prefix}/attn/{w}")]
    if heads:                                 # the rank's heads: o gathered
        out.append(_gather(e * bt * hq * dh))
    if split(f"{prefix}/attn/wo"):
        out.append(_gather(e * bt * d))
    return out


def _mlp_part(cfg: ModelConfig, split, prefix: str, bt: int,
              e: int) -> tuple:
    """(body, output) of a dense MLP (``layers.mlp_apply``): h's gather,
    then the output's."""
    body = [_gather(e * bt * cfg.d_ff)] if split(f"{prefix}/mlp/w_up") \
        else []
    return body, [_gather(e * bt * cfg.d_model)] \
        if split(f"{prefix}/mlp/w_down") else []


def _moe_part(cfg: ModelConfig, dim, n_data: int, bt: int, e: int) -> tuple:
    """(body, output) of an MoE layer (``models.moe.moe_apply``): the
    router's logits made whole ((N, E) float32: its expert columns
    gathered, or its rows of d summed), the data group's slot counts (an
    all-gather of (D, E) int64) and probability sums ((E,) float32), then
    the experts: split over ``model``, the (N, d) float32 combine summed
    (the output); or their d_ff columns split, h and each expert's output
    gathered ((E, C, ...) at the whole batch's capacity C)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    C = int(max(1, round(bt * n_data * cfg.top_k * 1.25 / E)))
    body = []
    router = dim("layers/moe/router")
    if router == 2:
        body.append(_gather(4 * bt * E))
    elif router == 1:
        body.append(_reduce(4 * bt * E))
    if n_data > 1:
        body += [("all-gather", 8 * n_data * E, None), _reduce(4 * E)]
    if dim("layers/moe/w_up") == 1:           # E/n whole experts a rank
        return body, [_reduce(4 * bt * d)]
    if dim("layers/moe/w_up") is not None:
        body.append(_gather(e * E * C * f))
    if dim("layers/moe/w_down") is not None:
        body.append(_gather(e * E * C * d))
    return body, []


def _mamba_part(cfg: ModelConfig, split, n: int, bt: int, e: int,
                decode: bool = False) -> tuple:
    """(body, output) of a Mamba2 block (``models.mamba2.mamba2_apply``):
    the projections' outputs and the conv weights, y * silu(z) when the
    heads split (not in a ``decode`` step, ``mamba2_decode``, which
    updates the whole state), the output."""
    di, ns, h, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    if cfg.ssm_split_proj:
        proj = (("in_z", di), ("in_x", di), ("in_B", ns), ("in_C", ns),
                ("in_dt", h))
        conv = (("conv_x", di), ("conv_B", ns), ("conv_C", ns))
    else:
        proj = (("in_proj", 2 * di + 2 * ns + h),)
        conv = (("conv_w", di + 2 * ns),)
    out = [_gather(e * bt * c) for w, c in proj if split(f"layers/mamba/{w}")]
    out += [_gather(e * k * c) for w, c in conv
            if split(f"layers/mamba/{w}")]
    if tpm.heads_split(n, h) and not decode:
        out.append(_gather(e * bt * di))
    return out, [_gather(e * bt * cfg.d_model)] \
        if split("layers/mamba/out_proj") else []


def _forward_parts(cfg: ModelConfig, mesh, p_specs, rows: int, seq: int,
                   n_data: int | None, decode: bool = False) -> tuple:
    """(n, the split test, the embedding's collectives, [(body, output)
    per block run]) of one forward of ``rows`` sequences of ``seq``
    tokens on a device (``decode``: one token against the caches), the
    data group ``n_data`` ranks (default: the mesh's axes other than
    ``model``)."""
    n = tpm.model_size(mesh)
    if n_data is None:
        n_data = math.prod(v for a, v in mesh.shape.items() if a != "model")
    specs = dict(shd.leaves_with_paths(p_specs))
    dim = lambda path: tpm.model_dim(specs[path]) if n > 1 else None  # noqa
    split = lambda path: dim(path) is not None  # noqa: E731
    bt = rows * seq
    e = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    embed = [_gather(e * bt * cfg.d_model)] if not cfg.inputs_embeds \
        and split("embed/table") else []

    def attn_block(prefix, kv_rows=0):
        body, out = _mlp_part(cfg, split, prefix, bt, e)
        return _attn_part(cfg, split, prefix, n, bt, e, kv_rows,
                          decode and not kv_rows) + body, out

    runs = []                           # (body, output) per block run
    if cfg.arch_type in ("dense", "audio"):
        runs = [attn_block("layers")] * cfg.n_layers
    elif cfg.arch_type == "moe":
        body, out = _moe_part(cfg, dim, n_data, bt, e)
        runs = [(_attn_part(cfg, split, "layers", n, bt, e, decode=decode)
                 + body, out)] * cfg.n_layers
    elif cfg.arch_type in ("ssm", "hybrid"):
        runs = [_mamba_part(cfg, split, n, bt, e, decode)] * cfg.n_layers
        if cfg.arch_type == "hybrid":
            runs += [attn_block("shared_attn")] \
                * (cfg.n_layers // cfg.shared_attn_every)
    elif cfg.arch_type == "vlm":        # groups of ce - 1 self, 1 cross
        groups = cfg.n_layers // cfg.cross_attn_every
        runs = [attn_block("layers")] * (groups * (cfg.cross_attn_every - 1)
                                         ) + [attn_block(
                                             "cross_layers",
                                             rows * cfg.n_image_tokens)] \
            * groups
    return n, split, embed, runs


def _by_kind(ops) -> dict:
    out = {}
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        got = [b for k, b, _ in ops if k == kind]
        out[kind] = dict(count=len(got), result_bytes=sum(got))
    return out


def tp_collectives(cfg: ModelConfig, mesh, p_specs, rows: int, seq: int, *,
                   remat: bool = True, n_data: int | None = None) -> dict:
    """One sharded train step's collectives on one device, by kind: count
    and whole-tensor bytes (an all-gather's result, a reduce-scatter's
    input, an all-reduce's operand), as ``dist.tensor_parallel.COUNTS``
    records them, for ``rows`` sequences of ``seq`` tokens on the device
    and a data group of ``n_data`` ranks (default: the mesh's axes other
    than ``model``; a batch without a ``mask``).  Over ``model``: every
    all-gather's backward is a reduce-scatter of its size, every
    ``reduce``'s an all-reduce; with ``remat`` a block's forward
    collectives run again in the backward, but for its output's: the
    recomputation stops at the last tensor the backward saved
    (``torch.utils.checkpoint``'s early stop).  The loss makes three
    all-reduces of (rows, seq - 1) float32 (the row max, the sum of
    exponentials, the target's logit); the step one of the whole leaves'
    float32 gradients and one of the norm's square sum.  Over the data
    group, each MoE layer's slot counts and probability sums (the step's
    all-reduce of the gradients over it is priced apart, by
    ``run_pair``)."""
    n, split, embed, runs = _forward_parts(cfg, mesh, p_specs, rows, seq,
                                           n_data)
    forward = embed + [x for body, out in runs for x in body + out]
    again = [x for body, _ in runs for x in body] if remat else []
    backward = [(bwd, nbytes, None) for _, nbytes, bwd in forward if bwd]
    whole = sum(t.numel() for path, t in shd.leaves_with_paths(
        S.param_spec_tree(cfg)) if not split(path))
    step = [("all-reduce", b, None) for b in
            [rows * (seq - 1) * 4] * 3 + [4 * whole, 4]] if n > 1 else []
    return _by_kind(forward + again + backward + step)


def serve_collectives(cfg: ModelConfig, mesh, p_specs, rows: int,
                      seq: int, *, decode: bool,
                      n_data: int | None = None) -> dict:
    """The collectives of one call of the sharded prefill
    (``serving.engine.make_sharded_prefill``: ``rows`` sequences of
    ``seq`` tokens on the device) or, with ``decode``, of one step of the
    sharded serve step (``make_sharded_serve_step``: ``rows`` tokens),
    by kind as ``tp_collectives`` gives them: the forward's (the decode
    attention's new key and value gathered for the whole caches, the
    Mamba2 state updated whole) and the gather of the last position's
    logits over the padded vocabulary; no backward and no step."""
    n, split, embed, runs = _forward_parts(cfg, mesh, p_specs, rows,
                                           1 if decode else seq, n_data,
                                           decode)
    ops = embed + [x for body, out in runs for x in body + out]
    if split("unembed/w"):
        itemsize = 4 if decode else torch.empty(
            (), dtype=torch_dtype(cfg.logits_dtype)).element_size()
        ops.append(_gather(itemsize * rows * cfg.padded_vocab))
    return _by_kind(ops)


def run_pair(arch: str, shape_name: str, *, multi_pod: bool,
             out: str | None = None) -> dict:
    """The record of one pair, also written to ``out``/<tag>.json when
    ``out`` is given."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    params = S.param_spec_tree(cfg)
    p_specs = shd.param_shardings(mesh, params)
    p_bytes, p_dev = _sharded_bytes(mesh, params, p_specs)
    nbytes = {"params": p_bytes}
    per_dev = {"params": p_dev}
    numel = sum(t.numel() for _, t in shd.leaves_with_paths(params))
    flops = forward_flops(cfg, shape, params)
    collectives = {}
    not_computed = list(NOT_COMPUTED)
    if shape.kind == "decode":
        state = S.decode_state_specs(cfg, shape)
        nbytes["decode_cache"], per_dev["decode_cache"] = _sharded_bytes(
            mesh, state, shd.decode_state_specs_tree(mesh, state,
                                                     shape.global_batch))
        batch = S.decode_specs(cfg, shape)
    else:
        batch = S.batch_specs(cfg, shape)
    nbytes["batch"], per_dev["batch"] = _sharded_bytes(
        mesh, batch, shd.data_specs(mesh, batch))
    axes = shd.data_axes(mesh, shape.global_batch)
    n = math.prod(mesh.shape[a] for a in axes) if axes else 1
    rows = shape.global_batch // n          # a device's batch rows
    if shape.kind == "train":
        nbytes["grads"], per_dev["grads"] = p_bytes, p_dev
        # mu and nu in float32 on the parameters' specs, the int32 step
        m_bytes, m_dev = _sharded_bytes(mesh, params, p_specs, itemsize=4)
        nbytes["opt_state"], per_dev["opt_state"] = 2 * m_bytes + 4, \
            2 * m_dev + 4
        flops["backward"] = 2 * flops["forward"]
        if n > 1:
            collectives["all-reduce"] = dict(
                count=1, group=n, axes=list(axes), result_bytes=p_dev,
                wire_bytes=tpm.wire_bytes("all-reduce", p_dev, n))
        model = tp_collectives(cfg, mesh, p_specs, rows, shape.seq_len,
                               n_data=n)
    else:
        model = serve_collectives(cfg, mesh, p_specs, rows, shape.seq_len,
                                  decode=shape.kind == "decode", n_data=n)
    n_model = mesh.shape["model"]
    collectives["model"] = {
        kind: dict(rec, group=n_model, axes=["model"],
                   wire_bytes=tpm.wire_bytes(kind, rec["result_bytes"],
                                             n_model))
        for kind, rec in model.items()}
    total = flops["forward"] + flops.get("backward", 0)
    rec = dict(
        arch=arch, shape=shape_name,
        mesh="2x16x16" if multi_pod else "16x16", n_devices=mesh.size,
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        param_numel=numel,
        bytes=nbytes, per_device_bytes=per_dev, flops=flops,
        cost={"flops": float(total)}, collectives=collectives,
        not_computed=not_computed)
    if out:
        os.makedirs(out, exist_ok=True)
        tag = f"{arch}__{shape_name}__{'multipod' if multi_pod else 'pod'}"
        with open(os.path.join(out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="the port's dry run: bytes, "
                                             "FLOPs and collectives per "
                                             "(arch, shape) pair")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every pair on both meshes")
    ap.add_argument("--out", help="directory for one JSON record per pair")
    args = ap.parse_args(argv)
    if args.all:
        runs = [(a, s, mp) for mp in (False, True) for a in ARCH_IDS
                for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        runs = [(args.arch, args.shape, args.multi_pod)]
    else:
        ap.error("give --all, or --arch and --shape")
    for a, s, mp in runs:
        rec = run_pair(a, s, multi_pod=mp, out=args.out)
        print(f"{a} {s} {rec['mesh']}: flops {rec['cost']['flops']:.4e}, "
              f"params/device {rec['per_device_bytes']['params']:,} B")


if __name__ == "__main__":
    main()
