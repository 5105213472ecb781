"""LM training: the loss, the train step, its data-parallel form and the
host loop (the port of ``repro.training.train``).

The state is a ``TrainState`` of nested dicts of tensors.  A step takes
the gradient of ``lm_loss`` by autograd (through the SWA and SSD kernels
and their backward kernels on the card: ``kernels.ops.SWAAttention`` and
``kernels.ops.SSDScan``) and returns a new state from
``optimizer.apply``; the old one is left as it was.  The step holds the
old and the new parameters and moments at once, as the reference's
undonated step would.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpm
from repro_torch.dist.tensor_parallel import SINGLE
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.OptState


def lm_loss(params, batch, cfg: ModelConfig, *, remat: bool = True,
            q_chunk: int = 2048, unroll: bool = False, tp=SINGLE,
            dp=SINGLE):
    """Next-token cross entropy (+ MoE router aux loss): (total, {"loss",
    "aux_loss"}).  Under ``tp`` the logits are the rank's slice of the
    vocabulary and the cross entropy is ``_vocab_parallel_nll``'s.  Under
    ``dp`` (the data group the batch's rows are split over) the loss is
    this rank's part of the whole batch's, so that the mean over the group
    is the whole batch's loss: its mean over its rows, or with a ``mask``
    the group's size times its masked sum over the whole batch's mask
    sum; the aux loss is the whole batch's on every rank."""
    logits, aux = M.forward(params, batch, cfg, remat=remat, q_chunk=q_chunk,
                            unroll=unroll, tp=tp, dp=dp)
    tgt = batch["targets"][:, 1:].long()[..., None]
    if tp.n > 1:
        nll = _vocab_parallel_nll(logits[:, :-1], tgt[..., 0], cfg, tp)
    elif cfg.loss_impl == "lse":
        # pad columns enter the logsumexp and are trained down like any
        # never-target id (the reference's §Perf form)
        lg = logits[:, :-1]
        lse = torch.logsumexp(lg.float(), dim=-1)
        nll = lse - torch.gather(lg, -1, tgt)[..., 0].float()
    else:
        if cfg.padded_vocab != cfg.vocab:  # mask vocab-padding logits out
            pad_mask = torch.arange(cfg.padded_vocab,
                                    device=logits.device) < cfg.vocab
            logits = torch.where(pad_mask, logits, -1e30)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -torch.gather(logp, -1, tgt)[..., 0]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:]
        loss = dp.n * (nll * mask).sum() / torch.clamp_min(
            dp.sum(mask.sum()), 1.0)
    else:
        loss = nll.mean()
    total = loss + cfg.router_aux_weight * aux["aux_loss"]
    return total, {"loss": loss, "aux_loss": aux["aux_loss"]}


def _vocab_parallel_nll(lg, tgt, cfg: ModelConfig, tp):
    """-log softmax at ``tgt`` (B, T) from ``lg`` (B, T, V/n), this rank's
    columns [c V/n, (c + 1) V/n) of the padded vocabulary: the row max and
    the sum of exponentials all-reduced over the group, the target's logit
    from the rank that holds its column.  In the "logsoftmax" form the pad
    columns are masked by their global index; "lse" keeps them, as the
    one-process loss does.  No rank holds the whole (B, T, V)."""
    v = lg.shape[-1]
    lo = tp.coord * v
    lg = lg.float()
    if cfg.loss_impl != "lse" and cfg.padded_vocab != cfg.vocab:
        cols = torch.arange(lo, lo + v, device=lg.device)
        lg = torch.where(cols < cfg.vocab, lg, -1e30)
    m = tp.max(lg.amax(dim=-1))
    lse = m + torch.log(tp.sum(torch.exp(lg - m[..., None]).sum(dim=-1)))
    own = (tgt >= lo) & (tgt < lo + v)
    pick = torch.gather(lg, -1, (tgt - lo).clamp(0, v - 1)[..., None])
    return lse - tp.sum(torch.where(own, pick[..., 0], 0.0))


def loss_and_grads(params, batch, cfg: ModelConfig, **kw):
    """(total, metrics, grads) of ``lm_loss`` at ``params``: the grads a
    tree like ``params``, each leaf in its parameter's type (zeros for a
    parameter the loss does not reach, as ``jax.grad`` gives).  Under
    ``tp=`` each rank's: whole leaves' gradients are partial (their sum
    over the group is the gradient)."""
    live = opt.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        total, metrics = lm_loss(live, batch, cfg, **kw)
        leaves = opt.tree_leaves(live)
        got = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = opt.tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, got)])
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig, *,
                    remat: bool = True, q_chunk: int = 2048,
                    unroll: bool = False):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch):
        total, metrics, grads = loss_and_grads(
            state.params, batch, cfg, remat=remat, q_chunk=q_chunk,
            unroll=unroll)
        with torch.no_grad():
            params, opt_state, om = opt.apply(ocfg, state.params, grads,
                                              state.opt)
        return TrainState(params, opt_state), dict(metrics, total=total,
                                                   **om)

    return train_step


def make_sharded_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig, mesh,
                            batch_shapes: dict, *, remat: bool = True,
                            q_chunk: int = 2048):
    """The train step over ``mesh`` for this process's rank of the default
    process group, which must have ``mesh.size`` ranks: data parallelism
    over the batch's data axes and tensor parallelism over ``model``, the
    reference's GSPMD step written by hand.

    ``batch_shapes`` maps each batch key to anything with a ``shape`` (a
    ``meta`` tensor).  Returns ``(step_fn, state_shardings,
    batch_shardings)``: ``state_shardings`` are the parameter specs
    fitted to the mesh (``dist.sharding.param_shardings``; the moments
    take the parameters', the step ``()``), ``batch_shardings`` the
    batch specs (``data_specs``).

    ``step_fn(state, batch)`` takes this rank's shards of the state
    (``dist.tensor_parallel.shard_state``: each leaf's slice of the
    dimension its spec puts on ``model``, the rest whole) and the whole
    batch.  Each rank keeps the rows of its place on the data axes; the
    ranks of one ``model`` group run the forward and backward together
    (``models.model.forward(tp=)``: column-split projections with gathered
    outputs, the SWA and SSD kernels on each rank's heads, the
    vocabulary-split cross entropy).  The whole leaves' partial gradients
    are summed over the model group with one all-reduce; then, as before,
    the gradients and the loss metrics are averaged over the data group
    with one all-reduce (a sum divided by its size).  The loss is the whole
    batch's (``lm_loss(dp=)``: a ``mask``'s sum is taken over the data
    group), and so is the MoE routing (``models.moe``: capacity, slot
    ranks and aux loss over the data group).  The clip's norm sums the
    split leaves' squares over the model group (``optimizer.global_norm``),
    and each rank updates its shards.  The result equals the one-process
    step's within float32 summation noise, for every arch: the MoE
    layer's experts split over ``model`` (or their d_ff columns), the
    vlm's cross-attention on each rank's heads.  Every rank must build
    the step, in the same order: it makes the groups
    (``torch.distributed.new_group``).
    ``step_fn.loss_and_grads(params, batch)`` is the step's
    (total, metrics, grads) before the update, ``step_fn.grad_norm(grads)``
    their norm (the clip's).
    """
    import torch.distributed as dist

    p_sh = shd.param_shardings(mesh, M.param_specs(cfg))
    state_sh = TrainState(params=p_sh,
                          opt=opt.OptState(mu=p_sh, nu=p_sh, step=()))
    d_sh = shd.data_specs(mesh, batch_shapes)
    dp, tp = tpm.mesh_groups(mesh,
                             next(iter(batch_shapes.values())).shape[0])
    sharded = opt.tree_map(lambda s: tpm.model_dim(s) is not None, p_sh)

    def grads_fn(params, batch):
        total, metrics, grads = loss_and_grads(
            params, tpm.local_rows(batch, dp), cfg, remat=remat,
            q_chunk=q_chunk, tp=tp, dp=dp)
        leaves = opt.tree_leaves(grads)
        if tp.n > 1:        # the whole leaves' partial gradients
            whole = [g for g, f in zip(leaves, opt.tree_leaves(sharded))
                     if not f]
            flat = tp.all_reduce_(torch.cat([g.reshape(-1).float()
                                             for g in whole]))
            summed = iter(flat.split([g.numel() for g in whole]))
            leaves = [g if f else next(summed).view(g.shape).to(g.dtype)
                      for g, f in zip(leaves, opt.tree_leaves(sharded))]
            grads = opt.tree_unflatten(grads, leaves)
        if dp.n > 1:
            scalars = [total, metrics["loss"], metrics["aux_loss"]]
            flat = torch.cat([t.reshape(-1).to(torch.float32)
                              for t in leaves + scalars])
            dist.all_reduce(flat, group=dp.group)
            flat /= dp.n
            parts = flat.split([t.numel() for t in leaves + scalars])
            grads = opt.tree_unflatten(grads, [
                p.view(t.shape).to(t.dtype) for p, t in zip(parts, leaves)])
            total, loss, aux = (p.view(()) for p in parts[len(leaves):])
            metrics = {"loss": loss, "aux_loss": aux}
        return total, metrics, grads

    def grad_norm(grads):
        return opt.global_norm(grads, sharded, tp) if tp.n > 1 \
            else opt.global_norm(grads)

    def sharded_step(state: TrainState, batch):
        total, metrics, grads = grads_fn(state.params, batch)
        with torch.no_grad():
            params, opt_state, om = opt.apply(ocfg, state.params, grads,
                                              state.opt,
                                              gnorm=grad_norm(grads))
        return TrainState(params, opt_state), dict(metrics, total=total,
                                                   **om)

    sharded_step.loss_and_grads = grads_fn
    sharded_step.grad_norm = grad_norm
    return sharded_step, state_sh, d_sh


def init_state(key, cfg: ModelConfig, *, device="cuda") -> TrainState:
    """Random parameters (``models.model.init_params``: ``key`` a seed or a
    ``torch.Generator``) and zeroed moments on ``device`` (default the
    card)."""
    params = M.init_params(key, cfg, device=device)
    return TrainState(params=params, opt=opt.init(params))


def train_loop(cfg: ModelConfig, ocfg: opt.AdamWConfig, data_iter,
               steps: int, *, seed: int = 0, log_every: int = 10,
               remat: bool = True, checkpoint_dir: str | None = None,
               checkpoint_every: int = 0, device="cuda"):
    """The single-process training loop on ``device`` (default the card):
    (state, history), a history dict (loss, aux_loss, total, grad_norm,
    lr, step, wall) every ``log_every`` steps and at the last."""
    from repro_torch.training import checkpoint as ckpt
    dev = resolve_device(device)
    state = init_state(seed, cfg, device=dev)
    step_fn = make_train_step(cfg, ocfg, remat=remat)
    history = []
    t0 = time.time()
    for step in range(steps):
        batch = {k: v.to(dev) for k, v in next(data_iter).items()}
        state, metrics = step_fn(state, batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall"] = time.time() - t0
            history.append(m)
        if checkpoint_dir and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, state, step + 1)
    return state, history
