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
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.OptState


def lm_loss(params, batch, cfg: ModelConfig, *, remat: bool = True,
            q_chunk: int = 2048, unroll: bool = False):
    """Next-token cross entropy (+ MoE router aux loss): (total, {"loss",
    "aux_loss"})."""
    logits, aux = M.forward(params, batch, cfg, remat=remat, q_chunk=q_chunk,
                            unroll=unroll)
    tgt = batch["targets"][:, 1:].long()[..., None]
    if cfg.loss_impl == "lse":
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
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    else:
        loss = nll.mean()
    total = loss + cfg.router_aux_weight * aux["aux_loss"]
    return total, {"loss": loss, "aux_loss": aux["aux_loss"]}


def loss_and_grads(params, batch, cfg: ModelConfig, **kw):
    """(total, metrics, grads) of ``lm_loss`` at ``params``: the grads a
    tree like ``params``, each leaf in its parameter's type (zeros for a
    parameter the loss does not reach, as ``jax.grad`` gives)."""
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
    """The data-parallel train step over ``mesh`` for this process's rank
    of the default process group, which must have ``mesh.size`` ranks.

    ``batch_shapes`` maps each batch key to anything with a ``shape`` (a
    ``meta`` tensor).  Returns ``(step_fn, state_shardings,
    batch_shardings)``: ``state_shardings`` are the parameter specs
    fitted to the mesh (``dist.sharding.param_shardings``; the moments
    take the parameters', the step ``()``), ``batch_shardings`` the
    batch specs (``data_specs``).

    ``step_fn(state, batch)`` takes the whole batch and every parameter:
    each rank keeps the rows of its place on the batch's data axes,
    takes the gradient of its rows' loss, and averages the gradients and
    the loss metrics over the ranks of its data group with one
    all-reduce (a sum divided by the group's size; each rank's rows count
    equally, which is the whole batch's mean loss when no ``mask`` is
    given).  Every rank then applies the same update to whole
    parameters: the ``model`` axis is not split (tensor parallelism is not
    ported), so the ranks of one data group along it compute the same
    step.  Every rank must build the step, in the same order: it makes
    the data groups (``torch.distributed.new_group``).
    """
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise RuntimeError(f"the sharded step needs a process group of "
                           f"{mesh.size} ranks for mesh {mesh.dims}")
    p_sh = shd.param_shardings(mesh, M.param_specs(cfg))
    state_sh = TrainState(params=p_sh,
                          opt=opt.OptState(mu=p_sh, nu=p_sh, step=()))
    d_sh = shd.data_specs(mesh, batch_shapes)
    axes = shd.data_axes(mesh, next(iter(batch_shapes.values())).shape[0])
    rank = dist.get_rank()
    group, n_shards, shard = None, 1, 0
    if axes:
        # the ranks that differ only on the data axes; every rank makes
        # every group, in the same order
        others = [a for a in mesh.axis_names if a not in axes]
        groups: dict = {}
        for r in range(mesh.size):
            c = mesh.coords(r)
            groups.setdefault(tuple(c[a] for a in others), []).append(r)
        for key in sorted(groups):
            g = dist.new_group(groups[key])
            if rank in groups[key]:
                group, n_shards = g, len(groups[key])
                shard = groups[key].index(rank)

    def local(batch):
        out = {}
        for k, v in batch.items():
            spec = d_sh[k]
            if spec and spec[0] is not None:
                rows = v.shape[0] // n_shards
                v = v[shard * rows:(shard + 1) * rows]
            out[k] = v
        return out

    def sharded_step(state: TrainState, batch):
        total, metrics, grads = loss_and_grads(
            state.params, local(batch), cfg, remat=remat, q_chunk=q_chunk)
        if group is not None:
            leaves = opt.tree_leaves(grads)
            scalars = [total, metrics["loss"], metrics["aux_loss"]]
            flat = torch.cat([t.reshape(-1).to(torch.float32)
                              for t in leaves + scalars])
            dist.all_reduce(flat, group=group)
            flat /= n_shards
            parts = flat.split([t.numel() for t in leaves + scalars])
            grads = opt.tree_unflatten(grads, [
                p.view(t.shape).to(t.dtype) for p, t in zip(parts, leaves)])
            total, loss, aux = (p.view(()) for p in parts[len(leaves):])
            metrics = {"loss": loss, "aux_loss": aux}
        with torch.no_grad():
            params, opt_state, om = opt.apply(ocfg, state.params, grads,
                                              state.opt)
        return TrainState(params, opt_state), dict(metrics, total=total,
                                                   **om)

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
