"""Tensor parallelism over the mesh's ``model`` axis, written by hand: the
counterpart of what GSPMD does to the reference's train step under
``dist.sharding``'s specs (``repro.training.train.make_sharded_train_step``).

**Layout.** Rank r, at coordinate c of n on ``model``, holds of each leaf
whose fitted spec (``sharding.param_shardings``) names ``model`` on
dimension i the slice [c s, (c + 1) s) of that dimension, s its size over
n; every other leaf whole.  AdamW's moments take their parameters' slices.
``shard_state`` cuts a whole ``TrainState`` so (the counterpart of
``jax.device_put(state, state_sh)``) and ``gather_state`` is its inverse.
The model axis's size must divide 16, the production size the specs
assume, so that every leaf the specs split is split on every such mesh.

**Gradients.** An activation that every rank of a model group holds whole
(the residual stream, a gathered projection) carries a *partial*
gradient in the backward: its true gradient is the sum over the group of
the ranks' gradients.  An activation a rank holds a slice of (its
columns of a projection, its heads) carries its slice's true gradient.
So a product of a whole input with the rank's columns of a weight needs
no collective (the input's gradient is the rank's part of the sum), and

  * ``gather`` (all-gather along a dimension) has a reduce-scatter for its
    backward: the partial gradients of the whole tensor, summed, sliced;
  * ``sum`` (all-reduce) has the identity for its backward.  It serves the
    loss's sums over the vocabulary, after which every rank computes the
    same scalar from the same values, so the gradients there are whole;
  * ``reduce`` (all-reduce) has an all-reduce for its backward: it sums
    the ranks' partial results into a whole activation (the MoE combine
    under expert parallelism, a router whose rows of d are split), whose
    gradient is partial on each rank, so the whole gradient of the
    ranks' parts is that sum again;
  * ``share`` passes on 1/n of the gradient of a value every rank
    computes alike from whole activations (the MoE aux loss): that
    gradient is whole on every rank, and the group's sums (a
    reduce-scatter, the whole leaves' all-reduce) must count it once;
  * a parameter held whole gets a partial gradient, which the train step
    sums over the group (one all-reduce of all such leaves).

Megatron's identity-with-an-all-reduce-backward is its form of the first
rule for whole gradients; under partial gradients it is not needed.

**The data group.**  The same class serves the ranks that differ only on
the data axes, for the sums a statistic of the whole batch needs (the
MoE routing, the masked loss; ``training.train``).  The step averages
the data ranks' gradients, so the objective is the mean over the group
of per-rank objectives that each hold such a statistic whole: the
adjoint of its all-reduce is an all-reduce too (``reduce``), and
``exclusive_sum`` (one all-gather, outside autograd) gives a rank the
counts of the ranks before it.

**Transport.** The collectives run over a ``torch.distributed`` group of
the ranks that differ only on ``model``.  Under gloo, tensors on the card
are staged through pinned host buffers (as ``core.dso_dist``'s ring
does); over NCCL they go as they are.  Every collective adds one to its
count in ``COUNTS``, with its bytes (the whole tensor: an all-gather's
result, a reduce-scatter's input, an all-reduce's operand) and the host
seconds it took, staging included; ``launch.dryrun`` prices the same
counts from shapes.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.dist import sharding as shd

#: per kind: calls, bytes, host seconds (``reset_counts``, ``counts``)
COUNTS = {k: {"calls": 0, "bytes": 0, "seconds": 0.0}
          for k in ("all-gather", "reduce-scatter", "all-reduce")}

PROD_MODEL = shd.PROD_AXIS_SIZES["model"]


def reset_counts():
    for c in COUNTS.values():
        c.update(calls=0, bytes=0, seconds=0.0)


def counts() -> dict:
    """A copy of ``COUNTS``."""
    return {k: dict(v) for k, v in COUNTS.items()}


def _note(kind: str, t: torch.Tensor, t0: float):
    c = COUNTS[kind]
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()
    c["seconds"] += time.perf_counter() - t0


def heads_split(n: int, *heads: int) -> bool:
    """Whether each rank of ``n`` takes 1/n of each of these head counts
    (the model's choice between its rank's heads and gathered
    projections; ``launch.dryrun`` prices the same choice)."""
    return n > 1 and all(h % n == 0 for h in heads)


class TensorParallel:
    """This rank's ``model`` group (or its data group): ``n`` ranks, this
    one at ``coord``.  ``SINGLE`` (n 1) is one process: every method
    returns its input."""

    def __init__(self, group, n: int, coord: int):
        self.group, self.n, self.coord = group, n, coord

    # ------------------------------------------------ raw collectives --

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """In place over the group, outside autograd; returns ``t``."""
        t0 = time.perf_counter()
        if self._staged(t):
            h = self._host(t)
            dist.all_reduce(h, op=op, group=self.group)
            t.copy_(h)
        else:
            dist.all_reduce(t, op=op, group=self.group)
        _note("all-reduce", t, t0)
        return t

    def _all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        t0 = time.perf_counter()
        t = t.contiguous()
        # the collective stacks the ranks' tensors along dimension 0
        out = t.new_empty((self.n * t.shape[0],) + tuple(t.shape[1:]))
        if self._staged(t):
            h = torch.empty(out.shape, dtype=t.dtype, pin_memory=True)
            dist.all_gather_into_tensor(h, self._host(t), group=self.group)
            out.copy_(h)
        else:
            dist.all_gather_into_tensor(out, t, group=self.group)
        out = torch.cat(out.view((self.n,) + tuple(t.shape)).unbind(0),
                        dim=dim)
        _note("all-gather", out, t0)
        return out

    def _reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        t0 = time.perf_counter()
        # the ranks' slices stacked along dimension 0, as the collective
        # splits its input
        parts = torch.cat(t.chunk(self.n, dim=dim))
        staged = self._staged(parts)
        src = self._host(parts) if staged else parts
        shape = (parts.shape[0] // self.n,) + tuple(parts.shape[1:])
        out = torch.empty(shape, dtype=src.dtype, pin_memory=True) \
            if staged else src.new_empty(shape)
        dist.reduce_scatter_tensor(out, src, group=self.group)
        if staged:
            out = out.to(t.device)
        _note("reduce-scatter", t, t0)
        return out

    # ------------------------------------------ differentiable forms --

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The group's slices of ``t`` along ``dim``, whole (in coordinate
        order); backward: reduce-scatter."""
        return _Gather.apply(t, dim, self) if self.n > 1 else t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group; backward: the identity (for values
        whose consumers every rank computes alike)."""
        return _Sum.apply(t, self) if self.n > 1 else t

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group; backward: the gradients summed over
        the group too (for the ranks' parts of a whole activation)."""
        return _Reduce.apply(t, self) if self.n > 1 else t

    def share(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` itself; backward: 1/n of the gradient (for a value every
        rank computes alike from whole activations)."""
        return _Share.apply(t, self.n) if self.n > 1 else t

    def exclusive_sum(self, t: torch.Tensor):
        """(the sum of ``t`` over the ranks before this one, its sum over
        the group), outside autograd: one all-gather."""
        if self.n == 1:
            return torch.zeros_like(t), t
        every = self._all_gather(t.detach()[None], 0)
        return every[:self.coord].sum(0), every.sum(0)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The group's elementwise maximum of ``t``, outside autograd."""
        if self.n == 1:
            return t.detach()
        return self.all_reduce_(t.detach().clone(), op=dist.ReduceOp.MAX)

    # ---------------------------------------------------- the layout --

    def whole(self, t: torch.Tensor, full: int, dim: int = -1):
        """``t`` whole along ``dim``: gathered if it is the rank's slice of
        a dimension of size ``full``, else as it is."""
        if t.shape[dim] == full:
            return t
        if t.shape[dim] * self.n != full:
            raise ValueError(f"a dimension of {t.shape[dim]} is neither "
                             f"{full} nor its 1/{self.n}")
        return self.gather(t, dim)

    def part(self, t, full: int, dim: int = -1):
        """The rank's slice of ``dim`` (size ``full``): ``t`` itself if it
        is already that slice, else a view of it (None stays None)."""
        if t is None or t.shape[dim] != full or self.n == 1:
            return t
        s = full // self.n
        return t.narrow(dim, self.coord * s, s)

    def splits(self, *heads: int) -> bool:
        """Whether the rank takes 1/n of each of these head counts."""
        return heads_split(self.n, *heads)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return tp._all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._reduce_scatter(g, ctx.dim), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, tp):
        return tp.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, tp):
        ctx.tp = tp
        return tp.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce_(g.clone()), None


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


SINGLE = TensorParallel(None, 1, 0)


# ------------------------------------------------------------ groups --


def axis_group(mesh, axes, rank: int):
    """(group, size, index) of the ranks that differ from ``rank`` only on
    ``axes``.  Every rank makes every such group, in the same order, as
    ``torch.distributed.new_group`` requires; (None, 1, 0) when the axes
    span one rank."""
    others = [a for a in mesh.axis_names if a not in axes]
    groups: dict = {}
    for r in range(mesh.size):
        c = mesh.coords(r)
        groups.setdefault(tuple(c[a] for a in others), []).append(r)
    if all(len(g) == 1 for g in groups.values()):
        return None, 1, 0
    mine = None
    for key in sorted(groups):
        g = dist.new_group(groups[key])
        if rank in groups[key]:
            mine = (g, len(groups[key]), groups[key].index(rank))
    return mine


def mesh_groups(mesh, rows: int):
    """(dp, tp) of this process's rank of the default process group, which
    must have ``mesh.size`` ranks: its data group (the ranks that differ
    only on the data axes that split a batch of ``rows``,
    ``dist.sharding.data_axes``) and its ``model`` group, each a
    ``TensorParallel`` (``SINGLE`` where the axes span one rank).  Every
    rank must call it, in the same order: it makes the groups."""
    n_model = model_size(mesh)
    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise RuntimeError(f"a step over mesh {mesh.dims} needs a process "
                           f"group of {mesh.size} ranks")
    rank = dist.get_rank()
    dp = tp = SINGLE
    axes = shd.data_axes(mesh, rows)
    if axes:
        group, n, coord = axis_group(mesh, axes, rank)
        if group is not None:
            dp = TensorParallel(group, n, coord)
    if n_model > 1:
        tp = TensorParallel(*axis_group(mesh, ("model",), rank))
    return dp, tp


def local_rows(batch: dict, dp) -> dict:
    """This rank's rows of each of ``batch``'s tensors under its data group
    ``dp`` (views; the whole batch when ``dp`` is one rank)."""
    return {k: dp.part(v, v.shape[0], 0) for k, v in batch.items()}


def model_size(mesh) -> int:
    """The mesh's ``model`` axis size (1 without one); it must divide
    16, the size the specs assume."""
    n = mesh.shape.get("model", 1)
    if PROD_MODEL % n:
        raise ValueError(f"the model axis ({n}) must divide {PROD_MODEL}, "
                         f"the size the sharding rules assume")
    return n


# --------------------------------------------------- state and shards --


def model_dim(spec) -> int | None:
    """The dimension a fitted spec splits over ``model``, or None."""
    for i, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return i
    return None


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_tree(tree, mesh, rank: int):
    """This rank's slices of a whole tree like the parameters: each leaf's
    slice on the dimension its fitted spec puts on ``model``, as fresh
    tensors; the other leaves as they are."""
    n = model_size(mesh)
    if n == 1:
        return tree
    c = mesh.coords(rank)["model"]

    def cut(t, spec):
        i = model_dim(spec)
        if i is None:
            return t
        s = t.shape[i] // n
        return t.narrow(i, c * s, s).clone()
    return _zip_map(cut, tree, shd.param_shardings(mesh, tree))


def shard_state(state, mesh, rank: int):
    """This rank's shards of a whole ``TrainState`` (``shard_tree`` of the
    parameters and moments)."""
    return state._replace(
        params=shard_tree(state.params, mesh, rank),
        opt=state.opt._replace(mu=shard_tree(state.opt.mu, mesh, rank),
                               nu=shard_tree(state.opt.nu, mesh, rank)))


def gather_tree(tree, mesh, specs):
    """The whole leaves of a tree like the parameters (a gradient, a
    moment) from every rank's slices, on every rank, each on its slice's
    device.  ``specs`` is the fitted parameter spec tree: a slice's shape
    alone does not say which dimension was split.  Every rank of the
    default process group (of ``mesh.size`` ranks) must call it; the
    slices travel through the host."""
    n = model_size(mesh)
    if n == 1:
        return tree
    rest = lambda r: {a: v for a, v in mesh.coords(r).items()  # noqa: E731
                      if a != "model"}
    mine = rest(dist.get_rank())
    group = sorted((mesh.coords(r)["model"], r) for r in range(mesh.size)
                   if rest(r) == mine)

    def full(t, spec):
        i = model_dim(spec)
        if i is None:
            return t
        h = t.detach().cpu().contiguous()
        every = [torch.empty_like(h) for _ in range(mesh.size)]
        dist.all_gather(every, h)
        return torch.cat([every[r] for _, r in group], dim=i).to(t.device)
    return _zip_map(full, tree, specs)


def gather_state(state, mesh, specs):
    """The whole ``TrainState`` from every rank's shards (the inverse of
    ``shard_state``): ``gather_tree`` of the parameters and moments."""
    return state._replace(
        params=gather_tree(state.params, mesh, specs),
        opt=state.opt._replace(mu=gather_tree(state.opt.mu, mesh, specs),
                               nu=gather_tree(state.opt.nu, mesh, specs)))


def whole_template(state, mesh, specs):
    """Empty host tensors of the whole state's shapes and types (the
    template a whole checkpoint loads into before it is sharded)."""
    n = model_size(mesh)

    def empty(t, spec):
        shape = list(t.shape)
        i = model_dim(spec)
        if i is not None:
            shape[i] *= n
        return torch.empty(shape, dtype=t.dtype)
    return state._replace(
        params=_zip_map(empty, state.params, specs),
        opt=state.opt._replace(
            mu=_zip_map(empty, state.opt.mu, specs),
            nu=_zip_map(empty, state.opt.nu, specs),
            step=torch.empty((), dtype=state.opt.step.dtype)))


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes one rank sends for a collective over ``n`` ranks of a whole
    tensor of ``nbytes`` (ring algorithms)."""
    f = (n - 1) / n
    return 2 * f * nbytes if kind == "all-reduce" else f * nbytes
