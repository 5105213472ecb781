"""Sharding rules for parameter and batch trees on a mesh (the port of
``repro.dist.sharding``).

The rules are path- and shape-driven, as the reference's, and give the
same spec for every leaf: the parameter trees of ``models.model`` keep the
reference's keys, so the paths ('layers/moe/w_up') are the same.  A spec
is a tuple with one entry per leading dimension (trailing ``None`` left
out, as a ``PartitionSpec`` prints): an axis name, a tuple of axis names,
or ``None``.  ``placements`` turns a spec into DTensor placements.

  * ``param_specs(tree)``          — the spec per parameter, assuming the
    production axis sizes (pod=2, data=16, model=16).
  * ``param_shardings(mesh, tree)`` — the same rules fitted to ``mesh``
    (axes it lacks or that do not divide the dimension are dropped).
  * ``data_specs`` / ``batch_spec`` — batch trees: the leading (batch)
    dimension over the data-parallel axes, the rest replicated.

Rules (in order):
  1. norm scales, 1-D parameters and the small SSM/bias leaves
     (``A_log``, ``D``, ``dt_bias``, ``conv_b``, ``bq``/``bk``/``bv``) are
     replicated.
  2. MoE expert stacks (``moe/w_*``: (L, E, d, ff)) shard the expert
     dimension over ``model``.
  3. Any other matrix shards its last 16-divisible dimension over
     ``model``.

The port's sharded train step (``training.train.make_sharded_train_step``)
splits the batch by ``data_specs`` and, over ``model``, the parameters by
``param_shardings``: each rank holds its slice of every leaf whose fitted
spec names ``model`` (``dist.tensor_parallel``), for every arch: the MoE
expert stacks (rule 2) as E/n whole experts a rank (``models.moe``).
The dry run prices the layout.
"""

from __future__ import annotations

import math

# production axis sizes assumed by the abstract rules (launch/mesh.py)
PROD_AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}
_MODEL = PROD_AXIS_SIZES["model"]

_REPLICATED_SUFFIXES = ("A_log", "D", "dt_bias", "conv_b", "bq", "bk", "bv",
                        "scale")


def leaves_with_paths(tree, path=""):
    """[(path, leaf)] of nested dicts, keys sorted (``tree_leaves``'
    order), paths as 'layers/moe/w_up'."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                leaves_with_paths(tree[k], f"{path}/{k}" if path else k)]
    return [(path, tree)]


def _map_with_path(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def _spec_for(path: str, shape: tuple[int, ...]) -> tuple:
    if len(shape) < 2:
        return ()
    if "norm" in path or path.endswith(_REPLICATED_SUFFIXES):
        return ()
    axes: list = [None] * len(shape)
    if "moe/w_" in path and shape[1] % _MODEL == 0:
        axes[1] = "model"  # expert parallelism over the (L, E, ...) stack
        return tuple(axes)
    # tensor parallelism: last dim that divides the model axis
    for i in range(len(shape) - 1, -1, -1):
        if shape[i] % _MODEL == 0:
            axes[i] = "model"
            return tuple(axes)
    return ()


def param_specs(tree):
    """The spec tree of a parameter tree (tensors, ``meta`` ones too):
    abstract, at the production axis sizes, no mesh needed."""
    return _map_with_path(lambda p, t: _spec_for(p, tuple(t.shape)), tree)


def _fit_to_mesh(mesh, spec: tuple, shape: tuple[int, ...]) -> tuple:
    """Drop spec axes that the mesh lacks or that do not divide the dim."""
    fitted = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            fitted.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if all(a in mesh.axis_names for a in axes):
            n = math.prod(mesh.shape[a] for a in axes)
            if n > 0 and dim % n == 0:
                fitted.append(ax)
                continue
        fitted.append(None)
    while fitted and fitted[-1] is None:
        fitted.pop()
    return tuple(fitted)


def param_shardings(mesh, tree):
    """The spec tree of ``tree`` fitted to ``mesh``: the abstract rules,
    re-validated against the mesh's axes and sizes."""
    return _map_with_path(
        lambda p, t: _fit_to_mesh(mesh, _spec_for(p, tuple(t.shape)),
                                  tuple(t.shape)), tree)


def data_axes(mesh, batch: int):
    """Largest data-parallel axis group whose size divides ``batch``."""
    for cand in (("pod", "data"), ("data",)):
        if all(a in mesh.axis_names for a in cand):
            n = math.prod(mesh.shape[a] for a in cand)
            if n > 0 and batch % n == 0:
                return cand
    return None


def _entry(axes: tuple):
    """A spec entry for ``axes``: one name alone, as ``PartitionSpec``
    keeps it."""
    return axes[0] if len(axes) == 1 else axes


def batch_spec(mesh, batch: int) -> tuple:
    """Spec for a leading batch dimension of size ``batch``."""
    axes = data_axes(mesh, batch)
    return (_entry(axes),) if axes is not None else (None,)


def data_specs(mesh, batch_shapes: dict) -> dict:
    """Batch-tree specs: dim 0 over the data axes, the rest replicated.
    ``batch_shapes`` maps a name to anything with a ``shape``."""
    out = {}
    for k, sds in batch_shapes.items():
        shape = tuple(sds.shape)
        bspec = batch_spec(mesh, shape[0]) if shape else ()
        out[k] = bspec + (None,) * (len(shape) - 1)
    return out


def decode_state_specs_tree(mesh, state_sds, global_batch: int):
    """Decode-cache specs: the batch dimension (matched by size) over the
    data axes, everything else replicated."""
    axes = data_axes(mesh, global_batch)

    def leaf_spec(_, sds):
        shape = tuple(sds.shape)
        parts: list = [None] * len(shape)
        if axes is not None:
            for i, dim in enumerate(shape):
                if dim == global_batch:
                    parts[i] = _entry(axes)
                    break
        return tuple(parts)

    return _map_with_path(leaf_spec, state_sds)


def spec_bytes_per_device(mesh, spec: tuple, nbytes: int) -> int:
    """Bytes of a leaf of ``nbytes`` on one device under a fitted spec."""
    n = 1
    for ax in spec:
        if ax is not None:
            n *= math.prod(mesh.shape[a] for a in
                           (ax if isinstance(ax, tuple) else (ax,)))
    return nbytes // n


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of a fitted ``spec``: per mesh axis, ``Shard(i)``
    when tensor dimension i is split over it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = {a: Replicate() for a in mesh.axis_names}
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            out[a] = Shard(i)
    return tuple(out[a] for a in mesh.axis_names)
