"""Snapshots: the flat-npz pytree codec and the complete DSO state.

Three layers, as in the reference (``repro/runtime/snapshot.py``), whose
files this codec reads and writes byte-compatibly: the same leaf names,
dtypes, per-leaf CRC32s and whole-file digest, so each package's
``verify_pytree`` / ``load_pytree`` accepts the other's file.

* **Codec** — ``save_pytree`` / ``load_pytree``: a pytree (nested dicts,
  lists, tuples and NamedTuples; ``None`` is an empty subtree) of tensors
  or arrays is copied to the host, keyed by its flattened path (``d:key``
  for a dict key, in sorted order; ``i:n`` for a sequence index;
  ``a:name`` for a NamedTuple field) and written as one ``.npz`` (a
  tmp file and ``os.replace``), with an optional JSON ``meta`` dict in a
  reserved key.  Restore is by path into the structure and dtypes of a
  template.

* **Integrity** — each file carries a CRC32 per leaf (value bytes, dtype,
  shape) and a whole-file digest over the leaf records and the meta JSON
  in a reserved ``__crc__`` key; ``verify_pytree`` recomputes all of it
  and raises ``SnapshotIntegrityError`` on truncation, bit flips or an
  unreadable file.  Files without the record verify as ``"legacy"``.

* **DSO snapshot** — ``DSOSnapshot`` is the complete state of an engine
  run at an epoch boundary: the ``DSOState`` (w, alpha, the AdaGrad sums,
  the epoch, written as an int32 leaf like the reference's), the
  schedule key, the epoch cursor, the evaluation history and the solver
  config.  The port's key is its ``torch.Generator``'s state, a uint8
  array (``get_state()``); the reference's is a uint32[2] ``jax.random``
  key.  Both ride in the meta as a list plus its dtype.
  ``SnapshotStore`` is the directory convention ``engine.driver.solve``
  (``checkpoint_every=``, ``store=``) and ``runtime.resume`` share: one
  ``dso_<epochs_done>.npz`` per checkpoint, latest-*valid*-wins on load (a
  corrupt file is moved into ``quarantine/`` and the next older valid one
  restores), retention by ``keep_last`` / ``keep_every``, and
  ``async_writes=True``: serialization, rename and gc on one background
  writer thread, ``flush()`` the durability barrier that every read path
  takes first.

The port updates ``DSOState`` IN PLACE (the reference donates it), so the
next chunk's kernels overwrite the tensors a snapshot was taken from:
``SnapshotStore.save`` therefore copies the state to the host before it
returns, in both modes, and never keeps a view of the live tensors.
Loaded snapshots hold CPU tensors; ``solve(init=...)`` copies them onto
the grid's device.
"""

from __future__ import annotations

import json
import os
import re
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.engine.data import DSOState

_META_KEY = "__meta__"
_CRC_KEY = "__crc__"
_RESERVED = (_META_KEY, _CRC_KEY)
_SEP = "|"


class SnapshotIntegrityError(ValueError):
    """A snapshot file failed verification (truncated, bit-flipped, or
    otherwise unreadable)."""


# ------------------------------------------------------------ the pytree --


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child) pairs of a container in flattening order, or None for
    a leaf; dict keys sorted as the reference's flattener sorts them."""
    if isinstance(tree, dict):
        for k in tree:
            if _SEP in str(k):
                raise ValueError(
                    f"pytree dict key {str(k)!r} contains the path "
                    f"separator {_SEP!r}; flat npz paths would collide")
        return [(f"d:{k}", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f"a:{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"i:{i}", c) for i, c in enumerate(tree)]
    return None


def _leaves_with_path(tree, path=()):
    """``[(flat path, leaf), ...]`` in flattening order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(_SEP.join(path), tree)]
    out = []
    for k, c in kids:
        out += _leaves_with_path(c, path + (k,))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in _leaves_with_path(tree)]


def _tree_map_with_path(fn, tree, path=()):
    """``tree`` with every leaf replaced by ``fn(flat path, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(_SEP.join(path), tree)
    vals = {k: _tree_map_with_path(fn, c, path + (k,)) for k, c in kids}
    if isinstance(tree, dict):
        return {k: vals[f"d:{k}"] for k in tree}
    seq = [vals[k] for k, _ in kids]
    if _is_namedtuple(tree):
        return type(tree)(*seq)
    return type(tree)(seq)


def _host(leaf) -> np.ndarray:
    """A leaf on the host: a tensor is copied off its device (a CPU tensor
    too, so a later in-place update cannot reach the copy)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


# ------------------------------------------------------------- the codec --


def flatten_pytree(tree) -> dict:
    """Pytree -> {flat path: host array} (the npz payload)."""
    return {path: _host(leaf) for path, leaf in _leaves_with_path(tree)}


def _json_default(o):
    if hasattr(o, "item") and getattr(o, "ndim", 1) == 0:
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"snapshot meta value {o!r} is not JSON-serializable")


def _leaf_record(arr: np.ndarray) -> list:
    """[crc32 of the value bytes, dtype, shape]: dtype and shape ride along
    so a header rewrite that reinterprets the same bytes is caught too."""
    return [zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            str(arr.dtype), list(arr.shape)]


def _file_digest(leaves: dict, meta_json: str | None) -> int:
    """CRC32 over the (sorted) leaf records and the meta JSON."""
    blob = json.dumps({"leaves": leaves, "meta": meta_json}, sort_keys=True)
    return zlib.crc32(blob.encode())


def save_pytree(path: str, tree, meta: dict | None = None) -> str:
    """Write a pytree (+ optional JSON ``meta``) as one ``.npz``, atomically
    (a tmp file in the same directory, then ``os.replace``), with the
    ``__crc__`` integrity record."""
    flat = flatten_pytree(tree)
    bad = [k for k in _RESERVED if k in flat]
    if bad:
        raise ValueError(f"pytree path collides with the reserved key(s) "
                         f"{bad}")
    meta_json = (json.dumps(meta, default=_json_default)
                 if meta is not None else None)
    leaves = {k: _leaf_record(v) for k, v in flat.items()}
    flat[_CRC_KEY] = np.asarray(json.dumps(
        {"leaves": leaves, "digest": _file_digest(leaves, meta_json)}))
    if meta_json is not None:
        flat[_META_KEY] = np.asarray(meta_json)
    tmp = path + ".tmp.npz"   # ends in .npz so np.savez appends nothing
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


def verify_pytree(path: str) -> str:
    """``"verified"`` when every leaf's CRC32, dtype and shape and the
    whole-file digest match the record; ``"legacy"`` for a readable file
    without one; otherwise ``SnapshotIntegrityError`` naming the first
    mismatch (truncation, bit flips, missing members, unreadable)."""
    try:
        with np.load(path) as data:
            keys = [k for k in data.files if k not in _RESERVED]
            meta_json = (str(data[_META_KEY][()])
                         if _META_KEY in data.files else None)
            if _CRC_KEY not in data.files:
                for k in keys:          # zip-member CRC check via read
                    _ = data[k]
                return "legacy"
            rec = json.loads(str(data[_CRC_KEY][()]))
            leaves = rec["leaves"]
            if sorted(leaves) != sorted(keys):
                raise SnapshotIntegrityError(
                    f"{path}: leaf set changed (recorded "
                    f"{sorted(leaves)}, found {sorted(keys)})")
            got = {k: _leaf_record(data[k]) for k in keys}
            for k in keys:
                if got[k] != leaves[k]:
                    raise SnapshotIntegrityError(
                        f"{path}: leaf {k!r} fails its CRC32/dtype/shape "
                        f"record (recorded {leaves[k]}, got {got[k]}) — "
                        f"bit flip or partial write")
            if _file_digest(leaves, meta_json) != rec["digest"]:
                raise SnapshotIntegrityError(
                    f"{path}: whole-file digest mismatch — meta or leaf "
                    f"record tampered/corrupted")
    except SnapshotIntegrityError:
        raise
    except Exception as e:   # BadZipFile, zlib.error, OSError, json, ...
        raise SnapshotIntegrityError(
            f"{path} is unreadable ({type(e).__name__}: {e}) — truncated "
            f"or corrupt snapshot file") from e
    return "verified"


def read_meta(path: str) -> dict | None:
    """The JSON ``meta`` of a saved pytree (None when saved without one)."""
    with np.load(path) as data:
        if _META_KEY not in data:
            return None
        return json.loads(str(data[_META_KEY][()]))


def load_pytree(path: str, tree_like):
    """Restore into the structure and leaf dtypes of ``tree_like``;
    returns ``(tree, meta)``.  A tensor template's leaf comes back as a
    tensor of its dtype on its device; any other template's as a numpy
    array of the template's dtype."""
    with np.load(path) as data:
        meta = (json.loads(str(data[_META_KEY][()]))
                if _META_KEY in data else None)

        def restore(key, leaf):
            if key not in data:
                raise ValueError(f"checkpoint {path} lacks leaf {key!r} "
                                 f"required by the template structure")
            arr = data[key]
            if arr.shape != tuple(np.shape(leaf)):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {arr.shape}, "
                    f"template expects {tuple(np.shape(leaf))} — resuming "
                    f"into a different grid? reshard first "
                    f"(repro_torch.runtime.reshard)")
            if isinstance(leaf, torch.Tensor):
                return torch.as_tensor(np.array(arr)).to(
                    device=leaf.device, dtype=leaf.dtype)
            return np.asarray(arr, np.asarray(leaf).dtype)

        tree = _tree_map_with_path(restore, tree_like)
    return tree, meta


# ------------------------------------------------------- the DSO snapshot --


class DSOSnapshot(NamedTuple):
    """The complete state of an engine run at an epoch boundary."""

    state: DSOState     #: (w_grid, gw_grid, alpha, ga, epoch)
    key: object         #: schedule key AFTER drawing epochs_done epochs
    epochs_done: int    #: epoch cursor (the chunk boundary it sits on)
    history: tuple      #: evaluation-hook dicts recorded so far
    config: dict        #: backend/schedule/loss/reg/lam/shape/... record


def _key_array(key) -> np.ndarray:
    """The host array a schedule key is saved as: a ``torch.Generator``'s
    state (uint8), or a copy of any other key (the reference's uint32[2])."""
    if isinstance(key, torch.Generator):
        return key.get_state().numpy()
    return _host(key)


def _codec_state(state: DSOState) -> DSOState:
    # the epoch is a Python int in the port and an int32 leaf on disk
    return state._replace(epoch=np.int32(state.epoch))


def _state_like(config: dict) -> DSOState:
    p, mb, db = int(config["p"]), int(config["mb"]), int(config["db"])
    z = torch.zeros
    return DSOState(w_grid=z((p, db)), gw_grid=z((p, db)),
                    alpha=z((p, mb)), ga=z((p, mb)), epoch=np.int32(0))


def save_snapshot(path: str, snap: DSOSnapshot) -> str:
    key = _key_array(snap.key)
    meta = dict(epochs_done=int(snap.epochs_done),
                history=list(snap.history),
                config=dict(snap.config),
                key=key.tolist(), key_dtype=str(key.dtype))
    return save_pytree(path, _codec_state(snap.state), meta=meta)


def load_snapshot(path: str) -> DSOSnapshot:
    """A snapshot from disk: its state as CPU tensors (epoch an int), its
    key as the host array it was saved as."""
    meta = read_meta(path)
    if meta is None or "config" not in meta:
        raise ValueError(f"{path} is not a DSO snapshot (no config meta)")
    state, _ = load_pytree(path, _state_like(meta["config"]))
    key = np.asarray(meta["key"], dtype=meta["key_dtype"])
    return DSOSnapshot(state=state._replace(epoch=int(state.epoch)),
                       key=key, epochs_done=int(meta["epochs_done"]),
                       history=tuple(meta["history"]),
                       config=meta["config"])


def _host_snapshot(snap: DSOSnapshot) -> DSOSnapshot:
    """The snapshot with its state and key copied to the host now."""
    st = snap.state
    return snap._replace(
        state=DSOState(w_grid=_host(st.w_grid), gw_grid=_host(st.gw_grid),
                       alpha=_host(st.alpha), ga=_host(st.ga),
                       epoch=int(st.epoch)),
        key=_key_array(snap.key))


class SnapshotStore:
    """Directory of ``dso_<epochs_done>.npz`` snapshots, latest-valid-wins.

    The duck-typed contract ``engine.solve`` calls is ``store.save(state=,
    key=, epochs_done=, history=, config=)`` (and ``flush()`` at the end of
    the run); the rest is for the resume side.  ``load()`` with no epoch
    walks snapshots newest first, verifying each; corrupt files are
    quarantined (moved into ``quarantine/``, recorded in
    ``self.quarantined``).  ``save`` then runs the retention gc: the
    newest ``keep_last`` survive, plus every epoch divisible by
    ``keep_every``; ``keep_last=None`` keeps everything.

    ``save`` copies the state to the host before it returns (the caller's
    next chunk updates those tensors in place).  With ``async_writes=True``
    the npz serialization, rename and gc then run on one background writer
    thread, overlapped with the caller's next chunk; ``flush()`` waits for
    them and re-raises the first failure, and every read path flushes
    first, so latest-valid-wins is the synchronous one.  A crash mid-write
    leaves only a ``.tmp`` file the name pattern never matches.
    """

    _PAT = re.compile(r"dso_(\d+)\.npz$")

    def __init__(self, directory: str, *, keep_last: int | None = None,
                 keep_every: int | None = None,
                 async_writes: bool = False):
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        if keep_every is not None and keep_every < 1:
            raise ValueError(f"keep_every must be >= 1, got {keep_every}")
        self.directory = directory
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.async_writes = bool(async_writes)
        self.quarantined: list = []   # (epochs_done, reason) in move order
        self._pool: ThreadPoolExecutor | None = None
        self._pending: list = []      # futures of submitted writes
        self._worker_thread = None    # set by the pool initializer

    def path(self, epochs_done: int) -> str:
        return os.path.join(self.directory, f"dso_{epochs_done:08d}.npz")

    # ------------------------------------------------- async write plumbing
    def _mark_worker(self):
        self._worker_thread = threading.current_thread()

    def _write(self, path: str, snapshot: DSOSnapshot) -> str:
        out = save_snapshot(path, snapshot)
        self.gc()
        return out

    def flush(self):
        """Wait until every pending background write has reached the disk
        (rename included), re-raising the first failure.  A no-op in
        synchronous mode."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        first_err = None
        for fut in pending:
            try:
                fut.result()
            except Exception as e:              # noqa: BLE001
                first_err = first_err or e
        if first_err is not None:
            raise first_err

    def _barrier(self):
        # read paths flush first, except on the writer thread itself (its
        # gc() lists the directory mid-write; joining its own future would
        # deadlock)
        if threading.current_thread() is not self._worker_thread:
            self.flush()

    def save(self, *, snapshot: DSOSnapshot | None = None, state=None,
             key=None, epochs_done: int = 0, history=(),
             config: dict | None = None) -> str:
        if snapshot is None:
            snapshot = DSOSnapshot(state=state, key=key,
                                   epochs_done=int(epochs_done),
                                   history=tuple(history),
                                   config=dict(config or {}))
        os.makedirs(self.directory, exist_ok=True)
        path = self.path(snapshot.epochs_done)
        # copy to the host NOW: the caller updates these tensors in place
        # as soon as save() returns
        snapshot = _host_snapshot(snapshot)
        if not self.async_writes:
            return self._write(path, snapshot)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="snapshot-writer",
                initializer=self._mark_worker)
        self._pending.append(self._pool.submit(self._write, path, snapshot))
        return path

    def epochs(self) -> list:
        self._barrier()
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := self._PAT.match(f)))

    def latest(self):
        eps = self.epochs()
        return eps[-1] if eps else None

    def verify(self, epochs_done: int) -> str:
        """``verify_pytree`` of one snapshot."""
        self._barrier()
        return verify_pytree(self.path(epochs_done))

    def quarantine(self, epochs_done: int, reason: str = "") -> str:
        """Move a corrupt snapshot into ``quarantine/`` (kept, not
        deleted) and record it; returns the new path."""
        self._barrier()   # the file may still be an in-flight write
        qdir = os.path.join(self.directory, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        src = self.path(epochs_done)
        dst = os.path.join(qdir, os.path.basename(src))
        os.replace(src, dst)
        self.quarantined.append((int(epochs_done), reason))
        return dst

    def latest_valid(self):
        """Newest epoch whose snapshot verifies and parses as a DSO
        snapshot, quarantining corrupt ones on the way; None when none
        remains."""
        for ep in reversed(self.epochs()):
            try:
                self.verify(ep)
                load_snapshot(self.path(ep))   # meta/config sanity too
                return ep
            except (SnapshotIntegrityError, ValueError, KeyError) as e:
                self.quarantine(ep, reason=str(e))
        return None

    def load(self, epochs_done: int | None = None) -> DSOSnapshot:
        if epochs_done is None:
            epochs_done = self.latest_valid()
            if epochs_done is None:
                raise FileNotFoundError(
                    f"no DSO snapshots in {self.directory} pass "
                    f"verification ({len(self.quarantined)} quarantined)")
        else:
            self.verify(epochs_done)
        return load_snapshot(self.path(epochs_done))

    def gc(self) -> list:
        """Delete all but the newest ``keep_last`` snapshots, never an
        epoch divisible by ``keep_every``; returns the epochs collected."""
        if self.keep_last is None:
            return []
        eps = self.epochs()
        keep = set(eps[-self.keep_last:])
        if self.keep_every is not None:
            keep |= {e for e in eps if e % self.keep_every == 0}
        dropped = [e for e in eps if e not in keep]
        for e in dropped:
            os.remove(self.path(e))
        return dropped
