"""Distributed DSO: Algorithm 1 on a ring of worker processes.

The port's counterpart of the reference's ``shard_map`` ring.  A mesh
(``make_dso_mesh``) is a handle on p worker processes that join one
``torch.distributed`` process group through a ``FileStore`` in a
temporary directory; a ``ShardedDSO`` lives in the calling process (the
controller) and drives them.  Each worker is one of the paper's
processors:

  resident  : its row shard of the grid, cut into p tiles of one
              processor each (one per column block), its labels, row and
              tile statistics, its alpha shard and its dual AdaGrad sum.
  travelling: one w block and its primal AdaGrad sum, stacked into one
              (2, db) buffer and moved after every inner iteration.

Every inner iteration steps the worker's active tile as a grid of ONE
processor through the backend's ``block_step`` (the slicing of
``engine.backends._make_switch_block_step``): on the card each step is a
launch of the port's block-step kernels, on the CPU their plain versions.

The controller draws each chunk's permutations and step sizes exactly as
``engine.driver.solve`` does (the same ``torch.Generator`` stream, the
same ``eta_schedule``) and sends them to the workers, which run the chunk's
epochs locally.  Transports (all four give the same values):

  cyclic, ``overlap=True``   the double-buffered ring: one isend/irecv of
                             the stacked buffer per inner iteration,
                             posted before the iteration's telemetry
                             row is computed, which runs under it (the
                             next step needs the block, so nothing else
                             can);
  cyclic, ``overlap=False``  the serial-shift ring: w, then gw, each a
                             blocking exchange (two moves on the critical
                             path);
  other schedules, ``comm="p2p"`` (``"auto"``)
                             the static routes of ``_p2p_routes``: each
                             block goes from its holder straight to its
                             next consumer, identity moves elided;
  other schedules, ``comm="allgather"``
                             ``all_gather`` of every block, then a select.

After every epoch worker q again holds block q.  Process backends: ``gloo``
(on the CPU; on the card the blocks are staged through pinned host
memory, so p workers can share one card) and ``nccl`` (the card only,
one card per rank).  The caller names the backend; a backend that fails
to initialise raises.

Workers are fresh interpreters, each on its own socket pair with the
controller (so none outlives it); a ``WorkerPool`` keeps them for meshes
of any p up to its size (``make_dso_mesh(pool=)``; without one, the mesh
starts its own pool, which closes when the mesh is dropped).  Every reply
is awaited with the pool's timeout, which also bounds each gloo or nccl
operation; a worker's error or a timeout kills the pool's processes and
raises ``RuntimeError``.
"""

from __future__ import annotations

import datetime
import itertools
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
import weakref
from multiprocessing.connection import Connection

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing  # noqa: F401  (tensor reductions for pipes)

from repro_torch.core.losses import w_bounds
from repro_torch.core.saddle import Problem, duality_gap, primal_objective
from repro_torch.device import resolve_device
from repro_torch.engine.backends import get_backend, resolve_backend_for_layout
from repro_torch.engine.data import (DSOState, TileData, as_tile_data,
                                     check_tile_stats, eta_schedule,
                                     init_state_data, prob_meta, tile_dims)
from repro_torch.engine.driver import (TELEMETRY_FIELDS, _schedule_key,
                                       resolve_backend_and_build,
                                       telemetry_row, warn_ragged_eval)
from repro_torch.engine.schedules import get_schedule
from repro_torch.kernels import ops

TRANSPORTS = ("gloo", "nccl")
#: workers of a mesh made without ``p`` (gloo); nccl takes every card
DEFAULT_P = 4
#: seconds a reply, and a gloo or nccl operation, may take
DEFAULT_TIMEOUT = 300.0


# ----------------------------------------------------------- the pool --


#: a worker's command line: its end of the socket pair is argv[1]
_WORKER_CMD = ("import sys; from repro_torch.core.dso_dist import "
               "_worker_main; _worker_main(int(sys.argv[1]))")


def _shutdown(procs, conns, directory):
    """Stop a pool's workers: ask, wait 5 s, then kill; remove its
    rendezvous directory."""
    for conn in conns:
        try:
            conn.send(("close", (), ()))
        except (OSError, ValueError):
            pass
    deadline = time.monotonic() + 5.0
    for proc in procs:
        try:
            proc.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(5.0)
    for conn in conns:
        conn.close()
    shutil.rmtree(directory, ignore_errors=True)


class WorkerPool:
    """Worker processes that meshes draw on: worker i is rank i of every
    mesh built on the pool.  ``size`` workers start now; ``grow`` starts
    more.  Use as a context manager, or ``close()`` (also run when the
    pool is dropped, and at exit); a worker also stops when its socket to
    this process closes, so none outlives its controller."""

    def __init__(self, size: int = 0, *, timeout: float = DEFAULT_TIMEOUT):
        self.timeout = float(timeout)
        self.directory = tempfile.mkdtemp(prefix="dso_ring_")
        self._procs: list = []
        self._conns: list = []
        self._meshes: dict = {}        # (p, device, transport) -> mesh id
        self._ids = itertools.count()
        self._inflight = None          # (n workers, callback) of a post
        self._dropped: list = []       # solver ids to free on the workers
        self.closed = False
        self._finalizer = weakref.finalize(self, _shutdown, self._procs,
                                           self._conns, self.directory)
        self.grow(size)

    def grow(self, n: int):
        """Start workers until the pool has ``n``: fresh interpreters
        (nothing of the caller's main module runs in them), each talking
        to this process over its own socket pair, so a worker's pipe
        closes, and the worker stops, when this process ends."""
        self._live()
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        while len(self._procs) < n:
            mine, theirs = socket.socketpair()
            proc = subprocess.Popen(
                [sys.executable, "-c", _WORKER_CMD, str(theirs.fileno())],
                pass_fds=(theirs.fileno(),), env=env,
                stdin=subprocess.DEVNULL)
            theirs.close()
            self._procs.append(proc)
            self._conns.append(Connection(mine.detach()))

    def close(self):
        self.closed = True
        self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _live(self):
        if self.closed:
            raise RuntimeError("the worker pool is closed")

    def _fail(self, msg: str):
        self.close()
        raise RuntimeError(f"DSO ring worker pool failed: {msg}")

    def _recv(self, i: int, deadline: float, op: str):
        conn, proc = self._conns[i], self._procs[i]
        while not conn.poll(min(1.0, max(0.0, deadline - time.monotonic()))):
            if proc.poll() is not None:
                self._fail(f"worker {i} died (exit code {proc.returncode}) "
                           f"during {op!r}")
            if time.monotonic() >= deadline:
                self._fail(f"worker {i} gave no reply to {op!r} within "
                           f"{self.timeout} s")
        try:
            status, out = conn.recv()
        except EOFError:
            self._fail(f"worker {i} closed its pipe during {op!r}")
        if status != "ok":
            self._fail(f"worker {i} raised during {op!r}:\n{out}")
        return out

    def _collect(self, n: int, op: str) -> list:
        deadline = time.monotonic() + self.timeout
        return [self._recv(i, deadline, op) for i in range(n)]

    def flush(self):
        """Collect the replies of a posted call (``post``) and hand them
        to its callback."""
        if self._inflight is not None:
            n, op, callback = self._inflight
            self._inflight = None
            callback(self._collect(n, op))

    def post(self, op: str, args_list: list, callback):
        """Send ``op`` to workers 0..len(args_list)-1 and return at once;
        the replies go to ``callback`` at the next ``flush`` (every call
        flushes first)."""
        self.flush()
        self._live()
        drops, self._dropped = tuple(self._dropped), []
        for i, args in enumerate(args_list):
            self._conns[i].send((op, args, drops))
        self._inflight = (len(args_list), op, callback)

    def call(self, op: str, args_list: list) -> list:
        """``op`` on workers 0..len(args_list)-1, worker i with
        ``args_list[i]``; their replies in rank order."""
        out = []
        self.post(op, args_list, out.extend)
        self.flush()
        return out

    def mesh_id(self, p: int, device: torch.device, transport: str) -> int:
        """The id of the process group of workers 0..p-1 for this device
        and transport, made on first use (a collective rendezvous)."""
        key = (p, str(device), transport)
        if key not in self._meshes:
            self.grow(p)
            mid = next(self._ids)
            path = os.path.join(self.directory, f"mesh{mid}")
            self.call("join", [(mid, rank, p, path,
                                str(_rank_device(device, transport, rank)),
                                transport, self.timeout)
                               for rank in range(p)])
            self._meshes[key] = mid
        return self._meshes[key]


def _rank_device(device: torch.device, transport: str, rank: int):
    if transport == "nccl":
        return torch.device("cuda", rank)
    return device


class DSOMesh:
    """A handle on workers 0..p-1 of a pool, joined in one process group.
    ``device`` is where the workers hold their shards ("cpu", or the card:
    every rank on it under gloo, rank q on card q under nccl)."""

    def __init__(self, pool: WorkerPool, p: int, device: torch.device,
                 transport: str):
        self.pool, self.p = pool, p
        self.device, self.transport = device, transport
        self.id = pool.mesh_id(p, device, transport)

    def call(self, op: str, args_list: list) -> list:
        return self.pool.call(op, args_list)

    def resized(self, p: int) -> "DSOMesh":
        """A mesh of ``p`` workers on the same pool, device and transport
        (the live reshard's target)."""
        return make_dso_mesh(p, device=self.device,
                             transport=self.transport, pool=self.pool)

    def launch_counts(self) -> list:
        """Each worker's kernel launch counts (``ops.launch_counts``)."""
        return self.call("counts", [()] * self.p)

    def reset_launch_counts(self):
        self.call("reset_counts", [()] * self.p)

    def __repr__(self):
        return (f"DSOMesh(p={self.p}, device={str(self.device)!r}, "
                f"transport={self.transport!r})")


def make_dso_mesh(p: int | None = None, *, device="cuda",
                  transport: str = "gloo",
                  pool: WorkerPool | None = None) -> DSOMesh:
    """A mesh of ``p`` worker processes on ``device`` (default the card;
    ``RuntimeError`` when there is none).  ``transport`` is the process
    backend: "gloo" (the CPU, or the card with host-staged blocks) or
    "nccl" (one card per rank, so p cards).  ``p`` defaults to every card
    under nccl, to ``DEFAULT_P`` under gloo.  The workers are ranks
    0..p-1 of ``pool``; without one the mesh starts a pool of its own."""
    dev = resolve_device(device)
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                         f"{transport!r}")
    if transport == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl transport needs device='cuda'")
        n_cards = torch.cuda.device_count()
        p = n_cards if p is None else p
        if p > n_cards:
            raise ValueError(f"nccl runs one rank per card: p={p} needs "
                             f"{p} cards, this machine has {n_cards}")
    p = DEFAULT_P if p is None else int(p)
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    return DSOMesh(WorkerPool(p) if pool is None else pool, p, dev,
                   transport)


# ------------------------------------------------------------ the wire --


def _to_wire(obj, memo=None):
    """CPU tensors -> numpy (pickled by value), CUDA tensors as they are
    (CUDA IPC through the pipe), containers element-wise; one object per
    input object, so shared tensors travel once."""
    memo = {} if memo is None else memo
    if isinstance(obj, torch.Tensor):
        if id(obj) not in memo:
            memo[id(obj)] = (obj.detach() if obj.is_cuda
                             else obj.detach().numpy())
        return memo[id(obj)]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_wire(v, memo) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_wire(v, memo) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_wire(v, memo) for k, v in obj.items()}
    return obj


def _from_wire(obj, dev: torch.device, memo=None):
    """The inverse of ``_to_wire`` on the worker: every array a fresh
    tensor on ``dev`` (so nothing aliases the controller's memory)."""
    memo = {} if memo is None else memo
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        if id(obj) not in memo:
            memo[id(obj)] = torch.as_tensor(obj).to(dev, copy=True)
        return memo[id(obj)]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_from_wire(v, dev, memo) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_from_wire(v, dev, memo) for v in obj)
    if isinstance(obj, dict):
        return {k: _from_wire(v, dev, memo) for k, v in obj.items()}
    return obj


def _tile_arrays(arrays, payload: str, q: int, b: int, db: int, pool):
    """The layout payload of tile (q, b) as a grid of one processor;
    ``pool`` is shard q's chunk pool (the flat bucketed view), shared by
    its p tiles."""
    if len(arrays) == 1:                                   # dense
        (Xg,) = arrays
        return (Xg[q:q + 1, :, b * db:(b + 1) * db].contiguous(),)
    if len(arrays) == 2:                                   # block-ELL
        return tuple(a[q:q + 1, b:b + 1].contiguous() for a in arrays)
    if payload == "flat":                                  # chunk view
        lut, cnt = arrays[2:]
        return pool + (lut[q:q + 1, b:b + 1].contiguous(),
                       cnt[q:q + 1, b:b + 1].contiguous())
    *rects, bucket_id, bucket_pos = arrays                 # "buckets"
    k = int(bucket_id[q, b])
    s = int(bucket_pos[q, b])
    zero = torch.zeros((1, 1), dtype=torch.int32, device=rects[0].device)
    return (rects[2 * k][q:q + 1, s:s + 1].contiguous(),
            rects[2 * k + 1][q:q + 1, s:s + 1].contiguous(), zero, zero)


def _worker_tiles(tile: TileData, payload: str, q: int) -> list:
    """Worker q's p tiles, each a ``TileData`` of one processor (row shard
    q, column block b): the payload, the block's column statistics, the
    tile's row statistics, and the shard's labels and row counts."""
    p, mb, db = tile_dims(tile)
    pool = None
    if payload == "flat" and len(tile.arrays) == 4:
        pool = tuple(a[q:q + 1].contiguous() for a in tile.arrays[:2])
    rows = dict(yg=tile.yg[q:q + 1].contiguous(),
                row_nnz_g=tile.row_nnz_g[q:q + 1].contiguous(),
                row_valid=tile.row_valid[q:q + 1].contiguous())
    out = []
    for b in range(p):
        cols = slice(b * db, (b + 1) * db)
        out.append(TileData(
            arrays=_tile_arrays(tile.arrays, payload, q, b, db, pool),
            col_nnz=tile.col_nnz[cols].contiguous(),
            tile_col_nnz_g=tile.tile_col_nnz_g[q:q + 1, :, cols].contiguous(),
            tile_row_nnz_g=tile.tile_row_nnz_g[q:q + 1, b:b + 1]
            .contiguous(), **rows))
    return out


# ------------------------------------------------------------ routing --


def _p2p_routes(perm_e: np.ndarray):
    """Static routing for one epoch's (p, p) permutation ``perm_e[r, q]``
    = block worker q consumes at inner iteration r, given the epoch-start
    invariant that worker q holds block q.

    Returns ``p + 1`` source->target pair lists: entry ``r_next`` moves
    each block from its holder BEFORE inner iteration ``r_next`` straight
    to its ``r_next``-consumer (the schedule's inverse permutation names
    the holder), and entry ``p`` is the end-of-epoch restore that sends
    every block home.  ``None`` marks an identity move (elided)."""
    perm = np.asarray(perm_e)
    p = perm.shape[-1]
    # own[r] = holder map before inner iteration r; own[p] = after the last
    own = np.concatenate([np.arange(p)[None, :], perm], axis=0)
    inv = np.argsort(own, axis=-1)          # inv[r, b] = holder of block b
    qs = np.arange(p)
    routes = []
    for r_next in range(p + 1):
        want = perm[r_next] if r_next < p else qs
        src = inv[r_next][want]             # src[t] sends to worker t
        if np.array_equal(src, qs):
            routes.append(None)
        else:
            routes.append([(int(src[t]), t) for t in range(p)])
    return routes


# ---------------------------------------------------------- the worker --


class _Group:
    """One mesh's process group as a worker sees it, with the exchanges
    the ring needs.  Under gloo on the card every exchange stages its
    blocks through pinned host buffers."""

    def __init__(self, mid, rank, size, path, device, transport, timeout):
        self.rank, self.size = rank, size
        self.device = torch.device(device)
        self.transport = transport
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        store = dist.PrefixStore(f"mesh{mid}", dist.FileStore(path, size))
        tmo = datetime.timedelta(seconds=timeout)
        if transport == "gloo":
            opts = dist.ProcessGroupGloo._Options()
            opts._devices = [dist.ProcessGroupGloo.create_device(
                hostname="127.0.0.1")]
            opts._timeout = tmo
            self.pg = dist.ProcessGroupGloo(store, rank, size, opts)
        else:
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = tmo
            self.pg = dist.ProcessGroupNCCL(store, rank, size, opts)
        self.staged = transport == "gloo" and self.device.type == "cuda"

    def _host(self, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def exchange(self, send, dst, recv, src, tag: int = 0):
        """Post the send of ``send`` to rank ``dst`` and the receive of
        ``recv`` from rank ``src`` (either may be None); returns the wait,
        which also lands a staged receive on the card."""
        works, land = [], None
        if send is not None:
            buf = send
            if self.staged:
                buf = self._host(send)
                buf.copy_(send)             # waits for the step's kernels
            works.append(self.pg.send([buf], dst, tag))
        if recv is not None:
            buf = self._host(recv) if self.staged else recv
            works.append(self.pg.recv([buf], src, tag))
            if self.staged:
                land = (recv, buf)

        def wait():
            for w in works:
                w.wait()
            if land is not None:
                land[0].copy_(land[1], non_blocking=True)
        return wait

    def all_gather(self, t: torch.Tensor) -> list:
        src = t
        if self.staged:
            src = self._host(t)
            src.copy_(t)
        outs = [torch.empty_like(src) for _ in range(self.size)]
        self.pg.allgather([outs], [src]).wait()
        return [o.to(t.device) for o in outs]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def settle(self):
        """Before a staged move: wait for the step's kernels, which the
        copy to the host would wait for anyway, so that the time of the
        move is the move's."""
        if self.staged:
            self.sync()


class _Shard:
    """Worker q's part of one ``ShardedDSO``: its p tiles, its alpha and
    ga, and the double buffer the travelling (w, gw) block lives in."""

    def __init__(self, group: _Group, backend: str, meta, row_batches: int,
                 tiles, w, gw, alpha, ga):
        dev = group.device
        self.g, self.q, self.p = group, group.rank, group.size
        self.be = get_backend(backend)
        self.meta, self.row_batches = tuple(meta), row_batches
        self.tiles = tiles
        db = w.shape[0]
        self.bufs = [torch.empty((2, db), dtype=torch.float32, device=dev)
                     for _ in range(2)]
        self.cur = 0
        self.set(w, gw, alpha, ga)
        self.blk = torch.zeros(1, dtype=torch.int32, device=dev)

    def set(self, w, gw, alpha, ga):
        self.bufs[self.cur][0] = w
        self.bufs[self.cur][1] = gw
        self.alpha = alpha.reshape(1, -1).contiguous().clone()
        self.ga = ga.reshape(1, -1).contiguous().clone()

    def get(self):
        buf = self.bufs[self.cur]
        return tuple(t.detach().cpu().numpy().reshape(-1)
                     for t in (buf[0], buf[1], self.alpha, self.ga))

    def step(self, b: int, eta: float, telemetry: bool):
        """Inner iteration on block ``b``, in place on the current buffer.
        Returns ``note(row)``, which writes the iteration's telemetry row
        into ``row`` (a no-op without telemetry)."""
        buf = self.bufs[self.cur]
        if telemetry:
            w_old, a_old = buf[0:1].clone(), self.alpha.clone()
        state = DSOState(w_grid=buf[0:1], gw_grid=buf[1:2], alpha=self.alpha,
                         ga=self.ga, epoch=0)
        self.be.block_step(self.meta, self.tiles[b], state, self.blk, eta,
                           self.row_batches)
        if not telemetry:
            return lambda row: None

        def note(row):           # before the next step, and before a wait
            row.copy_(telemetry_row(w_old, buf[0:1], a_old, self.alpha,
                                    buf[1:2], self.ga,
                                    self.tiles[b].tile_row_nnz_g[0])[0])
        return note

    def _move(self, dst, src, row: int | None = None):
        """Post the move of the current buffer (or one of its rows) to rank
        ``dst`` and the receipt of the next block into the other buffer
        from rank ``src``; returns the wait.  Waiting on a whole-buffer
        receipt makes the other buffer current."""
        self.g.settle()
        t = time.perf_counter()
        rows = slice(0, 2) if row is None else slice(row, row + 1)
        nxt = 1 - self.cur
        wait = self.g.exchange(
            None if dst is None else self.bufs[self.cur][rows], dst,
            None if src is None else self.bufs[nxt][rows], src,
            0 if row is None else row)
        self.comm_s += time.perf_counter() - t

        def done():
            t = time.perf_counter()
            wait()
            if row is None and src is not None:
                self.cur = nxt
            self.comm_s += time.perf_counter() - t
        return done

    def _route(self, route):
        """One static p2p move (``_p2p_routes``): send the current block
        to the worker that consumes it next, receive the one this worker
        consumes next."""
        if route is None:
            return
        src = {t: s for s, t in route}
        frm = src[self.q]
        if frm == self.q:
            return             # this worker keeps its block; nobody sends
        dst = next(t for s, t in route if s == self.q and t != self.q)
        self._move(dst, frm)()

    def _fetch(self, perm, r_next: int):
        """The all-gather move before inner iteration ``r_next`` (``p``:
        the end-of-epoch restore): gather every block, keep the wanted."""
        self.g.settle()
        t = time.perf_counter()
        p, q = self.p, self.q
        own = np.concatenate([np.arange(p)[None, :], perm], axis=0)
        inv = np.argsort(own[r_next])          # block -> holder
        want = perm[r_next, q] if r_next < p else q
        got = self.g.all_gather(self.bufs[self.cur])
        self.bufs[self.cur].copy_(got[int(inv[want])])
        self.comm_s += time.perf_counter() - t

    def run(self, etas, perms, mode: str, telemetry: bool):
        """``len(etas)`` epochs; returns the telemetry rows (n, p, F) or
        None, the chunk's seconds and the seconds spent moving blocks."""
        n, p, q = len(etas), self.p, self.q
        left, right = (q - 1) % p, (q + 1) % p
        tel = (torch.zeros((n, p, len(TELEMETRY_FIELDS)),
                           dtype=torch.float32, device=self.g.device)
               if telemetry else None)
        self.comm_s = 0.0
        t0 = time.perf_counter()
        for e in range(n):
            eta = float(etas[e])
            routes = _p2p_routes(perms[e]) if mode == "p2p" else None
            for r in range(p):
                row = None if tel is None else tel[e, r]
                if mode.startswith("ring"):
                    b = (q + r) % p                 # sigma(q, r)
                else:
                    if mode == "p2p":
                        self._route(routes[r])
                    else:
                        self._fetch(perms[e], r)
                    b = int(perms[e][r, q])
                note = self.step(b, eta, telemetry)
                if mode == "ring_overlap" and p > 1:
                    wait = self._move(left, right)   # one stacked move
                    note(row)                        # runs under the move
                    wait()
                    continue
                note(row)
                if mode == "ring_serial" and p > 1:
                    self._move(left, right, 0)()     # w, then gw
                    self._move(left, right, 1)()
                    self.cur = 1 - self.cur
            if mode == "p2p":
                self._route(routes[p])
            elif mode == "allgather":
                self._fetch(perms[e], p)
        self.g.sync()
        seconds = time.perf_counter() - t0
        return (None if tel is None else tel.cpu().numpy(), seconds,
                self.comm_s)


class _Worker:
    def __init__(self):
        self.groups: dict = {}
        self.shards: dict = {}

    def join(self, mid, rank, size, path, device, transport, timeout):
        self.groups[mid] = _Group(mid, rank, size, path, device, transport,
                                  timeout)

    def setup(self, sid, mid, backend, meta, row_batches, payload):
        g = self.groups[mid]
        data = _from_wire(payload, g.device)
        self.shards[sid] = _Shard(g, backend, meta, row_batches,
                                  data["tiles"], data["w"], data["gw"],
                                  data["alpha"], data["ga"])
        g.sync()

    def run(self, sid, etas, perms, mode, telemetry):
        return self.shards[sid].run(etas, perms, mode, telemetry)

    def get(self, sid):
        return self.shards[sid].get()

    def set(self, sid, w, gw, alpha, ga):
        dev = self.shards[sid].g.device
        self.shards[sid].set(*(torch.as_tensor(a).to(dev)
                               for a in (w, gw, alpha, ga)))

    def counts(self):
        return ops.launch_counts()

    def reset_counts(self):
        ops.reset_launch_counts()


def _worker_main(fd: int):
    """A worker's loop on its end ``fd`` of the socket pair: one command
    at a time, each answered with ("ok", result) or ("err", traceback);
    ends on "close" or when the controller's end closes."""
    torch.set_num_threads(1)
    conn = Connection(fd)
    worker = _Worker()
    while True:
        try:
            op, args, drops = conn.recv()
        except (EOFError, OSError):
            break
        for sid in drops:
            worker.shards.pop(sid, None)
        if op == "close":
            break
        try:
            reply = ("ok", getattr(worker, op)(*args))
        except Exception:                         # noqa: BLE001
            reply = ("err", traceback.format_exc())
        # release what came over the pipe now (a CUDA IPC handle holds
        # the controller's memory until it is released)
        del args
        try:
            conn.send(reply)
        except (OSError, ValueError):
            break


# ---------------------------------------------------------- the driver --


def _drop(pool_ref, sid):
    pool = pool_ref()
    if pool is not None and not pool.closed:
        pool._dropped.append(sid)


class ShardedDSO:
    """Algorithm 1 on a mesh of worker processes, driven from here.

    ``prob`` is a ``Problem`` (the grid is built here, in the backend's
    layout, on the Problem's device) or pre-built grid data, which then
    needs ``loss_name``/``reg_name``/``lam``/``m``/``d`` (as
    ``engine.solve`` does) and is re-tiled when its p is not the mesh's.
    ``impl`` accepts any registered engine backend or legacy selector
    (``"auto"`` as in ``solve``); ``schedule`` any engine schedule.
    ``overlap`` picks the double-buffered ring over the serial shift;
    ``comm`` ("auto" = "p2p", or "allgather") the transport of the other
    schedules.  All four combinations give the same values.

    ``obs`` (a recorder): ``metrics`` mirrors its values into ``eval.*``
    gauges.  ``telemetry`` (a ``TelemetrySpec``): the workers fill one
    ``TELEMETRY_FIELDS`` row per inner iteration and ``run_epochs`` drains
    the chunk's (n, p, p, F) buffer into it.  ``metrics`` reports a
    Problem's primal and duality gap (a grid source has no X to evaluate:
    the epoch only)."""

    def __init__(self, prob, mesh: DSOMesh | None = None,
                 row_batches: int = 1, use_adagrad: bool = True,
                 alpha0: float = 0.0, impl: str = "jnp",
                 schedule: str = "cyclic", seed: int = 0, obs=None,
                 overlap: bool = True, comm: str = "auto", telemetry=None,
                 *, loss_name: str | None = None,
                 reg_name: str | None = None, lam: float | None = None,
                 m: int | None = None, d: int | None = None):
        if comm not in ("auto", "p2p", "allgather"):
            raise ValueError(
                f"comm must be 'auto', 'p2p' or 'allgather', got {comm!r}")
        self.prob = prob
        self.obs = obs
        self.telemetry = telemetry
        if isinstance(prob, Problem):
            dev = prob.device
            self.mesh = mesh or make_dso_mesh(device=dev)
            self.p = self.mesh.p
            self.backend, data = resolve_backend_and_build(
                prob, impl, self.p, row_batches)
            self.loss_name, self.reg_name = prob.loss_name, prob.reg_name
            self.m, self.d = prob.m, prob.d
            self.lam, self.m_f, _, _, _, self.w_lo, self.w_hi = \
                prob_meta(prob)
        else:
            missing = [k for k, v in (("loss_name", loss_name),
                                      ("reg_name", reg_name), ("lam", lam),
                                      ("m", m), ("d", d)) if v is None]
            if missing:
                raise ValueError(f"a grid source needs {missing}")
            dev = prob.yg.device
            self.mesh = mesh or make_dso_mesh(device=dev)
            self.p = self.mesh.p
            data = prob
            if tile_dims(data)[0] != self.p:
                from repro_torch.runtime.reshard import retile
                data = retile(data, m, d, self.p, row_batches=row_batches)
            self.backend = resolve_backend_for_layout(
                impl, as_tile_data(data).layout, device_type=dev.type)
            self.loss_name, self.reg_name = loss_name, reg_name
            self.m, self.d = int(m), int(d)
            self.lam, self.m_f = float(np.float32(lam)), float(np.float32(m))
            self.w_lo, self.w_hi = w_bounds(loss_name, lam)
        if self.mesh.device.type != dev.type:
            raise ValueError(f"the data lives on {dev}, the mesh's workers "
                             f"on {self.mesh.device}")
        self.device = dev
        self.schedule = get_schedule(schedule)
        self.key = torch.Generator().manual_seed(int(seed))
        check_tile_stats(data, row_batches)
        tile = as_tile_data(data, bucketed_payload=self.backend.payload)
        _, self.mb, self.db = tile_dims(tile)
        state = init_state_data(self.loss_name, data, alpha0)
        self.use_adagrad = use_adagrad
        self.row_batches = row_batches
        self.eta0_record = None
        self._ckpt_extra = dict(alpha0=float(alpha0), seed=int(seed))
        self._tile_nnz = (tile.tile_row_nnz_g.sum(-1).cpu().numpy()
                          if self.schedule.balanced else None)
        self.nnz = float((tile.row_nnz_g * tile.row_valid).sum())
        self.payload_bytes = float(sum(a.nbytes for a in tile.arrays))
        self.overlap = bool(overlap)
        self.comm = comm
        self._p2p = (not self.schedule.ring) and comm in ("auto", "p2p")
        self.epochs_done = 0
        self.last_run: list | None = None    # per worker: (s, comm s)
        meta = (self.lam, self.m_f, self.loss_name, self.reg_name,
                bool(use_adagrad), self.w_lo, self.w_hi)
        pool = self.mesh.pool
        self._sid = next(pool._ids)
        args = []
        for q in range(self.p):
            payload = dict(
                tiles=_worker_tiles(tile, self.backend.payload, q),
                w=state.w_grid[q], gw=state.gw_grid[q],
                alpha=state.alpha[q], ga=state.ga[q])
            args.append((self._sid, self.mesh.id, self.backend.name, meta,
                         row_batches, _to_wire(payload)))
        self.mesh.call("setup", args)
        # the workers hold copies now; the grid here goes out of scope
        del data, tile, state, args
        if dev.type == "cuda":
            torch.cuda.ipc_collect()
        weakref.finalize(self, _drop, weakref.ref(pool), self._sid)

    @property
    def mode(self) -> str:
        if self.schedule.ring:
            return "ring_overlap" if self.overlap else "ring_serial"
        return "p2p" if self._p2p else "allgather"

    @property
    def transport(self) -> str:
        """The telemetry's wire model: "ring", "p2p" or "allgather"."""
        return "ring" if self.schedule.ring else self.mode

    def run_epochs(self, n: int, eta0: float = 0.1):
        """Post ``n`` epochs to the workers and return; ``wait`` (or any
        later call on the mesh) collects them.  With a telemetry spec the
        chunk is collected here and its buffer drained into the spec."""
        self.eta0_record = eta0
        t0 = self.epochs_done
        etas = eta_schedule(eta0, t0, n, self.use_adagrad)
        ctx = ({"tile_nnz": self._tile_nnz} if self.schedule.balanced
               else {})
        self.key, perms = self.schedule.draw(self.key, t0, n, self.p, **ctx)
        perms = np.asarray(perms, np.int32)
        tel = self.telemetry is not None
        t_wall = time.perf_counter()
        got = {}

        def done(replies):
            self.last_run = [(s, c) for _, s, c in replies]
            if tel:
                got["buf"] = np.stack([r[0] for r in replies], axis=2)

        self.mesh.pool.post(
            "run", [(self._sid, etas, None if self.schedule.ring else perms,
                     self.mode, tel)] * self.p, done)
        self.epochs_done += n
        if tel:
            self.wait()
            self.telemetry.drain(
                got["buf"], t0=t0, etas=etas, perms=perms, db=self.db,
                transport=self.transport,
                wall_s=time.perf_counter() - t_wall)

    def epoch(self, eta0: float = 0.1):
        self.run_epochs(1, eta0)

    def wait(self):
        """Block until the posted epochs have finished on every worker."""
        self.mesh.pool.flush()
        return self

    # -- elastic-runtime seams (repro_torch.runtime stays out of here) --
    def _rows(self):
        rows = self.mesh.call("get", [(self._sid,)] * self.p)
        return [torch.as_tensor(np.stack([r[i] for r in rows]),
                                device=self.device) for i in range(4)]

    def solver_state(self) -> DSOState:
        """The blocked solver state in block-id order (after every epoch
        worker q holds block q), on the controller's device: what
        ``runtime.snapshot`` persists and ``runtime.reshard`` re-cuts."""
        w, gw, alpha, ga = self._rows()
        return DSOState(w_grid=w, gw_grid=gw, alpha=alpha, ga=ga,
                        epoch=int(self.epochs_done))

    def snapshot_config(self) -> dict:
        """The run record ``runtime.resume`` needs (``solve``'s snapshot
        config)."""
        return dict(backend=self.backend.name, schedule=self.schedule.name,
                    p=self.p, mb=self.mb, db=self.db, m=self.m, d=self.d,
                    loss_name=self.loss_name, reg_name=self.reg_name,
                    lam=float(self.lam), row_batches=self.row_batches,
                    eta0=(0.1 if self.eta0_record is None
                          else float(self.eta0_record)),
                    use_adagrad=bool(self.use_adagrad),
                    eval_every=1, checkpoint_every=0,
                    layout=self.backend.layout, inner_iteration=0,
                    **self._ckpt_extra)

    def restore(self, state: DSOState, key=None, epochs_done=None):
        """Adopt a checkpointed (or resharded) state: send each worker its
        rows and reset the schedule key and epoch cursor, so the next
        ``run_epochs`` continues the stored trajectory."""
        if tuple(state.w_grid.shape) != (self.p, self.db):
            raise ValueError(
                f"state has w grid {tuple(state.w_grid.shape)}, this mesh "
                f"runs a ({self.p}, {self.db}) grid — reshard first "
                f"(repro_torch.runtime.reshard.reshard_state)")
        host = [np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor)
                           else a, np.float32)
                for a in (state.w_grid, state.gw_grid, state.alpha,
                          state.ga)]
        self.mesh.call("set", [(self._sid,) + tuple(a[q] for a in host)
                               for q in range(self.p)])
        if key is not None:
            self.key = _schedule_key(key, self.schedule)
        self.epochs_done = (int(state.epoch) if epochs_done is None
                            else int(epochs_done))

    # -- evaluation helpers --
    def w_full(self) -> torch.Tensor:
        """Global w: after every epoch worker q holds block q, so the rows
        are already in block-id order."""
        return self.solver_state().w_grid.reshape(-1)[: self.d]

    def alpha_full(self) -> torch.Tensor:
        return self.solver_state().alpha.reshape(-1)[: self.m]

    def metrics(self) -> dict:
        st = self.solver_state()
        w = st.w_grid.reshape(-1)[: self.d]
        a = st.alpha.reshape(-1)[: self.m]
        out = dict(epoch=self.epochs_done)
        if isinstance(self.prob, Problem):
            out.update(primal=float(primal_objective(self.prob, w)),
                       gap=float(duality_gap(self.prob, w, a)))
        if self.obs is not None:
            for k, v in out.items():
                if k != "epoch":
                    self.obs.metrics.gauge(f"eval.{k}").set(v)
        return out


def run_dso_sharded(prob: Problem, epochs: int = 10, eta0: float = 0.1,
                    mesh: DSOMesh | None = None, row_batches: int = 1,
                    use_adagrad: bool = True, alpha0: float = 0.0,
                    eval_every: int = 1, impl: str = "jnp",
                    schedule: str = "cyclic", seed: int = 0):
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    opt = ShardedDSO(prob, mesh, row_batches, use_adagrad, alpha0, impl,
                     schedule, seed)
    warn_ragged_eval(epochs, eval_every)
    history = []
    while opt.epochs_done < epochs:
        opt.run_epochs(min(eval_every, epochs - opt.epochs_done), eta0)
        history.append(opt.metrics())
    return opt.w_full(), opt.alpha_full(), history
