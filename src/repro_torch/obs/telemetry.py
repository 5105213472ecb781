"""Device-side telemetry: the host half of the telemetry lane.

With ``engine.solve(telemetry=spec)`` the epoch driver runs its chunk
through ``engine.driver.run_epochs_telemetry``, which fills a
per-(epoch, inner iteration, processor) buffer on the grid's device next
to the update (the port's steps are in place, so the lane copies the
active w blocks and alpha before each inner iteration and reads the new
values after it), and hands it to ``spec.drain`` at every chunk boundary.
The buffer's last axis is ``TELEMETRY_FIELDS``:

  dw_norm      l2 norm of the active w-block update  ||w_new - w_old||
  dalpha_norm  l2 norm of the alpha-shard update     ||a_new - a_old||
  rows         rows of the active (q, blk) tile with any nonzero
  nnz          nonzeros of the active tile (the tile's real work)
  nonfinite    1.0 when any updated leaf (w/alpha/gw/ga) went nonfinite

The buffer carries only what the host cannot recompute; the rest is
priced here at drain time: the per-epoch eta and the bytes each worker
would move per inner iteration (``comm_bytes_matrix``: the ring, p2p and
all-gather wire models of the reference's sharded driver).

Import hygiene: the engine NEVER imports this module (the ``telemetry=``
seam is duck-typed like ``obs=``/``store=``); ``engine.driver`` carries
its own literal copy of ``TELEMETRY_FIELDS`` and a test pins the two (and
the reference's) equal.

Event schema (``obs/__init__.py``): every drain appends one
``type="telemetry", kind="chunk"`` event with the per-epoch (r, q)
matrices; ``attribute_delay`` appends ``kind="delay"``.  ``wall_balance``
/ ``nnz_throughput`` / ``render_heatmap`` fold a spec, or the telemetry
events read back from a JSONL log, into the straggler heatmaps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# Kept literally in sync with repro_torch.engine.driver.TELEMETRY_FIELDS
# (the engine must not import repro_torch.obs — see the module docstring).
TELEMETRY_FIELDS = ("dw_norm", "dalpha_norm", "rows", "nnz", "nonfinite")


def _host(a) -> np.ndarray:
    """Host numpy of a tensor (any device) or an array-like."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class TelemetryChunk(NamedTuple):
    """One drained chunk: the device buffer plus its host-side pricing."""

    t0: int              # global epoch at chunk start
    epochs: int          # n epochs in the chunk
    p: int               # workers (= grid side)
    db: int              # w-block width (comm payload is 2 * 4 * db bytes)
    transport: str       # "ring" | "p2p" | "allgather"
    etas: np.ndarray     # (n,)        effective eta per epoch
    buf: np.ndarray      # (n, p, p, F)  [epoch, inner iter r, worker q, field]
    comm: np.ndarray     # (n, p, p)   bytes worker q moved at iteration r
    wall_s: float | None  # host wall of the chunk (dispatch + sync), if timed


def comm_bytes_matrix(perms, db: int, transport: str) -> np.ndarray:
    """Wire bytes each worker moves per inner iteration, ``(n, p, p)``
    indexed ``[epoch, r, q]`` — the host-side pricing of the chunk's block
    movement under the given transport.

    One travelling block is ``(w, gw)``: ``2 * 4 * db`` float32 bytes.

    ring       — every inner iteration shifts one block to the ring
                 neighbour (one fused ppermute): a flat matrix.
    p2p        — the reference's ``core.dso_dist._p2p_routes``: the move
                 before inner iteration ``r_next`` sends each block from
                 its holder to its consumer; all-identity routes are
                 elided (0 bytes) and identity pairs inside an active
                 route move nothing over the wire.  The end-of-epoch
                 restore (route ``p``) is folded into the last row.
    allgather  — the legacy path gathers all p blocks per fetch:
                 ``p`` travelling payloads per worker per iteration.
    """
    perms = np.asarray(perms)
    if perms.ndim != 3:
        raise ValueError(f"perms must be (n, p, p), got {perms.shape}")
    n, p = perms.shape[0], perms.shape[-1]
    blk = 2 * 4 * db                      # one (w, gw) block, float32
    out = np.zeros((n, p, p), np.float64)
    if transport == "ring":
        out[:] = blk
        return out
    if transport == "allgather":
        # a fetch before every inner iteration plus the end-of-epoch
        # restore, each gathering all p blocks; restore folded into the
        # last row like the p2p model
        out[:] = blk * p
        out[:, p - 1, :] += blk * p
        return out
    if transport != "p2p":
        raise ValueError(f"transport must be 'ring', 'p2p' or 'allgather', "
                         f"got {transport!r}")
    qs = np.arange(p)
    for e in range(n):
        # own[r] = holder map before inner iteration r (epoch-start
        # invariant: device q holds block q); own[p] = after the last
        own = np.concatenate([qs[None, :], perms[e]], axis=0)
        inv = np.argsort(own, axis=-1)    # inv[r, b] = holder of block b
        for r_next in range(p + 1):
            want = perms[e][r_next] if r_next < p else qs
            src = inv[r_next][want]       # src[q] sends to worker q
            if np.array_equal(src, qs):
                continue                  # identity route: elided entirely
            out[e, min(r_next, p - 1)] += np.where(src == qs, 0.0, blk)
    return out


class TelemetrySpec:
    """The duck-typed ``telemetry=`` seam: buffer layout + host drain.

    Thread one spec through ``engine.solve(telemetry=...)``.  The driver
    hands every chunk's device buffer to :meth:`drain`; the spec keeps the
    decoded chunks in
    memory (for the heatmap/test oracles) and, when ``obs`` is bound,
    appends one ``telemetry`` event per drain to the run-event log.
    """

    fields = TELEMETRY_FIELDS

    def __init__(self, obs=None):
        self.obs = obs
        self.chunks: list[TelemetryChunk] = []
        self.delays: list[dict] = []

    # ------------------------------------------------------------ drain --

    def drain(self, buf, *, t0: int, etas, perms, db: int, transport: str,
              wall_s: float | None = None) -> TelemetryChunk:
        """Decode one chunk's device buffer (a tensor on any device, or an
        array; the copy to the host syncs), price
        its communication, remember it, and emit the ``telemetry`` event."""
        buf = _host(buf).astype(np.float32)        # (n, p, p, F)
        if buf.ndim != 4 or buf.shape[-1] != len(self.fields):
            raise ValueError(
                f"telemetry buffer must be (n, p, p, {len(self.fields)}), "
                f"got {buf.shape}")
        etas = np.asarray(etas, np.float32)
        comm = comm_bytes_matrix(_host(perms), db, transport)
        chunk = TelemetryChunk(
            t0=int(t0), epochs=int(buf.shape[0]), p=int(buf.shape[1]),
            db=int(db), transport=str(transport), etas=etas, buf=buf,
            comm=comm, wall_s=None if wall_s is None else float(wall_s))
        self.chunks.append(chunk)
        if self.obs is not None:
            self.obs.record(
                type="telemetry", kind="chunk", t0=chunk.t0,
                epochs=chunk.epochs, p=chunk.p, db=chunk.db,
                transport=chunk.transport, wall_s=chunk.wall_s,
                eta=[float(x) for x in etas],
                nonfinite=int(buf[..., 4].sum()),
                dw_norm=buf[..., 0].tolist(),
                dalpha_norm=buf[..., 1].tolist(),
                rows=buf[..., 2].tolist(),
                nnz=buf[..., 3].tolist(),
                comm_bytes=comm.tolist())
        return chunk

    def attribute_delay(self, worker: int, seconds: float, *,
                        t0: int | None = None, epochs: int = 1):
        """Attribute host wall time to ONE worker (a delay the device
        buffers cannot see, e.g. a straggler's host sleep).  ``t0``/``epochs`` name
        the chunk the delay belongs to (matched against drained chunks by
        ``wall_balance``)."""
        rec = dict(worker=int(worker), seconds=float(seconds),
                   t0=None if t0 is None else int(t0), epochs=int(epochs))
        self.delays.append(rec)
        if self.obs is not None:
            self.obs.record(type="telemetry", kind="delay", **rec)
        return rec

    # -------------------------------------------------------- summaries --

    def nonfinite_total(self) -> int:
        return int(sum(c.buf[..., 4].sum() for c in self.chunks))


# ------------------------------------------------- heatmap construction --


def _chunk_records(source):
    """Normalize a ``TelemetrySpec`` OR an iterable of run-log events into
    (chunk dicts, delay dicts) — both halves of the heatmap input.
    Idempotent on its own output, so a one-shot event generator (e.g.
    ``obs.iter_events``) can be normalized once and folded many times."""
    if (isinstance(source, tuple) and len(source) == 2
            and all(isinstance(x, list) for x in source)):
        return source
    if hasattr(source, "chunks") and hasattr(source, "delays"):
        chunks = [dict(t0=c.t0, epochs=c.epochs, p=c.p, db=c.db,
                       transport=c.transport, wall_s=c.wall_s,
                       eta=np.asarray(c.etas),
                       nnz=c.buf[..., 3], rows=c.buf[..., 2],
                       dw_norm=c.buf[..., 0], dalpha_norm=c.buf[..., 1],
                       nonfinite=float(c.buf[..., 4].sum()),
                       comm_bytes=c.comm)
                  for c in source.chunks]
        delays = [dict(d) for d in source.delays]
        return chunks, delays
    chunks, delays = [], []
    for ev in source:
        if ev.get("type") != "telemetry":
            continue
        if ev.get("kind") == "chunk":
            c = dict(ev)
            for k in ("nnz", "rows", "dw_norm", "dalpha_norm",
                      "comm_bytes", "eta"):
                c[k] = np.asarray(ev[k], np.float64)
            chunks.append(c)
        elif ev.get("kind") == "delay":
            delays.append(dict(ev))
    return chunks, delays


def _select(chunks, p=None, t0_min=0):
    """Filter chunks to one mesh size + epoch window.  A log that spans a
    live reshard mixes p values; with ``p=None`` the dominant size (most
    epochs) wins, so the (p, p) folds below stay well-shaped."""
    chunks = [c for c in chunks if int(c["t0"]) >= int(t0_min)]
    if p is None and chunks:
        epochs_by_p: dict = {}
        for c in chunks:
            epochs_by_p[int(c["p"])] = (epochs_by_p.get(int(c["p"]), 0)
                                        + int(c["epochs"]))
        p = max(epochs_by_p, key=epochs_by_p.get)
    return [c for c in chunks if p is None or int(c["p"]) == int(p)]


def nnz_throughput(source, *, p=None, t0_min=0):
    """Per-(inner iteration r, worker q) nnz-throughput matrix ``(p, p)``
    in nnz/s (falls back to mean nnz per iteration when no chunk carries
    wall time).  Schedule skew — which lpt flattens and cyclic leaves as
    the raw tile pattern — is directly visible here."""
    chunks, _ = _chunk_records(source)
    chunks = _select(chunks, p, t0_min)
    if not chunks:
        return np.zeros((0, 0))
    nnz = np.zeros_like(np.asarray(chunks[0]["nnz"])[0], np.float64)
    wall = 0.0
    for c in chunks:
        nnz += np.asarray(c["nnz"]).sum(axis=0)
        wall += float(c["wall_s"] or 0.0)
    epochs = sum(int(c["epochs"]) for c in chunks)
    return nnz / wall if wall > 0 else nnz / max(epochs, 1)


def wall_balance(source, *, p=None, t0_min=0):
    """Per-worker wall-seconds matrix ``(p, n_chunks)``: each chunk's
    measured wall is split across workers by their nnz share, then every
    ``attribute_delay`` record lands whole on its worker's row for the
    chunk it names — so an injected straggler's row is the argmax even
    though its sleep happens outside the device buffers.

    Returns ``(matrix, chunk_t0s)``.
    """
    chunks, delays = _chunk_records(source)
    chunks = _select(chunks, p, t0_min)
    if not chunks:
        return np.zeros((0, 0)), []
    pw = int(chunks[0]["p"])
    mat = np.zeros((pw, len(chunks)), np.float64)
    for j, c in enumerate(chunks):
        nnz = np.asarray(c["nnz"])                 # (n, p, p): [e, r, q]
        share = nnz.sum(axis=(0, 1))               # per-worker total work
        share = share / max(float(share.sum()), 1e-12)
        mat[:, j] = float(c["wall_s"] or 0.0) * share
        lo, hi = int(c["t0"]), int(c["t0"]) + int(c["epochs"])
        for d in delays:
            w = d.get("worker")
            if w is None or not (0 <= int(w) < pw):
                continue
            dt0 = d.get("t0")
            if dt0 is not None and lo <= int(dt0) < hi:
                mat[int(w), j] += float(d["seconds"])
    return mat, [int(c["t0"]) for c in chunks]


def render_matrix(mat, *, row: str = "q", col: str = "r",
                  col_labels=None, fmt: str = "{:>9.3g}") -> str:
    """Plain-text heatmap: one row per ``row`` index, '*' marks the
    argmax row (by row sum) — readable in a CI log."""
    mat = np.asarray(mat, np.float64)
    if mat.size == 0:
        return "(no telemetry)"
    cols = (list(col_labels) if col_labels is not None
            else list(range(mat.shape[1])))
    head = " ".join(fmt.format(c) if not isinstance(c, str)
                    else f"{c:>9}" for c in cols)
    corner = row + "/" + col
    lines = [f"{corner:>6} " + head]
    hot = int(np.argmax(mat.sum(axis=1)))
    for i in range(mat.shape[0]):
        mark = "*" if i == hot else " "
        lines.append(f"{mark}{i:>5} "
                     + " ".join(fmt.format(v) for v in mat[i]))
    return "\n".join(lines)


def render_heatmap(source, *, p=None, t0_min=0) -> str:
    """The two straggler heatmaps: the per-slot
    nnz-throughput matrix (schedule skew) and the per-worker wall-balance
    matrix (stragglers), both from a spec or a run-event log."""
    source = _chunk_records(source)     # normalize one-shot generators once
    thr = nnz_throughput(source, p=p, t0_min=t0_min)
    bal, t0s = wall_balance(source, p=p, t0_min=t0_min)
    parts = ["per-slot nnz throughput [inner iteration r x worker q]:",
             render_matrix(thr.T if thr.size else thr, row="q", col="r")]
    parts += ["", "wall balance [worker q x chunk] (seconds; '*' = argmax "
              "row — the straggler):",
              render_matrix(bal, row="q", col="t0", col_labels=t0s)]
    if bal.size:
        parts.append(f"argmax worker: {int(np.argmax(bal.sum(axis=1)))}")
    return "\n".join(parts)
