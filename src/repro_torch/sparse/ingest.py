"""Streaming, two-pass, out-of-core libsvm ingestion.

``data.libsvm.parse_libsvm`` densifies to an (m, d) float32 array — memory
O(m*d) — which caps it at toy sizes for the paper's datasets (Table 2:
millions of features at < 1% density).  This module never materializes the
dense matrix; peak memory is O(nnz + m):

  pass 1  ``scan_libsvm``     — count rows, nnz per row, and the max feature
                                index (fixing ``n_features`` for every split
                                of the dataset consistently).
  pass 2  ``iter_csr_shards`` — re-read the file in bounded row shards,
                                parsing straight into exact-size CSR arrays.

``ingest_libsvm`` glues the two passes together into one ``CSRMatrix``
(still O(nnz), no densification); ``sparse.format.sparse_grid_from_csr``
(or ``bucketed_grid_from_csr`` when ``tile_k_skew(stats.k_per_tile)`` is
at or above ``BUCKET_SKEW_THRESHOLD``) then tiles the CSR onto the p x p
grid on the device.  Both passes are numpy on the host, as in the
reference; the CSR arrays equal the reference's array for array.

Labels stay raw by default (regression targets must survive untouched and
per-shard normalization would be unsound — see ``iter_csr_shards``);
classification callers opt in with ``ingest_libsvm(...,
normalize_labels=True)``, which applies ``data.libsvm.
normalize_binary_labels`` once over the full label vector.

Malformed input is a policy, not a crash: both passes share ONE row parser
(``_parse_row``), so the ``on_malformed`` policy — ``"error"`` (default,
raise ``MalformedLine``), ``"skip"`` (drop and count), ``"quarantine"``
(drop, count, and append the raw line to a sidecar file, written in pass 1
only) — makes identical keep/drop decisions in pass 1 and pass 2; the drop
count is surfaced in ``ScanStats.malformed`` and cross-checked between the
passes.  A file truncated (or otherwise mutated) between the passes is
detected by the pass-1 vs pass-2 row/nnz totals and fails loudly.

``obs=`` takes a run recorder (``repro_torch.obs.RunRecorder``): the two
passes appear as ``ingest_pass1``/``ingest_pass2`` spans and their totals
in the ``ingest.rows``/``ingest.nnz``/``ingest.malformed``/
``ingest.quarantined`` counters, as in the reference; ``None`` records
nothing.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np

from repro_torch.sparse.format import CSRMatrix, pad_to_multiple


class ScanStats(NamedTuple):
    """Pass-1 result: everything needed to preallocate the CSR exactly,
    plus (when a grid size ``p`` was given) the per-tile packed-width
    statistics that drive the ``impl="auto"`` layout decision."""

    n_rows: int
    n_features: int      # max feature index seen (1-based count)
    nnz: int
    row_nnz: np.ndarray  # (n_rows,) int64
    #: (p, p) max row nnz within each grid tile — identical to the value
    #: ``sparse_grid_from_csr`` computes, recorded during pass 1 so the
    #: ``impl="auto"`` skew decision (``format.tile_k_skew``) needs no
    #: third pass over the data; None when ``p`` was not given
    k_per_tile: np.ndarray | None = None
    #: lines dropped by the on_malformed="skip"/"quarantine" policy
    malformed: int = 0


class MalformedLine(ValueError):
    """A libsvm line that cannot be parsed: bad ``index:value`` token,
    non-numeric label/value, 0-based or non-ascending indices, or an index
    beyond the declared ``n_features``."""


_POLICIES = ("error", "skip", "quarantine")


def _open_lines(source):
    """Paths open lazily; iterables (tests) pass through."""
    if isinstance(source, (str, bytes, os.PathLike)):
        return open(source)
    return source


def _split_line(line: str):
    """(label_token, feature_tokens) or None for blanks/comments."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    parts = line.split()
    return parts[0], parts[1:]


def _parse_row(lab: str, toks, n_features: int | None = None):
    """``(label, [(0-based index, value), ...])`` with every structural
    check applied — the ONE row parser both ingest passes share, so the
    malformed-line policy makes identical keep/drop decisions in pass 1
    and pass 2 (a divergence there would silently misalign the
    preallocated CSR)."""
    try:
        label = float(lab)
    except ValueError as e:
        raise MalformedLine(f"label {lab!r} is not numeric") from e
    pairs = []
    prev_j = -1
    for tok in toks:
        idx, sep, val = tok.partition(":")
        if not sep:
            raise MalformedLine(f"token {tok!r} is not index:value")
        try:
            j = int(idx) - 1
            v = float(val)
        except ValueError as e:
            raise MalformedLine(f"token {tok!r} is not index:value") from e
        if j < 0:
            raise MalformedLine(
                f"feature index {idx} is not 1-based (libsvm indices "
                "start at 1)")
        if n_features is not None and j >= n_features:
            raise MalformedLine(
                f"feature index {j + 1} exceeds n_features={n_features}")
        if j <= prev_j:
            raise MalformedLine(
                f"libsvm row has non-ascending feature index {j + 1} "
                "(CSR tiling requires sorted rows)")
        prev_j = j
        pairs.append((j, v))
    return label, pairs


def _obs_scan_stats(obs, stats: ScanStats, *, quarantined: bool) -> None:
    """Fold one pass-1 result into the obs counters (rows scanned,
    malformed/quarantined drops, nonzeros kept)."""
    obs.metrics.counter("ingest.rows").inc(stats.n_rows)
    obs.metrics.counter("ingest.nnz").inc(stats.nnz)
    if stats.malformed:
        obs.metrics.counter("ingest.malformed").inc(stats.malformed)
        if quarantined:
            obs.metrics.counter("ingest.quarantined").inc(stats.malformed)


def scan_libsvm(source, max_rows: int | None = None,
                n_features: int | None = None, p: int | None = None,
                on_malformed: str = "error",
                quarantine_path: str | None = None,
                obs=None) -> ScanStats:
    """Pass 1: counts only — O(m) memory, no indices or values stored.

    With a grid size ``p`` (which requires ``n_features``: block column
    boundaries are ``d_pad / p`` and cannot be fixed mid-stream from a
    still-growing max index), additionally records each row's per-block
    nonzero counts (O(m * p) memory) and folds them into the (p, p)
    ``k_per_tile`` statistic — exactly the per-tile packed widths the grid
    tilers compute, available before any grid is built.

    ``on_malformed`` — "error" raises ``MalformedLine`` on the first bad
    row; "skip" drops it (counted in ``ScanStats.malformed``);
    "quarantine" additionally appends the raw line to ``quarantine_path``
    (required with that policy) for forensics.  Dropped lines never count
    toward ``max_rows``, matching pass 2's decisions exactly.

    ``obs`` — optional run recorder: the pass is timed as an
    ``ingest_pass1`` span and the totals land in the ``ingest.rows`` /
    ``ingest.nnz`` / ``ingest.malformed`` / ``ingest.quarantined``
    counters.
    """
    if on_malformed not in _POLICIES:
        raise ValueError(f"on_malformed {on_malformed!r}: {_POLICIES}")
    if on_malformed == "quarantine" and quarantine_path is None:
        raise ValueError("on_malformed='quarantine' needs quarantine_path "
                         "(where to write the dropped lines)")
    if p is not None and n_features is None:
        raise ValueError(
            "per-tile stats (p=...) need an explicit n_features: the block "
            "boundaries d_pad/p cannot be fixed while the max feature "
            "index is still being discovered")
    db = pad_to_multiple(n_features, p) // p if p is not None else None
    row_nnz: list[int] = []
    # per-row per-block counts in one geometrically grown (cap, p) int32
    # buffer — the pass-1 contract is O(m) memory, so no per-row ndarray
    # objects (their overhead would dwarf the 4*p payload at libsvm scale)
    row_blocks = np.zeros((1024, p), np.int32) if p is not None else None
    d = 0
    malformed = 0
    qf = None
    span = obs.span("ingest_pass1") if obs is not None else None
    if span is not None:
        span.__enter__()
    f = _open_lines(source)
    try:
        for line in f:
            parsed = _split_line(line)
            if parsed is None:
                continue
            lab, toks = parsed
            try:
                _, pairs = _parse_row(lab, toks, n_features)
            except MalformedLine:
                if on_malformed == "error":
                    raise
                malformed += 1
                if on_malformed == "quarantine":
                    if qf is None:
                        qf = open(quarantine_path, "w")
                    qf.write(line if line.endswith("\n") else line + "\n")
                continue
            k = 0
            if p is not None:
                if len(row_nnz) >= row_blocks.shape[0]:
                    row_blocks = np.concatenate(
                        [row_blocks, np.zeros_like(row_blocks)])
                blk_counts = row_blocks[len(row_nnz)]
            for j, v in pairs:
                d = max(d, j + 1)
                # explicit zeros are not nonzeros: the dense path's
                # statistics come from X != 0, and Eq. (8)'s scalings
                # must agree between the two layouts
                if v != 0.0:
                    k += 1
                    if p is not None:
                        blk_counts[j // db] += 1
            row_nnz.append(k)
            if max_rows is not None and len(row_nnz) >= max_rows:
                break
    finally:
        if hasattr(f, "close") and f is not source:
            f.close()
        if qf is not None:
            qf.close()
    rn = np.asarray(row_nnz, np.int64)
    k_per_tile = None
    if p is not None:
        # shard boundaries need the final row count: fold the recorded
        # per-row block counts into per-tile maxima now
        m = len(row_nnz)
        mb = pad_to_multiple(m, p) // p
        k_per_tile = np.zeros((p, p), np.int64)
        for q in range(p):
            shard = row_blocks[q * mb:min((q + 1) * mb, m)]
            if shard.size:
                k_per_tile[q] = shard.max(axis=0)
    stats = ScanStats(n_rows=len(row_nnz), n_features=d,
                      nnz=int(rn.sum()), row_nnz=rn, k_per_tile=k_per_tile,
                      malformed=malformed)
    if span is not None:
        span.__exit__(None, None, None)
        _obs_scan_stats(obs, stats,
                        quarantined=on_malformed == "quarantine")
    return stats


def iter_csr_shards(source, n_features: int, shard_rows: int = 8192,
                    max_rows: int | None = None,
                    on_malformed: str = "error",
                    counters: dict | None = None,
                    ) -> Iterator[tuple[CSRMatrix, np.ndarray]]:
    """Single streaming pass yielding (CSR shard, *raw* label shard) pairs
    of at most ``shard_rows`` rows each.  ``n_features`` must be known up
    front (pass 1, or an explicit dataset-wide value shared by every
    split); an index beyond it raises ``ValueError``.

    Labels are deliberately NOT normalized here: the {0,1}/{1,2} -> +-1
    mapping depends on the *full* label set, and a shard that happens to
    contain one class would pick a different convention than its
    neighbours, sign-flipping a whole shard.  Normalize once over the
    assembled vector (``ingest_libsvm`` / ``normalize_binary_labels``).

    ``on_malformed`` — "error" (default) or "skip"/"quarantine", which
    both just drop bad rows here (the quarantine FILE is pass 1's job —
    writing it twice would duplicate every line).  Drops are tallied into
    ``counters["malformed"]`` when a dict is passed, so ``ingest_libsvm``
    can cross-check the two passes made identical decisions.
    """
    if on_malformed not in _POLICIES:
        raise ValueError(f"on_malformed {on_malformed!r}: {_POLICIES}")
    indptr = [0]
    indices: list[int] = []
    values: list[float] = []
    labels: list[float] = []
    rows_emitted = 0

    def _flush():
        nonlocal indptr, indices, values, labels
        shard = CSRMatrix(
            indptr=np.asarray(indptr, np.int64),
            indices=np.asarray(indices, np.int32),
            values=np.asarray(values, np.float32),
            shape=(len(labels), n_features))
        y = np.asarray(labels, np.float32)
        indptr, indices, values, labels = [0], [], [], []
        return shard, y

    f = _open_lines(source)
    try:
        for line in f:
            parsed = _split_line(line)
            if parsed is None:
                continue
            lab, toks = parsed
            try:
                label, pairs = _parse_row(lab, toks, n_features)
            except MalformedLine:
                if on_malformed == "error":
                    raise
                if counters is not None:
                    counters["malformed"] = counters.get("malformed", 0) + 1
                continue
            labels.append(label)
            for j, v in pairs:
                if v == 0.0:
                    continue   # explicit zero: not a nonzero (see pass 1)
                indices.append(j)
                values.append(v)
            indptr.append(len(indices))
            rows_emitted += 1
            if len(labels) >= shard_rows:
                yield _flush()
            if max_rows is not None and rows_emitted >= max_rows:
                break
    finally:
        if hasattr(f, "close") and f is not source:
            f.close()
    if labels:
        yield _flush()


def ingest_libsvm(path: str, n_features: int | None = None,
                  shard_rows: int = 8192, max_rows: int | None = None,
                  normalize_labels: bool = False, p: int | None = None,
                  return_stats: bool = False, on_malformed: str = "error",
                  quarantine_path: str | None = None, obs=None):
    """Two-pass out-of-core ingest: returns (CSRMatrix, labels), numpy.

    Pass 1 fixes the exact allocation (rows, nnz) and, when ``n_features``
    is not given, the feature dimension; pass 2 streams shards straight
    into the preallocated CSR arrays.  Peak memory O(nnz + m) — the dense
    (m, d) matrix is never materialized.

    A grid size ``p`` (requires ``n_features``) makes pass 1 also record
    the (p, p) per-tile ``k_per_tile`` widths, so ``impl="auto"`` can run
    the ``format.tile_k_skew`` bucketing decision without a third pass
    over the data; ``return_stats=True`` returns ``(csr, y, ScanStats)``.

    Labels default to raw (regression / ``loss='square'`` must keep its
    targets, mirroring ``load_libsvm``); classification callers pass
    ``normalize_labels=True`` (applied once over the full vector) or call
    ``normalize_binary_labels(y, strict=True)`` themselves for the loud
    version.

    ``on_malformed`` — "error" (default) / "skip" / "quarantine" (bad
    lines appended to ``quarantine_path``, defaulting to
    ``<path>.quarantine``); dropped-line counts are in
    ``ScanStats.malformed`` (``return_stats=True``) and the two passes'
    decisions are cross-checked, so a file mutated mid-ingest still fails
    loudly instead of writing misaligned data.

    ``obs`` — optional run recorder: the two passes appear as
    ``ingest_pass1``/``ingest_pass2`` spans with row/nnz/malformed/
    quarantined counters (see ``repro_torch.obs``).
    """
    if not isinstance(path, (str, bytes, os.PathLike)):
        raise TypeError(
            "ingest_libsvm makes two passes and needs a re-readable path; "
            "for an in-memory iterable use scan_libsvm + iter_csr_shards "
            "(the iterable would be exhausted by pass 1)")
    if on_malformed == "quarantine" and quarantine_path is None:
        quarantine_path = os.fspath(path) + ".quarantine"
    stats = scan_libsvm(path, max_rows=max_rows, n_features=n_features,
                        p=p, on_malformed=on_malformed,
                        quarantine_path=quarantine_path, obs=obs)
    if n_features is None:
        n_features = stats.n_features
    elif stats.n_features > n_features:
        raise ValueError(
            f"file has feature index {stats.n_features} > "
            f"n_features={n_features}")

    indptr = np.zeros(stats.n_rows + 1, np.int64)
    np.cumsum(stats.row_nnz, out=indptr[1:])
    indices = np.empty(stats.nnz, np.int32)
    values = np.empty(stats.nnz, np.float32)
    y = np.empty(stats.n_rows, np.float32)

    row = 0
    counters: dict = {}
    # pass 2 re-applies the same drop decisions ("skip" even under
    # quarantine: pass 1 already wrote the sidecar file); one span covers
    # the whole shard drain — per-shard events would drown the log
    span = obs.span("ingest_pass2", shard_rows=shard_rows) \
        if obs is not None else None
    if span is not None:
        span.__enter__()
    pass2_policy = "error" if on_malformed == "error" else "skip"
    for shard, ys in iter_csr_shards(path, n_features,
                                     shard_rows=shard_rows,
                                     max_rows=max_rows,
                                     on_malformed=pass2_policy,
                                     counters=counters):
        r, z = shard.m, shard.nnz
        lo = indptr[row]
        if row + r > stats.n_rows or z != indptr[row + r] - lo:
            raise ValueError(
                "file changed between the two ingest passes (pass-2 shard "
                f"at row {row} has {z} nonzeros, pass-1 counted "
                f"{int(indptr[min(row + r, stats.n_rows)] - lo)}); "
                "re-run on a quiescent file")
        indices[lo:lo + z] = shard.indices
        values[lo:lo + z] = shard.values
        y[row:row + r] = ys
        row += r
    if span is not None:
        span.__exit__(None, None, None)
    if row != stats.n_rows:
        raise ValueError(
            f"file changed between the two ingest passes (pass 2 saw "
            f"{row} rows, pass 1 counted {stats.n_rows}) — the file was "
            f"truncated or mutated mid-ingest; re-run on a quiescent copy")
    if counters.get("malformed", 0) != stats.malformed:
        raise ValueError(
            f"file changed between the two ingest passes (pass 2 dropped "
            f"{counters.get('malformed', 0)} malformed line(s), pass 1 "
            f"counted {stats.malformed})")

    if normalize_labels:
        # function-local import, as the reference's: data.libsvm imports
        # core.saddle, and importing it here (not at module scope) keeps
        # the package import order acyclic whichever side loads first
        from repro_torch.data.libsvm import normalize_binary_labels
        # strict: the caller asked for +-1 labels (classification), so an
        # un-normalizable set must fail loudly, matching load_libsvm
        y = normalize_binary_labels(y, strict=True)
    csr = CSRMatrix(indptr=indptr, indices=indices, values=values,
                    shape=(stats.n_rows, n_features))
    if return_stats:
        return csr, y, stats
    return csr, y


def csr_primal_objective(csr: CSRMatrix, y, w, lam: float,
                         loss: str = "hinge", reg: str = "l2", *,
                         device="cuda") -> float:
    """P(w) evaluated through a chunked CSR matvec on ``device`` — no
    densification.

    One-shot convenience over ``engine.evaluate.make_csr_primal_eval``;
    callers evaluating repeatedly (e.g. an eval loop over epochs) should
    build the hook once and reuse it, so the CSR stream moves to the
    device a single time.
    """
    # function-local import: the engine imports sparse.format at module
    # level, so importing it here keeps the package import order acyclic
    from repro_torch.engine.evaluate import make_csr_primal_eval
    return float(make_csr_primal_eval(csr, y, lam, loss, reg,
                                      device=device).primal(w))
