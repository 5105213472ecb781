"""libsvm/svmlight text-format reader — the paper's dataset format (Table 2
datasets all ship as libsvm files).

    <label> <index>:<value> <index>:<value> ...   (1-based indices)

Loads into the block-dense ``Problem`` used by the optimizers.  For data
bigger than memory at full density, use the streaming out-of-core ingester
in ``repro_torch.sparse.ingest`` (two passes, CSR shards, never
densifies); this module is the small-data/round-trip path.  Parsing is
numpy on the host, as in the reference; only ``load_libsvm``'s
``Problem`` lives on a torch device (``device``, default the card).

``n_features`` pins the feature dimension explicitly so train/test splits
of the same dataset agree on shape (the libsvm format itself carries no
header; deducing ``d`` from the max index seen *per file* makes the splits
disagree whenever the top feature is absent from one of them).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.saddle import Problem, make_problem

#: losses whose labels must be binary +-1 (square loss is regression and
#: takes arbitrary real targets)
CLASSIFICATION_LOSSES = ("hinge", "logistic")


def normalize_binary_labels(y: np.ndarray, strict: bool = False) -> np.ndarray:
    """Map the common binary label conventions onto {-1, +1}.

    {0, 1} -> {-1, +1};  {1, 2} -> {-1, +1};  {-1, +1} unchanged.
    Any other label set (multiclass, regression targets, typos) is returned
    unchanged when ``strict=False``; with ``strict=True`` it raises a
    ``ValueError`` naming the offending labels instead of silently leaving
    them unnormalized.  The one-class set {1} is ambiguous (it fits all
    three conventions with conflicting signs): ``strict=True`` refuses it,
    ``strict=False`` treats it as already +1.
    """
    y = np.asarray(y, np.float32)
    uniq = set(np.unique(y).tolist())
    if uniq == {1.0}:
        if strict:
            raise ValueError(
                "ambiguous one-class label set {1}: it maps to +1 under "
                "the {0,1} convention but to -1 under {1,2} — a split of "
                "a {1,2} dataset would get the wrong sign. Normalize the "
                "full dataset's labels once, or relabel explicitly")
        return y
    if uniq <= {-1.0, 1.0}:
        return y
    if uniq <= {0.0, 1.0}:
        return 2.0 * y - 1.0
    if uniq <= {1.0, 2.0}:
        return 2.0 * y - 3.0
    if strict:
        raise ValueError(
            f"cannot normalize label set {sorted(uniq)[:10]} to {{-1, +1}}: "
            "binary classification losses need labels in {0,1}, {1,2} or "
            "{-1,+1}; for multiclass data split into one-vs-rest problems, "
            "for regression targets use loss='square'")
    return y


def parse_libsvm(lines, max_rows: int | None = None,
                 max_cols: int | None = None,
                 n_features: int | None = None,
                 normalize_labels: bool = True):
    """Returns (X dense float32 (m, d), y float32 (m,)), numpy.

    ``n_features`` fixes ``d`` explicitly (padding with zero columns when
    the file's max index is smaller, raising ``ValueError`` when a feature
    index exceeds it) so different splits of a dataset agree on shape.
    Without it, ``d`` is deduced from the max index seen in *this* input.
    """
    labels: list[float] = []
    rows: list[list[tuple[int, float]]] = []
    d = 0
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        labels.append(float(parts[0]))
        feats = []
        for tok in parts[1:]:
            idx, val = tok.split(":")
            j = int(idx) - 1
            if j < 0:
                # 0-based files exist in the wild; without this check the
                # entry would silently wrap to the LAST column via numpy
                # negative indexing
                raise ValueError(
                    f"feature index {idx} is not 1-based (libsvm indices "
                    "start at 1); re-export the file with 1-based indices")
            if max_cols is not None and j >= max_cols:
                continue
            feats.append((j, float(val)))
            d = max(d, j + 1)
        rows.append(feats)
        if max_rows is not None and len(rows) >= max_rows:
            break
    if n_features is not None:
        if d > n_features:
            raise ValueError(
                f"feature index {d} exceeds n_features={n_features}; "
                "the file does not fit the declared dimension")
        d = n_features
    m = len(rows)
    X = np.zeros((m, d), np.float32)
    for i, feats in enumerate(rows):
        for j, v in feats:
            X[i, j] = v
    y = np.asarray(labels, np.float32)
    if normalize_labels:
        y = normalize_binary_labels(y, strict=False)
    return X, y


def load_libsvm(path: str, lam: float = 1e-4, loss: str = "hinge",
                reg: str = "l2", max_rows: int | None = None,
                max_cols: int | None = None,
                n_features: int | None = None, *, device="cuda") -> Problem:
    """Load a libsvm file into a dense ``Problem`` on ``device``.

    Classification losses (hinge, logistic) get their labels normalized to
    {-1, +1}; an unexpected label set (multiclass etc.) raises a clear
    ``ValueError`` instead of silently training on unnormalized labels.
    Square loss keeps the raw targets (regression).
    """
    with open(path) as f:
        X, y = parse_libsvm(f, max_rows=max_rows, max_cols=max_cols,
                            n_features=n_features, normalize_labels=False)
    if loss in CLASSIFICATION_LOSSES:
        y = normalize_binary_labels(y, strict=True)
    return make_problem(X, y, lam, loss=loss, reg=reg, device=device)


def dump_libsvm(path: str, X, y) -> None:
    """Writer (round-trip tests + exporting synthetic problems); X and y
    are numpy arrays or tensors.  Values are written with ``:.6g``, so the
    round trip is lossy past 6 significant digits."""
    X, y = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a) for a in (X, y))
    with open(path, "w") as f:
        for i in range(X.shape[0]):
            nz = np.nonzero(X[i])[0]
            feats = " ".join(f"{j + 1}:{X[i, j]:.6g}" for j in nz)
            f.write(f"{y[i]:g} {feats}\n")
