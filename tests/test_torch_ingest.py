"""The port's libsvm reader and out-of-core ingest against the JAX
reference (CPU, small files written from numpy seeds).

``scan_libsvm`` / ``iter_csr_shards`` / ``ingest_libsvm`` give the
reference's ``ScanStats`` (``k_per_tile`` and ``malformed`` included), CSR
arrays, raw and normalised labels and quarantine sidecar bytes, on files
with comments, blank lines, empty rows, explicit zeros and power-law
columns, under every ``on_malformed`` policy; every malformed-line kind
and every error case of the reference's own tests raises the same
exception type; a file changed between the passes is caught; the dense
reader (``parse_libsvm``, ``load_libsvm``, ``normalize_binary_labels``,
``dump_libsvm`` byte for byte) equals the reference; the block-ELL and
K-bucketed grids of an ingested CSR equal the reference's array for
array, and ``run_dso_grid_from_data`` on them is within 1e-5 of the
reference's; ``csr_primal_objective`` within 1e-6 relative; a
scaled-down copy of the reference's never-densifies gate; and the
``obs=`` seam records the reference's spans and counters.
"""

import os

import numpy as np
import pytest
import torch

import repro.data.libsvm as jlib
import repro.sparse.format as jf
import repro.sparse.ingest as jing
import repro_torch.data.libsvm as tlib
import repro_torch.sparse.format as tf
import repro_torch.sparse.ingest as ting
from repro.core.dso import run_dso_grid_from_data as j_from_data
from repro.engine import make_csr_primal_eval as j_primal_eval
from repro_torch.core.dso import run_dso_grid_from_data as t_from_data
from repro_torch.engine import make_csr_primal_eval as t_primal_eval

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _clean_text(seed=0, m=40, d=50, k=6, alpha=1.2):
    """A libsvm file with comments, blank lines, empty rows, explicit
    zeros, power-law columns and {0, 1} labels."""
    rng = np.random.default_rng(seed)
    pop = np.arange(1, d + 1, dtype=np.float64) ** (-alpha)
    pop /= pop.sum()
    lines = ["# a header comment", ""]
    for i in range(m):
        lab = int(rng.random() < 0.5)
        if i % 9 == 4:
            lines.append(f"{lab}")                    # an empty row
            continue
        cols = np.unique(rng.choice(d, size=k, p=pop))
        vals = rng.normal(0, 1, size=cols.size).astype(np.float32)
        if i % 7 == 1:
            vals[0] = 0.0                             # an explicit zero
        lines.append(f"{lab} " + " ".join(f"{j + 1}:{v:.7g}"
                                          for j, v in zip(cols, vals)))
        if i % 11 == 3:
            lines += ["", "# an interior comment"]
    return "\n".join(lines) + "\n"


#: one line of every malformed kind ``_parse_row`` refuses (n_features 50)
MALFORMED = {
    "label": "x 1:1.0",
    "no-colon": "+1 oops",
    "value": "+1 2:abc",
    "index": "+1 b:1.0",
    "descending": "+1 3:1.0 2:2.0",
    "repeated": "+1 3:1.0 3:2.0",
    "zero-based": "+1 0:1.0",
    "too-large": "+1 51:1.0",
}


def _dirty_text(seed=1):
    lines = _clean_text(seed, m=24).splitlines()
    for n, bad in enumerate(MALFORMED.values()):
        lines.insert(3 + 3 * n, bad)
    return "\n".join(lines) + "\n"


def _assert_stats_equal(t, j):
    assert type(t).__name__ == type(j).__name__ == "ScanStats"
    for field in j._fields:
        a, b = getattr(t, field), getattr(j, field)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b) and a.dtype == b.dtype, field
        else:
            assert a == b, field


def _assert_csr_equal(t, j):
    assert t.shape == j.shape
    for field in ("indptr", "indices", "values"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype, field
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), field


@pytest.mark.parametrize("p", [None, 4])
@pytest.mark.parametrize("policy", ["error", "skip", "quarantine"])
@pytest.mark.parametrize("kind", ["clean", "dirty"])
def test_ingest_matches_reference(tmp_path, kind, policy, p):
    text = _clean_text() if kind == "clean" else _dirty_text()
    paths = {side: _write(tmp_path / f"{side}.libsvm", text)
             for side in ("j", "t")}
    kw = dict(n_features=50, p=p, shard_rows=7, on_malformed=policy,
              return_stats=True)
    if kind == "dirty" and policy == "error":
        with pytest.raises(jing.MalformedLine):
            jing.ingest_libsvm(paths["j"], **kw)
        with pytest.raises(ting.MalformedLine):
            ting.ingest_libsvm(paths["t"], **kw)
        return
    j_csr, j_y, j_st = jing.ingest_libsvm(paths["j"], **kw)
    t_csr, t_y, t_st = ting.ingest_libsvm(paths["t"], **kw)
    _assert_stats_equal(t_st, j_st)
    _assert_csr_equal(t_csr, j_csr)
    assert np.array_equal(t_y, j_y) and t_y.dtype == j_y.dtype
    assert set(np.unique(t_y)) == {0.0, 1.0}          # raw labels
    j_n = jing.ingest_libsvm(paths["j"], normalize_labels=True, **kw)[1]
    t_n = ting.ingest_libsvm(paths["t"], normalize_labels=True, **kw)[1]
    assert np.array_equal(t_n, j_n) and set(np.unique(t_n)) == {-1.0, 1.0}
    for side in ("j", "t"):
        assert os.path.exists(paths[side] + ".quarantine") \
            == (policy == "quarantine" and kind == "dirty")
    if policy == "quarantine" and kind == "dirty":
        with open(paths["j"] + ".quarantine", "rb") as fj, \
                open(paths["t"] + ".quarantine", "rb") as ft:
            sidecar = ft.read()
            assert sidecar == fj.read()
        assert sidecar.decode().splitlines() == list(MALFORMED.values())
    scan_kw = dict(n_features=50, p=p, on_malformed="skip")
    _assert_stats_equal(ting.scan_libsvm(paths["t"], **scan_kw),
                        jing.scan_libsvm(paths["j"], **scan_kw))


@pytest.mark.parametrize("shard_rows", [1, 7, 8192])
def test_iter_csr_shards_match_reference(shard_rows):
    lines = _dirty_text().splitlines()
    j_cnt, t_cnt = {}, {}
    j_sh = list(jing.iter_csr_shards(lines, 50, shard_rows=shard_rows,
                                     on_malformed="skip", counters=j_cnt))
    t_sh = list(ting.iter_csr_shards(lines, 50, shard_rows=shard_rows,
                                     on_malformed="skip", counters=t_cnt))
    assert t_cnt == j_cnt == {"malformed": len(MALFORMED)}
    assert len(t_sh) == len(j_sh)
    for (tc, ty), (jc, jy) in zip(t_sh, j_sh):
        _assert_csr_equal(tc, jc)
        assert np.array_equal(ty, jy)
    j_first = next(jing.iter_csr_shards(lines, 50, max_rows=5,
                                        on_malformed="quarantine"))
    t_first = next(ting.iter_csr_shards(lines, 50, max_rows=5,
                                        on_malformed="quarantine"))
    _assert_csr_equal(t_first[0], j_first[0])


@pytest.mark.parametrize("bad", list(MALFORMED), ids=list(MALFORMED))
def test_each_malformed_kind_matches_reference(bad):
    lines = ["+1 1:1.0", MALFORMED[bad], "-1 2:2.0"]
    for mod in (jing, ting):
        with pytest.raises(mod.MalformedLine):
            mod.scan_libsvm(lines, n_features=50)
        with pytest.raises(mod.MalformedLine):
            list(mod.iter_csr_shards(lines, 50))
    _assert_stats_equal(
        ting.scan_libsvm(lines, n_features=50, on_malformed="skip"),
        jing.scan_libsvm(lines, n_features=50, on_malformed="skip"))
    assert issubclass(ting.MalformedLine, ValueError)


def _multi(tmp):
    return _write(os.path.join(tmp, "multi.libsvm"),
                  "1 1:1.0\n2 2:1.0\n3 1:0.5 2:0.5\n")


#: (lib, ing, tmp) -> the call, for every exception the reference's reader
#: and ingest tests raise
ERROR_CASES = {
    "n_features-too-small":
        lambda lib, ing, tmp: lib.parse_libsvm(["+1 5:1.0"], n_features=3),
    "parse-zero-based":
        lambda lib, ing, tmp: lib.parse_libsvm(["+1 0:5.0 3:1.0"]),
    "shards-zero-based":
        lambda lib, ing, tmp: list(ing.iter_csr_shards(["+1 0:5.0 3:1.0"],
                                                       n_features=4)),
    "ingest-iterable":
        lambda lib, ing, tmp: ing.ingest_libsvm(["+1 1:1.0"]),
    "load-multiclass-hinge":
        lambda lib, ing, tmp: lib.load_libsvm(_multi(tmp), loss="hinge"),
    "load-multiclass-logistic":
        lambda lib, ing, tmp: lib.load_libsvm(_multi(tmp), loss="logistic"),
    "strict-multiclass":
        lambda lib, ing, tmp: lib.normalize_binary_labels(
            np.array([1.0, 2.0, 3.0]), strict=True),
    "strict-one-class":
        lambda lib, ing, tmp: lib.normalize_binary_labels(
            np.array([1.0, 1.0]), strict=True),
    "ingest-normalize-multiclass":
        lambda lib, ing, tmp: ing.ingest_libsvm(_multi(tmp),
                                                normalize_labels=True),
    "policy-unknown":
        lambda lib, ing, tmp: ing.scan_libsvm(["+1 1:1.0"],
                                              on_malformed="ignore"),
    "shards-policy-unknown":
        lambda lib, ing, tmp: list(ing.iter_csr_shards(
            ["+1 1:1.0"], 2, on_malformed="ignore")),
    "quarantine-without-path":
        lambda lib, ing, tmp: ing.scan_libsvm(["+1 1:1.0"],
                                              on_malformed="quarantine"),
    "p-without-n_features":
        lambda lib, ing, tmp: ing.scan_libsvm(["+1 1:1.0"], p=2),
    "shards-index-too-large":
        lambda lib, ing, tmp: list(ing.iter_csr_shards(["+1 7:1.0"],
                                                       n_features=3)),
    "shards-unsorted":
        lambda lib, ing, tmp: list(ing.iter_csr_shards(["+1 5:1.0 2:1.0"],
                                                       n_features=8)),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_errors_raise_what_the_reference_raises(tmp_path, case):
    call = ERROR_CASES[case]
    with pytest.raises((TypeError, ValueError)) as j_err:
        call(jlib, jing, str(tmp_path))
    with pytest.raises((TypeError, ValueError)) as t_err:
        call(tlib, ting, str(tmp_path))
    assert type(t_err.value).__name__ == type(j_err.value).__name__
    assert str(t_err.value) == str(j_err.value)


def _stale(mod, kind):
    real = mod.scan_libsvm

    def scan(source, **kw):
        st = real(source, **kw)
        if kind == "nnz":
            rn = st.row_nnz.copy()
            rn[0] += 1
            return st._replace(nnz=st.nnz + 1, row_nnz=rn)
        if kind == "rows":
            return st._replace(n_rows=st.n_rows + 1,
                               row_nnz=np.append(st.row_nnz, 0))
        return st._replace(malformed=st.malformed + 1)

    return scan


@pytest.mark.parametrize("kind,match", [
    ("nnz", "changed between"), ("rows", "truncated or mutated"),
    ("malformed", "changed between.*dropped")])
def test_file_changed_between_passes_is_caught(tmp_path, monkeypatch, kind,
                                               match):
    path = _write(tmp_path / "mut.libsvm", "+1 1:1.0\nbogus\n-1 2:2.0\n")
    monkeypatch.setattr(ting, "scan_libsvm", _stale(ting, kind))
    with pytest.raises(ValueError, match=match):
        ting.ingest_libsvm(path, on_malformed="skip")


@pytest.mark.parametrize("n_features", [None, 64])
@pytest.mark.parametrize("normalize", [True, False])
def test_parse_libsvm_matches_reference(normalize, n_features):
    lines = _clean_text(seed=3).splitlines()
    kw = dict(n_features=n_features, normalize_labels=normalize)
    for extra in ({}, dict(max_rows=10, max_cols=20)):
        Xj, yj = jlib.parse_libsvm(lines, **kw, **extra)
        Xt, yt = tlib.parse_libsvm(lines, **kw, **extra)
        assert np.array_equal(Xt, Xj) and Xt.dtype == Xj.dtype
        assert np.array_equal(yt, yj) and yt.dtype == yj.dtype


@pytest.mark.parametrize("loss,reg", [("hinge", "l2"), ("logistic", "l1"),
                                      ("square", "l1")])
def test_load_libsvm_matches_reference(tmp_path, loss, reg):
    path = _write(tmp_path / "d.libsvm", _clean_text(seed=4))
    kw = dict(lam=1e-3, loss=loss, reg=reg, n_features=64)
    jp = jlib.load_libsvm(path, **kw)
    tp = tlib.load_libsvm(path, **kw, device="cpu")
    for field in ("X", "y", "row_nnz", "col_nnz"):
        assert np.array_equal(_np(getattr(tp, field)),
                              np.asarray(getattr(jp, field))), field
    assert (tp.lam, tp.nnz, tp.loss_name, tp.reg_name) \
        == (jp.lam, jp.nnz, jp.loss_name, jp.reg_name)


LABEL_SETS = [[0.0, 1.0, 0.0], [1.0, 2.0, 2.0], [-1.0, 1.0, -1.0],
              [1.0, 1.0], [0.0], [2.0], [-1.0], [1.0, 2.0, 3.0],
              [0.25, -1.5, 3.0]]


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("labels", LABEL_SETS,
                         ids=[str(s) for s in LABEL_SETS])
def test_normalize_binary_labels_matches_reference(labels, strict):
    y = np.asarray(labels, np.float32)
    try:
        want = jlib.normalize_binary_labels(y, strict=strict)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tlib.normalize_binary_labels(y, strict=strict)
        assert str(got.value) == str(e)
        return
    got = tlib.normalize_binary_labels(y, strict=strict)
    assert np.array_equal(got, np.asarray(want)) and got.dtype == want.dtype


@pytest.mark.parametrize("seed", [0, 1])
def test_dump_libsvm_is_byte_identical(tmp_path, seed):
    X, y = jlib.parse_libsvm(_clean_text(seed=seed).splitlines(),
                             normalize_labels=False)
    X = X * np.float32(1.0 / 3.0)        # values past 6 significant digits
    jlib.dump_libsvm(str(tmp_path / "j.libsvm"), X, y)
    tlib.dump_libsvm(str(tmp_path / "t.libsvm"), X, y)
    tlib.dump_libsvm(str(tmp_path / "tt.libsvm"), torch.from_numpy(X),
                     torch.from_numpy(y))
    ref = (tmp_path / "j.libsvm").read_bytes()
    assert (tmp_path / "t.libsvm").read_bytes() == ref
    assert (tmp_path / "tt.libsvm").read_bytes() == ref


def _ingested(tmp_path, seed=5, m=90, d=70, k=9, alpha=1.3):
    path = _write(tmp_path / "g.libsvm",
                  _clean_text(seed=seed, m=m, d=d, k=k, alpha=alpha))
    kw = dict(n_features=d, p=4, return_stats=True, normalize_labels=True)
    j = jing.ingest_libsvm(path, **kw)
    t = ting.ingest_libsvm(path, **kw)
    _assert_csr_equal(t[0], j[0])
    return j, t


def _assert_fields_equal(t, j):
    assert type(t).__name__ == type(j).__name__
    for field in j._fields:
        a, b = getattr(t, field), getattr(j, field)
        if isinstance(b, tuple):
            assert len(a) == len(b), field
            for k, (x, z) in enumerate(zip(a, b)):
                assert np.array_equal(_np(x), _np(z)), f"{field}[{k}]"
        elif b is None or isinstance(b, (int, float)):
            assert a == b, field
        else:
            assert np.array_equal(_np(a), _np(b)), field
            assert _np(a).dtype == _np(b).dtype, f"{field} dtype"


@pytest.mark.parametrize("row_batches", [1, 3])
@pytest.mark.parametrize("layout", ["sparse", "bucketed"])
def test_grids_of_an_ingested_csr_match_reference(tmp_path, layout,
                                                  row_batches):
    (j_csr, j_y, j_st), (t_csr, t_y, t_st) = _ingested(tmp_path)
    assert np.array_equal(t_st.k_per_tile, tf.csr_k_per_tile(t_csr, 4))
    assert tf.tile_k_skew(t_st.k_per_tile) == jf.tile_k_skew(j_st.k_per_tile)
    j_build = {"sparse": jf.sparse_grid_from_csr,
               "bucketed": jf.bucketed_grid_from_csr}[layout]
    t_build = {"sparse": tf.sparse_grid_from_csr,
               "bucketed": tf.bucketed_grid_from_csr}[layout]
    _assert_fields_equal(t_build(t_csr, t_y, 4, row_batches, device="cpu"),
                         j_build(j_csr, j_y, 4, row_batches))


@pytest.mark.parametrize("layout,backend", [("sparse", "sparse_jnp"),
                                            ("bucketed",
                                             "sparse_bucketed_jnp")])
@pytest.mark.parametrize("loss,reg", [("hinge", "l2"), ("logistic", "l1")])
def test_solve_on_an_ingested_grid_matches_reference(tmp_path, loss, reg,
                                                     layout, backend):
    (j_csr, j_y, _), (t_csr, t_y, _) = _ingested(tmp_path, seed=6)
    j_build = {"sparse": jf.sparse_grid_from_csr,
               "bucketed": jf.bucketed_grid_from_csr}[layout]
    t_build = {"sparse": tf.sparse_grid_from_csr,
               "bucketed": tf.bucketed_grid_from_csr}[layout]
    kw = dict(loss_name=loss, reg_name=reg, lam=1e-3, m=t_csr.m, d=t_csr.d,
              epochs=4, eta0=0.5, impl=backend, eval_every=2,
              alpha0=0.0005 if loss == "logistic" else 0.0)
    wj, aj, hj = j_from_data(j_build(j_csr, j_y, 4), **kw,
                             eval_hook=j_primal_eval(j_csr, j_y, 1e-3, loss,
                                                     reg))
    wt, at, ht = t_from_data(t_build(t_csr, t_y, 4, device="cpu"), **kw,
                             eval_hook=t_primal_eval(t_csr, t_y, 1e-3, loss,
                                                     reg, device="cpu"),
                             device="cpu")
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), **TOL)
    assert [h["epoch"] for h in ht] == [h["epoch"] for h in hj] == [2, 4]
    np.testing.assert_allclose([h["primal"] for h in ht],
                               [h["primal"] for h in hj], **TOL)
    w2, a2 = t_from_data(t_build(t_csr, t_y, 4, device="cpu"),
                         **{k: v for k, v in kw.items()
                            if k != "eval_every"}, device="cpu")
    assert torch.equal(w2, wt) and torch.equal(a2, at)


@pytest.mark.parametrize("loss,reg", [("hinge", "l2"), ("logistic", "l1"),
                                      ("square", "l2")])
def test_csr_primal_objective_matches_reference(tmp_path, loss, reg):
    (j_csr, j_y, _), (t_csr, t_y, _) = _ingested(tmp_path, seed=7)
    w = np.random.default_rng(7).normal(0, 0.3, t_csr.d).astype(np.float32)
    want = jing.csr_primal_objective(j_csr, j_y, w, 1e-3, loss, reg)
    got = ting.csr_primal_objective(t_csr, t_y, w, 1e-3, loss, reg,
                                    device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        ting.csr_primal_objective(t_csr, t_y, torch.from_numpy(w), 1e-3,
                                  loss, reg, device="cpu"), want, rtol=1e-6)


def test_ingest_at_scale_never_densifies(tmp_path):
    """The reference's gate (``tests/test_sparse.py``
    ``test_paper_scale_ingest_never_densifies``) at a fifth of its rows:
    ingest -> CSR -> block-ELL grid -> one epoch, every structure
    nnz-proportional."""
    m, d, k = 20_000, 2000, 10
    rng = np.random.default_rng(5)
    cols = np.sort(np.argsort(rng.random((m, d)), axis=1)[:, :k], axis=1)
    vals = rng.normal(0, 1, (m, k))
    labs = np.where(rng.random(m) < 0.5, 1, -1)
    path = tmp_path / "big.libsvm"
    path.write_text("".join(
        f"{labs[i]} " + " ".join(f"{j + 1}:{v:.4g}"
                                 for j, v in zip(cols[i], vals[i])) + "\n"
        for i in range(m)))
    stats = ting.scan_libsvm(str(path))
    assert stats.n_rows == m and stats.nnz == m * k
    csr, y = ting.ingest_libsvm(path, n_features=d)
    assert csr.shape == (m, d) and csr.nnz == m * k
    dense_bytes = 4 * m * d
    assert csr.indices.nbytes + csr.values.nbytes + csr.indptr.nbytes \
        < dense_bytes / 50
    data = tf.sparse_grid_from_csr(csr, y, p=4, device="cpu")
    assert tf.grid_nbytes(data) < dense_bytes / 10
    w, _ = t_from_data(data, loss_name="hinge", reg_name="l2", lam=1e-4,
                       m=m, d=d, epochs=1, eta0=0.5, impl="jnp",
                       device="cpu")
    assert torch.isfinite(w).all()
    assert ting.csr_primal_objective(csr, y, w, 1e-4, device="cpu") < 1.0


def test_ingest_obs_is_not_ported_yet(tmp_path):
    """Since the obs seam was ported the id is kept for its history: a
    port ``RunRecorder`` and a reference one record the same spans (names,
    order, ``shard_rows``) and counter values for the same file, from
    ``ingest_libsvm`` and ``scan_libsvm`` alike, under "skip" and
    "quarantine"; ``obs=None`` records nothing and changes nothing."""
    from repro.obs import RunRecorder as JRecorder
    from repro_torch.obs import RunRecorder as TRecorder

    def spans(rec):
        return [(e["name"], e.get("attrs", {})) for e in rec.events
                if e["type"] == "span"]

    text = _dirty_text(3)
    for policy in ("skip", "quarantine"):
        recs = {}
        for side, mod, rec in (("j", jing, JRecorder()),
                               ("t", ting, TRecorder())):
            path = _write(tmp_path / f"{side}_{policy}.libsvm", text)
            kw = dict(n_features=50, on_malformed=policy)
            csr, y = mod.ingest_libsvm(path, shard_rows=7, obs=rec, **kw)
            mod.scan_libsvm(path, obs=rec, p=4,
                            quarantine_path=path + ".q2", **kw)
            recs[side] = rec
            if side == "t":
                plain = ting.ingest_libsvm(path, shard_rows=7, **kw)
                _assert_csr_equal(plain[0], csr)
                assert np.array_equal(plain[1], y)
        j, t = recs["j"], recs["t"]
        assert spans(t) == spans(j) == [("ingest_pass1", {}),
                                        ("ingest_pass2", {"shard_rows": 7}),
                                        ("ingest_pass1", {})]
        assert t.metrics.snapshot() == j.metrics.snapshot()
        counters = {k: v["value"] for k, v in t.metrics.snapshot().items()}
        n_bad = len(MALFORMED)
        assert counters["ingest.malformed"] == 2 * n_bad
        assert counters.get("ingest.quarantined", 0) \
            == (2 * n_bad if policy == "quarantine" else 0)


def test_readers_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = _write(tmp_path / "c.libsvm", "+1 1:1.0\n-1 2:1.0\n")
    with pytest.raises(RuntimeError, match="cuda"):
        tlib.load_libsvm(path)
    csr, y = ting.ingest_libsvm(path)
    with pytest.raises(RuntimeError, match="cuda"):
        ting.csr_primal_objective(csr, y, np.zeros(2, np.float32), 1e-3)
