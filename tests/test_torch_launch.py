"""The port's launch layer (``repro_torch.launch``: specs and the dry run)
against the JAX reference on the CPU, computed in-process; no dry-run
artifact is read.

The abstract specs have the reference's shapes and types, token ids
int64 where the reference's are int32.  The dry run holds the claims
that ``tests/test_dryrun_artifacts.py`` makes of the reference's records:
every pair on both meshes; decode cheaper than train by 10x; dbrx's
active parameters under 0.45 of its total; the SSM and hybrid long_500k
decode per sequence under 10x decode_32k's; a multipod train step
all-reduces over 32 ranks.  Two of its claims cannot be held: the port
compiles nothing, so there is no ``compile_s`` to be positive, and its
collectives are the ones its sharded step makes, priced from the shapes
(the data all-reduce from one device's gradient bytes), not parsed from
HLO.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from test_torch_serve_tp import meta_serve_counts

SHAPES = list(jreg.INPUT_SHAPES)
TOKEN_KEYS = ("tokens", "targets", "inp", "pos")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _ref_flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same(got, want, key):
    assert tuple(got.shape) == tuple(want.shape), key
    assert got.device.type == "meta"
    if want.dtype == jnp.int32:
        assert key.split("/")[-1] in TOKEN_KEYS, key
        assert got.dtype == torch.int64, key
    else:
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), key


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_input_specs_equal_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for name in SHAPES:
        want = jspecs.input_specs(jcfg, jreg.INPUT_SHAPES[name])
        got = tspecs.input_specs(tcfg, treg.INPUT_SHAPES[name])
        assert sorted(got) == sorted(want)
        for part in got:
            if part == "params" and name != SHAPES[0]:
                continue            # the same tree for every shape
            g, w = _flat(got[part]), _ref_flat(want[part])
            if not isinstance(got[part], dict):
                g, w = {part: got[part]}, {part: want[part]}
            assert sorted(g) == sorted(w), (name, part)
            for key in g:
                _same(g[key], w[key], f"{part}/{key}")


@pytest.fixture(scope="module")
def records():
    """(arch, shape, mesh) -> the dry run's record, every pair."""
    return {(a, s, mp): dryrun.run_pair(a, s, multi_pod=mp)
            for a in treg.ARCH_IDS for s in SHAPES for mp in (False, True)}


def test_dryrun_covers_every_pair_on_both_meshes(records):
    assert len(records) == len(treg.ARCH_IDS) * len(SHAPES) * 2
    for (a, s, mp), rec in records.items():
        assert rec["n_devices"] == (512 if mp else 256)
        assert rec["mesh"] == ("2x16x16" if mp else "16x16")
        assert rec["cost"]["flops"] > 0
        assert rec["per_device_bytes"]["params"] <= rec["bytes"]["params"]
        assert {"memory_analysis", "hlo_collectives",
                "compile_s"} <= set(rec["not_computed"])


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_decode_cheaper_than_train(arch, records):
    tr = records[arch, "train_4k", False]["cost"]["flops"]
    de = records[arch, "decode_32k", False]["cost"]["flops"]
    assert de < tr / 10


def test_moe_flops_scale_with_active_params(records):
    rec = records["dbrx-132b", "train_4k", False]
    assert rec["active_params"] < 0.45 * rec["params"]


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_ssm_long_context_constant_state(arch, records):
    d32 = records[arch, "decode_32k", False]["cost"]["flops"]
    d500 = records[arch, "long_500k", False]["cost"]["flops"]
    assert d500 / 1 < d32 / 128 * 10     # per sequence: batch 1 vs 128


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_multipod_train_all_reduces_over_32_ranks(arch, records):
    rec = records[arch, "train_4k", True]
    ar = rec["collectives"]["all-reduce"]
    assert ar["group"] == 32 and ar["axes"] == ["pod", "data"]
    grads = rec["per_device_bytes"]["grads"]   # one device's, under TP
    assert ar["wire_bytes"] == pytest.approx(2 * grads * 31 / 32)
    assert records[arch, "train_4k", False]["collectives"][
        "all-reduce"]["group"] == 16
    dec = records[arch, "decode_32k", True]["collectives"]
    assert "all-reduce" not in dec          # no gradient, no data all-reduce
    step = meta_serve_counts(treg.get_config(arch), (32, 16), 128 // 32,
                             treg.INPUT_SHAPES["decode_32k"].seq_len, True)
    assert {k: dict(count=v["count"], result_bytes=v["result_bytes"])
            for k, v in dec["model"].items()} == step


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_counts(arch, records):
    """``params`` is the config's count, as the reference records it;
    ``param_numel`` the ``meta`` tree's elements.  The two differ (the
    count leaves out the norms, takes the vocab unpadded, and for the
    vlm adds cross layers to ``n_layers``), so each is held to its own
    source."""
    cfg = treg.get_config(arch)
    rec = records[arch, "train_4k", False]
    leaves = _flat(tspecs.param_spec_tree(cfg)).values()
    numel = sum(t.numel() for t in leaves)
    assert rec["params"] == cfg.param_count() == \
        jreg.get_config(arch).param_count()
    assert rec["param_numel"] == numel
    assert rec["bytes"]["params"] == sum(t.numel() * t.element_size()
                                         for t in leaves)
    assert rec["bytes"]["opt_state"] == 8 * numel + 4
    assert rec["active_params"] == cfg.active_param_count()


def test_attended_pairs():
    assert dryrun.attended_pairs(5, 5) == 15
    assert dryrun.attended_pairs(5, 2) == 1 + 2 * 4
    assert dryrun.attended_pairs(3, 100) == 6


def test_dryrun_writes_only_under_out(tmp_path, capsys):
    out = tmp_path / "records"
    dryrun.main(["--arch", "zamba2-7b", "--shape", "train_4k",
                 "--multi-pod", "--out", str(out)])
    files = sorted(p.name for p in out.iterdir())
    assert files == ["zamba2-7b__train_4k__multipod.json"]
    rec = json.loads((out / files[0]).read_text())
    assert rec["arch"] == "zamba2-7b" and rec["n_devices"] == 512
    assert "zamba2-7b train_4k 2x16x16" in capsys.readouterr().out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.data.lm_pipeline import batches
    from repro_torch.examples import lm_train
    from repro_torch.training.train import init_state
    cfg = treg.get_smoke_config("granite-3-8b")
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        next(batches(cfg.vocab, 2, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        lm_train.main(["--steps", "2"])
