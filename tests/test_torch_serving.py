"""The port's serving path (``repro_torch.serving.engine``) against the
JAX reference's engine on the CPU, at the smoke configs in float32.

- Greedy tokens equal the reference engine's, token for token, on the
  reference's weights (``params_from_reference``): the same batching,
  token-by-token prefill and decode.
- Temperature sampling draws from a seeded ``torch.Generator`` (not
  ``jax.random``): its tokens repeat under a seed.
- ``obs=`` records the ``serve_batch`` span, the ``serve.requests`` and
  ``serve.tokens`` counters and the ``serve.tokens_per_s`` gauge.
- ``python -m repro_torch.examples.serve_demo --device cpu`` runs; without
  ``device=`` the engine asks for the card and raises here.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jsmoke
from repro.models.model import init_params as jinit
from repro.serving import engine as jeng
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_reference
from repro_torch.obs import RunRecorder
from repro_torch.serving.engine import DecodeEngine, Request, make_serve_step

KEY = jax.random.PRNGKey(0)
CPU = "cpu"
PROMPTS = [[1, 2, 3], [4, 5], [9, 8, 7, 6, 5], [11]]


@pytest.fixture(scope="module")
def weights():
    """arch -> (reference params, port params), made once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jp = jinit(KEY, jsmoke(arch))
            cache[arch] = (jp, params_from_reference(
                jax.tree.map(np.asarray, jp), get_smoke_config(arch),
                device=CPU))
        return cache[arch]
    return get


def _requests(max_new=(5, 3, 6, 4), temperature=0.0):
    return [Request(prompt=list(p), max_new=m, temperature=temperature)
            for p, m in zip(PROMPTS, max_new)]


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-370m",
                                  "zamba2-7b"])
def test_greedy_tokens_equal_the_reference_engine(weights, arch):
    jp, tp = weights(arch)
    want = jeng.DecodeEngine(jsmoke(arch), jp, batch=4, seq_len=64).run(
        [jeng.Request(prompt=list(p), max_new=m)
         for p, m in zip(PROMPTS, (5, 3, 6, 4))])
    got = DecodeEngine(get_smoke_config(arch), tp, batch=4, seq_len=64,
                       device=CPU).run(_requests())
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done for r in got)


def test_greedy_with_padding_slots_equals_the_reference(weights):
    """Fewer requests than the batch: the padding slots decode garbage that
    changes no request's tokens."""
    jp, tp = weights("qwen1.5-4b")
    want = jeng.DecodeEngine(jsmoke("qwen1.5-4b"), jp, batch=4,
                             seq_len=32).run([jeng.Request(prompt=[7, 8, 9],
                                                           max_new=6)])
    got = DecodeEngine(get_smoke_config("qwen1.5-4b"), tp, batch=4,
                       seq_len=32, device=CPU).run(
        [Request(prompt=[7, 8, 9], max_new=6)])
    assert got[0].out == want[0].out and len(got[0].out) == 6


def test_engine_completes_requests(weights):
    _, tp = weights("granite-3-8b")
    cfg = get_smoke_config("granite-3-8b")
    done = DecodeEngine(cfg, tp, batch=4, seq_len=128, device=CPU).run(
        [Request(prompt=[1, 2, 3], max_new=5), Request(prompt=[4, 5],
                                                       max_new=3)])
    assert len(done[0].out) == 5 and len(done[1].out) == 3
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)


def test_temperature_sampling_repeats_under_a_seed(weights):
    _, tp = weights("granite-3-8b")
    cfg = get_smoke_config("granite-3-8b")

    def run(seed):
        eng = DecodeEngine(cfg, tp, batch=4, seq_len=64, seed=seed,
                           device=CPU)
        return [r.out for r in eng.run(_requests(temperature=0.8))]
    a, b, c = run(1), run(1), run(2)
    assert a == b
    assert a != c
    assert all(0 <= t < cfg.vocab for r in a for t in r)


def test_mixed_greedy_and_temperature_requests(weights):
    """Greedy rows of a batch that also samples keep the greedy tokens."""
    _, tp = weights("mamba2-370m")
    cfg = get_smoke_config("mamba2-370m")
    greedy = DecodeEngine(cfg, tp, batch=4, seq_len=64, device=CPU).run(
        _requests())
    mixed = _requests()
    for r in mixed[1::2]:
        r.temperature = 0.8
    mixed = DecodeEngine(cfg, tp, batch=4, seq_len=64, device=CPU).run(mixed)
    assert [r.out for r in mixed[0::2]] == [r.out for r in greedy[0::2]]


def test_obs_records_the_span_and_counters(weights):
    _, tp = weights("granite-3-8b")
    rec = RunRecorder()
    eng = DecodeEngine(get_smoke_config("granite-3-8b"), tp, batch=4,
                       seq_len=64, obs=rec, device=CPU)
    done = eng.run(_requests())
    spans = [e for e in rec.events if e["type"] == "span"]
    assert [s["name"] for s in spans] == ["serve_batch"]
    assert spans[0]["attrs"] == {"requests": 4}
    m = rec.metrics
    assert m.counter("serve.requests").value == 4
    assert m.counter("serve.tokens").value == sum(len(r.out) for r in done)
    assert m.gauge("serve.tokens_per_s").value > 0


def test_serve_step_is_decode_step(weights):
    _, tp = weights("zamba2-7b")
    cfg = get_smoke_config("zamba2-7b")
    step = make_serve_step(cfg, seq_len=16)
    tok = torch.tensor([[3], [4]])
    a, _ = step(tp, TM.init_decode_state(cfg, 2, 16, device=CPU), tok, 0)
    b, _ = TM.decode_step(tp, TM.init_decode_state(cfg, 2, 16, device=CPU),
                          tok, 0, cfg, seq_len=16)
    assert torch.equal(a, b)


def test_engine_on_a_ring_buffer_cache(weights):
    """seq_len past full_attn_max: the engine's caches are rings of
    ``sliding_window`` slots, and greedy tokens still match the
    reference's engine."""
    jp, tp = weights("granite-3-8b")
    over = dict(full_attn_max=8, sliding_window=4)
    jcfg = dataclasses.replace(jsmoke("granite-3-8b"), **over)
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"), **over)
    want = jeng.DecodeEngine(jcfg, jp, batch=4, seq_len=32).run(
        [jeng.Request(prompt=list(p), max_new=8) for p in PROMPTS])
    eng = DecodeEngine(cfg, tp, batch=4, seq_len=32, device=CPU)
    assert eng.state["layers"]["k"].shape[2] == 4
    got = eng.run(_requests(max_new=(8, 8, 8, 8)))
    assert [r.out for r in got] == [r.out for r in want]


def test_serve_demo_runs_on_cpu(capsys):
    from repro_torch.examples import serve_demo
    done = serve_demo.main(["--device", "cpu", "--max-new", "4",
                            "--arch", "mamba2-370m"])
    assert [len(r.out) for r in done] == [4, 4, 4, 4]
    out = capsys.readouterr().out
    assert "req3 prompt=" in out and "tok/s" in out


def test_engine_and_demo_default_to_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, tp = weights("granite-3-8b")
    with pytest.raises(RuntimeError, match="cuda"):
        DecodeEngine(get_smoke_config("granite-3-8b"), tp, batch=2,
                     seq_len=16)
    from repro_torch.examples import serve_demo
    with pytest.raises(RuntimeError, match="cuda"):
        serve_demo.main([])
