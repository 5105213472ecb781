"""Serving runtime: batched decode against a KV / SSM cache (the port of
``repro.serving.engine``).

``make_serve_step`` builds the one-token step: ONE new token against a
``seq_len`` cache.  ``DecodeEngine`` is the host-side driver of the
examples: batched requests, token-by-token prefill through the decode
step, greedy or temperature sampling.  The step runs eagerly on the
engine's device (default the card); sampling draws from a seeded
``torch.Generator`` on that device (Gumbel-max, the rule of
``jax.random.categorical``), so its tokens are not the reference's, while
greedy tokens are.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig, *, seq_len: int, unroll: bool = False):
    """serve_step(params, state, inp, pos[, image_embeds]) -> (logits, state)."""

    def serve_step(params, state, inp, pos, image_embeds=None):
        return M.decode_step(params, state, inp, pos, cfg, seq_len=seq_len,
                             image_embeds=image_embeds, unroll=unroll)

    return serve_step


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new: int = 16
    temperature: float = 0.0
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeEngine:
    """Minimal batched decoder (greedy/temperature).  ``params`` must lie
    on ``device``."""

    def __init__(self, cfg: ModelConfig, params, batch: int, seq_len: int,
                 seed: int = 0, obs=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.seq_len = seq_len
        self.state = M.init_decode_state(cfg, batch, seq_len,
                                         device=self.device)
        self.step_fn = make_serve_step(cfg, seq_len=seq_len)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # observability seam: each run() is a serve_batch span with
        # request/token counters and a tokens/s gauge (see repro_torch.obs)
        self.obs = obs

    def _step(self, tokens, pos):
        with torch.no_grad():
            logits, self.state = self.step_fn(self.params, self.state,
                                              tokens, pos)
        return logits[:, 0, : self.cfg.vocab]  # (B, vocab), drop TP padding

    def _tokens(self, column):
        return torch.tensor(column, dtype=torch.int64,
                            device=self.device)[:, None]

    def run(self, requests: list[Request]) -> list[Request]:
        """Prefill token-by-token then decode until every request is done.

        Requests are padded to the engine batch; slots past len(requests)
        decode garbage that is discarded."""
        assert len(requests) <= self.batch
        reqs = list(requests)
        span = (self.obs.span("serve_batch", requests=len(reqs))
                if self.obs is not None else None)
        if span is not None:
            span.__enter__()
            t_serve = time.perf_counter()
        maxp = max(len(r.prompt) for r in reqs)
        pad_id = 0
        cur = [list(r.prompt) for r in reqs] + \
              [[pad_id]] * (self.batch - len(reqs))
        pos = 0
        # prefill (token-by-token through the decode path)
        for t in range(maxp - 1):
            self._step(self._tokens([c[t] if t < len(c) else pad_id
                                     for c in cur]), pos)
            pos += 1
        # decode
        last = self._tokens([c[min(maxp, len(c)) - 1] for c in cur])
        temp = torch.tensor([r.temperature for r in reqs]
                            + [0.0] * (self.batch - len(reqs)),
                            dtype=torch.float32, device=self.device)
        max_new = max(r.max_new for r in reqs)
        for _ in range(max_new):
            logits = self._step(last, pos)
            pos += 1
            greedy = torch.argmax(logits, dim=-1)
            u = torch.rand(logits.shape, generator=self.gen,
                           device=self.device).clamp_min(1e-20)
            gumbel = -torch.log(-torch.log(u))
            sampled = torch.argmax(
                logits / temp.clamp_min(1e-6)[:, None] + gumbel, dim=-1)
            nxt = torch.where(temp > 0, sampled, greedy).tolist()
            for i, r in enumerate(reqs):
                if not r.done and len(r.out) < r.max_new:
                    r.out.append(int(nxt[i]))
                    if len(r.out) >= r.max_new:
                        r.done = True
            last = self._tokens(nxt)
            if all(r.done for r in reqs):
                break
        if span is not None:
            dt = max(time.perf_counter() - t_serve, 1e-12)
            toks = sum(len(r.out) for r in reqs)
            self.obs.metrics.counter("serve.requests").inc(len(reqs))
            self.obs.metrics.counter("serve.tokens").inc(toks)
            self.obs.metrics.gauge("serve.tokens_per_s").set(toks / dt)
            span.__exit__(None, None, None)
        return reqs
