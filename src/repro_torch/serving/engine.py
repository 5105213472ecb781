"""Serving runtime: batched decode against a KV / SSM cache (the port of
``repro.serving.engine``), on one process or over a mesh.

``make_serve_step`` builds the one-token step: ONE new token against a
``seq_len`` cache.  ``DecodeEngine`` is the host-side driver of the
examples: batched requests, token-by-token prefill through the decode
step, greedy or temperature sampling.  The step runs eagerly on the
engine's device (default the card); sampling draws from a seeded
``torch.Generator`` on that device (Gumbel-max, the rule of
``jax.random.categorical``), so its tokens are not the reference's, while
greedy tokens are.

**Over a mesh** (the steps the reference's ``launch.dryrun.build`` jits
for the prefill and decode shapes, written by hand as the train step is,
``training.train.make_sharded_train_step``): ``make_sharded_prefill`` and
``make_sharded_serve_step`` run on every rank of a default process group
of ``mesh.size`` ranks, each with its shards of the parameters
(``dist.tensor_parallel.shard_tree``).  Each rank keeps the rows of its
place on the data axes; the ranks of a ``model`` group run the blocks
together (``models.model.forward`` / ``decode_step`` with ``tp=``, the
SWA and SSD kernels on the rank's heads in the prefill) and gather the
whole padded vocabulary's logits; the MoE routing is the whole batch's
over the data group (``dp=``).  A rank's decode cache is its rows, whole
over ``model`` (``dist.sharding.decode_state_specs_tree``'s layout):
every rank of a model group writes the same rows.
``DecodeEngine(mesh=)`` drives the sharded step: every rank takes the
same requests and returns the same tokens.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpm
from repro_torch.dist.tensor_parallel import SINGLE
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt


def make_serve_step(cfg: ModelConfig, *, seq_len: int, unroll: bool = False):
    """serve_step(params, state, inp, pos[, image_embeds]) -> (logits,
    state) on one process (``make_sharded_serve_step`` over a mesh)."""

    def serve_step(params, state, inp, pos, image_embeds=None):
        return M.decode_step(params, state, inp, pos, cfg, seq_len=seq_len,
                             image_embeds=image_embeds, unroll=unroll)

    return serve_step


def make_sharded_prefill(cfg: ModelConfig, mesh, batch_shapes: dict):
    """The prefill over ``mesh`` for this process's rank (the reference's
    ``jax.jit`` of ``forward(..., last_only=True, remat=False)`` with the
    parameters on ``param_shardings`` and the batch on ``data_specs``).

    ``batch_shapes`` maps each batch key to anything with a ``shape``.
    Returns ``(prefill_fn, param_shardings, batch_shardings)``.
    ``prefill_fn(params, batch)`` takes this rank's shards of the
    parameters and the whole batch, keeps this rank's rows and returns
    their last position's logits over the whole padded vocabulary (rows,
    1, padded_vocab), gathered over ``model``; ``prefill_fn.dp`` is its
    data group.  Every rank must build it, in the same order: it makes
    the groups."""
    p_sh = shd.param_shardings(mesh, M.param_specs(cfg))
    d_sh = shd.data_specs(mesh, batch_shapes)
    dp, tp = tpm.mesh_groups(mesh,
                             next(iter(batch_shapes.values())).shape[0])

    def prefill(params, batch):
        with torch.no_grad():
            logits, _ = M.forward(params, tpm.local_rows(batch, dp), cfg,
                                  remat=False, last_only=True, tp=tp, dp=dp)
            return tp.whole(logits, cfg.padded_vocab)

    prefill.dp = dp
    return prefill, p_sh, d_sh


def make_sharded_serve_step(cfg: ModelConfig, mesh, *, seq_len: int,
                            batch: int):
    """The one-token decode step over ``mesh`` for this process's rank, at
    a batch of ``batch`` rows (the reference's ``jax.jit`` of
    ``make_serve_step`` with the caches on ``decode_state_specs_tree``).

    Returns ``(serve_fn, param_shardings, state_shardings)``:
    ``state_shardings`` puts each cache leaf's rows (dimension 1, after
    the stack of layers) over the data axes and nothing over ``model``.
    ``serve_fn(params, state, inp, pos[, image_embeds])`` takes this
    rank's shards of the parameters, its caches
    (``models.model.init_decode_state`` of ``batch // serve_fn.dp.n``
    rows, the shapes ``state_shardings`` gives) and the whole
    batch's ``inp`` and ``image_embeds``, of which it keeps its rows;
    it updates the caches in place and returns (its rows' logits float32
    (rows, 1, padded_vocab), gathered over ``model``; the caches).
    ``serve_fn.dp`` is its data group.
    Every rank must build it, in the same order: it makes the groups."""
    p_sh = shd.param_shardings(mesh, M.param_specs(cfg))
    rows = shd.batch_spec(mesh, batch)
    state_sh = opt.tree_map(
        lambda t: (None,) + rows + (None,) * (t.dim() - 2),
        M.decode_state_specs(cfg, batch, seq_len))
    dp, tp = tpm.mesh_groups(mesh, batch)

    def serve_step(params, state, inp, pos, image_embeds=None):
        if image_embeds is not None:
            image_embeds = dp.part(image_embeds, batch, 0)
        with torch.no_grad():
            return M.decode_step(params, state, dp.part(inp, batch, 0), pos,
                                 cfg, seq_len=seq_len,
                                 image_embeds=image_embeds, tp=tp, dp=dp)

    serve_step.dp = dp
    return serve_step, p_sh, state_sh


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new: int = 16
    temperature: float = 0.0
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeEngine:
    """Minimal batched decoder (greedy/temperature).  ``params`` must lie
    on ``device``.

    With ``mesh`` the engine runs ``make_sharded_serve_step`` on this
    process's rank of a default process group of ``mesh.size`` ranks:
    ``params`` are the rank's shards (``dist.tensor_parallel.
    shard_tree``), the caches its rows (``batch // dp.n``).
    Every rank must build the engine and run the same requests; each
    step's logits are gathered over the data group before sampling, and
    every rank's generator has the same seed, so every rank returns the
    same tokens.  ``obs`` records on rank 0 only."""

    def __init__(self, cfg: ModelConfig, params, batch: int, seq_len: int,
                 seed: int = 0, obs=None, device="cuda", mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.seq_len = seq_len
        if mesh is None:
            self.step_fn, self.dp = make_serve_step(cfg, seq_len=seq_len), \
                SINGLE
        else:
            import torch.distributed as dist
            self.step_fn, _, _ = make_sharded_serve_step(
                cfg, mesh, seq_len=seq_len, batch=batch)
            self.dp = self.step_fn.dp
            if dist.get_rank() != 0:
                obs = None
        self.state = M.init_decode_state(cfg, batch // self.dp.n, seq_len,
                                         device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # observability seam: each run() is a serve_batch span with
        # request/token counters and a tokens/s gauge (see repro_torch.obs)
        self.obs = obs

    def _step(self, tokens, pos):
        with torch.no_grad():
            logits, self.state = self.step_fn(self.params, self.state,
                                              tokens, pos)
        # (B, vocab): every row of the batch, the TP padding dropped
        logits = self.dp.whole(logits[:, 0], self.batch, 0)
        return logits[:, : self.cfg.vocab]

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
