"""Token pipeline for LM training: synthetic corpora with learnable
structure (the port of ``repro.data.lm_pipeline``).

Markov-chain token streams (so a real model can drive the loss well below
the uniform entropy), packed into fixed-length sequences with next-token
targets.  The draws are numpy's, the reference's for the same seed; each
batch becomes tensors on the caller's device: int64 tokens and targets
(the reference's are int32), float32 ``embeds`` and ``image_embeds``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class MarkovCorpus:
    """Order-1 Markov chain over ``vocab`` with sparse transitions."""

    def __init__(self, vocab: int, branching: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.next_tokens = rng.integers(0, vocab, size=(vocab, branching))
        probs = rng.dirichlet(np.ones(branching) * 0.5, size=vocab)
        self.probs = probs
        self.rng = rng

    def sample(self, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        tok = int(self.rng.integers(0, self.vocab))
        for i in range(length):
            out[i] = tok
            j = self.rng.choice(self.probs.shape[1], p=self.probs[tok])
            tok = int(self.next_tokens[tok, j])
        return out


def batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
            embeds_dim: int | None = None, image_tokens: int | None = None,
            d_model: int | None = None, device="cuda"):
    """Infinite iterator of training batches for any arch family, on
    ``device`` (default the card)."""
    dev = resolve_device(device)
    corpus = MarkovCorpus(vocab, seed=seed)
    rng = np.random.default_rng(seed + 1)
    on = lambda a, dtype: torch.from_numpy(a).to(  # noqa: E731
        device=dev, dtype=dtype)
    while True:
        toks = np.stack([corpus.sample(seq) for _ in range(batch)])
        b = {"targets": on(toks, torch.int64)}
        if embeds_dim is not None:
            # audio stub: frame embeddings carry the token identity noisily
            table = _embed_table(vocab, embeds_dim, seed)
            emb = table[toks] + 0.01 * rng.normal(
                0, 1, (batch, seq, embeds_dim)).astype(np.float32)
            b["embeds"] = on(emb.astype(np.float32), torch.float32)
        else:
            b["tokens"] = on(toks, torch.int64)
        if image_tokens is not None:
            b["image_embeds"] = on(rng.normal(
                0, 1, (batch, image_tokens, d_model)).astype(np.float32),
                torch.float32)
        yield b


_TABLES: dict = {}


def _embed_table(vocab, dim, seed):
    key = (vocab, dim, seed)
    if key not in _TABLES:
        rng = np.random.default_rng(seed + 7)
        _TABLES[key] = rng.normal(0, 1, (vocab, dim)).astype(np.float32)
    return _TABLES[key]
