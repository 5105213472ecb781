"""Serve a small model with batched requests through the decode engine.

    python -m repro_torch.examples.serve_demo [--arch mamba2-370m]
        [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.model import init_params
from repro_torch.serving.engine import DecodeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain PyTorch "
                         "path)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    params = init_params(0, cfg, device=args.device)
    eng = DecodeEngine(cfg, params, batch=args.requests, seq_len=256,
                       device=args.device)
    rng_prompts = [[(7 * i + j) % cfg.vocab for j in range(3 + i)]
                   for i in range(args.requests)]
    reqs = [Request(prompt=p, max_new=args.max_new,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i, p in enumerate(rng_prompts)]
    t0 = time.time()
    done = eng.run(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in done)
    for i, r in enumerate(done):
        print(f"req{i} prompt={r.prompt} -> {r.out}")
    print(f"{total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / dt:.1f} tok/s, batch={args.requests})")
    return done


if __name__ == "__main__":
    main()
