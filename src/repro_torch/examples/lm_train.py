"""Train a small LM (any of the ten architectures at its smoke config) for
a few hundred steps on the Markov corpus, with checkpoints.

    python -m repro_torch.examples.lm_train --arch granite-3-8b --steps 200
        [--device cpu|cuda]

The last line says ``LEARNED`` when the final loss is 0.3 nats below the
uniform entropy, else ``check``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain PyTorch "
                         "path)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.lm_pipeline import batches
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train import train_loop

    cfg = get_smoke_config(args.arch)
    ocfg = AdamWConfig(lr=2e-3, warmup_steps=20, total_steps=args.steps)
    kw = {}
    if cfg.inputs_embeds:
        kw["embeds_dim"] = cfg.d_model
    if cfg.arch_type == "vlm":
        kw["image_tokens"] = cfg.n_image_tokens
        kw["d_model"] = cfg.d_model
    raw = batches(cfg.vocab, args.batch, args.seq, seed=0,
                  device=args.device, **kw)

    def it():
        for b in raw:
            if not cfg.inputs_embeds:
                b["tokens"] = b["targets"]
            yield b

    state, hist = train_loop(cfg, ocfg, it(), steps=args.steps,
                             log_every=max(1, args.steps // 20),
                             checkpoint_dir=args.ckpt_dir,
                             checkpoint_every=max(10, args.steps // 2),
                             remat=False, device=args.device)
    uniform = float(np.log(cfg.vocab))
    for h in hist:
        print(f"step {h['step']:4d}  loss={h['loss']:.4f}  "
              f"lr={h['lr']:.2e}  wall={h['wall']:.0f}s")
    print(f"uniform-entropy baseline: {uniform:.4f}")
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"({'LEARNED' if hist[-1]['loss'] < uniform - 0.3 else 'check'})")
    return hist


if __name__ == "__main__":
    main()
