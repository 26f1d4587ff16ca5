"""End-to-end training driver, on the card unless ``--device cpu`` is
given: train a reduced-config model for a few hundred steps on the
deterministic synthetic pipeline, with checkpointing and restart.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --arch qwen2-0.5b --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --arch qwen2-0.5b --resume

``--resume`` continues from the newest checkpoint in ``--ckpt-dir``; with
the same ``--steps`` (the schedule's length) it ends where an
uninterrupted run ends.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from ..checkpoint import Checkpointer
from ..configs import ARCHS, reduced_config
from ..configs.base import TrainConfig
from ..data import TokenPipeline
from ..models import api
from ..optim import adamw_init


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Runs the driver; returns {"arch", "device", "start", "steps",
    "resumed_from", "losses" (the printed steps' losses by step),
    "final_loss", "checkpoints"}."""
    args = build_parser().parse_args(argv)
    cfg = reduced_config(ARCHS[args.arch], num_layers=4)
    tcfg = TrainConfig(lr=1e-3, warmup=20, total_steps=args.steps,
                       microbatch=1)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=0)
    step_fn = api.make_train_step(cfg, tcfg)
    params = api.init_model(cfg, seed=0, device=args.device)
    opt = adamw_init(params)
    ck = Checkpointer(args.ckpt_dir)
    start, resumed_from = 0, None
    if args.resume and ck.latest_step() is not None:
        state, meta = ck.restore(template={"params": params, "opt": opt},
                                 device=args.device)
        params, opt = state["params"], state["opt"]
        resumed_from = meta["step"]
        start = resumed_from + 1
        print(f"resumed from step {meta['step']} "
              f"(config hash {meta.get('config')})")

    losses = {}
    t0 = time.time()
    for i in range(start, args.steps):
        b = pipe.global_batch_at(i)
        params, opt, m = step_fn(params, opt,
                                 {"tokens": b["tokens"],
                                  "labels": b["labels"]}, i)
        if i % 20 == 0 or i == args.steps - 1:
            losses[i] = float(m["loss"])
            toks = args.batch * args.seq * (i - start + 1)
            print(f"step {i:4d} loss={losses[i]:.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"lr={float(m['lr']):.2e} "
                  f"tok/s={toks/(time.time()-t0):,.0f}")
        if i and i % args.ckpt_every == 0:
            ck.save(i, {"params": params, "opt": opt},
                    meta={"step": i, "config": cfg.config_hash()})
    ck.wait()
    print("done; checkpoints:", ck.all_steps())
    return {"arch": args.arch, "device": args.device, "start": start,
            "steps": args.steps, "resumed_from": resumed_from,
            "losses": losses,
            "final_loss": losses.get(args.steps - 1),
            "checkpoints": ck.all_steps()}


if __name__ == "__main__":
    main()
