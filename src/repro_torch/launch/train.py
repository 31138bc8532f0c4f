"""Training launcher CLI.

Trains on the card by default (full configuration, bf16 parameters);
``--reduced`` takes the arch's tiny same-family config and ``--device
cpu`` runs on the CPU, in float32.  The loop is ``runtime.Trainer``:
checkpoint/restart and deterministic data replay.

  PYTHONPATH=src python -m repro_torch.launch.train --reduced \
      --device cpu --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --steps 8
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the arch's tiny same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, bf16 parameters; "
                         "'cpu' to run there, in float32)")
    args = ap.parse_args(argv)
    # before CUDA initialises: the trainer runs deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import RunOptions, resolve_device
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                                total_steps=args.steps,
                                compress_grads=args.compress_grads)
    opts = RunOptions(remat="none", param_dtype=dtype, act_dtype=dtype)
    out = Trainer(cfg, data_cfg, tcfg, opts, opt_cfg=opt_cfg,
                  device=dev).run()
    loss = out["final_loss"]        # None when resumed at the last step
    print(f"[train] done: {out['steps_run']} steps, final loss "
          + ("none" if loss is None else f"{loss:.4f}"))
    return out


if __name__ == "__main__":
    main()
