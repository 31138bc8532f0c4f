"""Train a ~100M-class reduced LM for a few hundred steps with the full
substrate (PyTorch port): deterministic data pipeline, AdamW,
checkpointing + auto-resume.  On the card by default (bf16 parameters);
``--device cpu`` trains in float32 there.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \
      [--device cpu]
"""
import argparse
import dataclasses
import math
import pathlib
import shutil

import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import RunOptions, resolve_device
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig

CKPT_DIR = (pathlib.Path(__file__).resolve().parents[1] / "build"
            / "examples" / "torch_train_lm_ckpt")

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, bf16 parameters; "
                         "'cpu' to train there, in float32)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    # widen the reduced config toward ~100M params
    cfg = dataclasses.replace(
        reduced(get_config("internlm2_1_8b")),
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_head=32,
        d_ff=1024, vocab=8192)
    print(f"training {cfg.name} (reduced): "
          f"{cfg.n_params/1e6:.1f}M params on {dev} ({dtype})")
    if args.fresh:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=100,
                         ckpt_dir=str(CKPT_DIR), log_every=20)
    opts = RunOptions(remat="none", attn_chunk=128, param_dtype=dtype,
                      act_dtype=dtype)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=30,
                                total_steps=args.steps)
    out = Trainer(cfg, data_cfg, tcfg, opts, opt_cfg, device=dev).run()
    loss = out["final_loss"]        # None when resumed at the last step
    print("done: final loss " + ("none" if loss is None else f"{loss:.4f}")
          + f" (uniform floor would be {math.log(cfg.vocab):.2f})")
