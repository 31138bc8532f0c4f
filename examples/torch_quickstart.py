"""Quickstart (PyTorch port): serve a model through the full control plane
with real compute.

Scenario arrivals enter via the Gateway, ESG_1Q plans batch sizes from a
measured profile lattice, and every dispatched batch runs prefill and
decode on the device through the port's ``TorchExecutor`` (on the card:
full-width InternLM2-1.8B in bf16 with the CUDA flash-attention and
flash-decode kernels; with ``--device cpu``: the reduced config in
float32 on the plain path).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.launch.serve import serve_real
from repro_torch.models.model import resolve_device

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' serves the "
                         "reduced config in float32)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    out = serve_real(arch="internlm2_1_8b", n_requests=24,
                     batches=(1, 2, 4), quotas=(1.0,),
                     gen_len=4, prompt_len=32, reps=1,
                     reduced=not on_card,
                     dtype=torch.bfloat16 if on_card else torch.float32,
                     device=dev)
    ex = out["executor"]
    print(f"served {out['n_requests']} requests: "
          f"executed={ex['executed']} batches, "
          f"cell-cache hit rate={ex['post_warmup_hit_rate']:.2f}, "
          f"predicted-vs-measured err={out['mean_abs_err']:.1%}")
