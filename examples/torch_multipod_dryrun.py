"""Multi-pod launch example: trace internlm2-20b's train step on the
2x16x16 production mesh (a fake process group of 512 ranks, fake tensors,
no device touched) and print the memory and cost analysis: the per-cell
version of ``python -m repro_torch.launch.dryrun --all``.

  PYTHONPATH=src python examples/torch_multipod_dryrun.py [--arch X --shape Y]
"""
import argparse

from repro_torch.launch.dryrun import run_cell
from repro_torch.models.model import RunOptions

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_20b")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args()
    out = run_cell(args.arch, args.shape, multi_pod=True,
                   opts=RunOptions(), save=False)
    if out.get("status") != "ok":
        raise SystemExit(out.get("error") or out.get("skip_reason"))
    r = out["roofline"]
    print(f"{args.arch} x {args.shape} on 2x16x16 ({out['n_chips']} ranks):")
    print(f"  trace: {out['trace_s']:.1f}s; "
          f"per-rank peak mem {out['memory']['peak_bytes_est']/1e9:.2f} GB")
    print(f"  roofline ({out['peaks']} data sheet): compute "
          f"{r['compute_s']*1e3:.1f}ms | memory {r['memory_s']*1e3:.1f}ms | "
          f"collective {r['collective_s']*1e3:.1f}ms  "
          f"-> {r['dominant']}-bound")
    print(f"  collectives: {out['collectives']['by_op']}")
