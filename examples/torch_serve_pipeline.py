"""Serve LM *pipelines* (DAGs over the assigned architectures) on the
emulated 16-host cluster, scheduled by ESG vs a baseline (PyTorch port).

The paper's end-to-end scenario with the model zoo as the serverless
functions.  Host only: no model runs.  The per-arch latency lattices
come from the roofline model at the peaks of the card (the default,
``cuda``), or of the H100 data sheet with ``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_pipeline.py [--device cpu]
"""
import argparse

import torch

from repro_torch.cluster.gpu_profiles import zoo_tables
from repro_torch.launch import serve
from repro_torch.launch.roofline import device_peaks
from repro_torch.models.model import resolve_device

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="whose peaks the profiles use (default: cuda, the "
                         "card's; 'cpu': the H100 data sheet's)")
    dev = resolve_device(ap.parse_args().device)
    tables = zoo_tables(peaks=device_peaks(torch.cuda.get_device_name(dev))
                        if dev.type == "cuda" else None)
    print("workflows:", {k: [s.split(':')[1] for s in v.stages]
                         for k, v in serve.ZOO_APPS.items()})
    for setting in ("strict-light", "relaxed-heavy"):
        print(f"--- {setting} ---")
        esg = serve.emulate(setting=setting, n=150, scheduler="esg",
                            tables=tables)
        inf = serve.emulate(setting=setting, n=150, scheduler="infless",
                            tables=tables)
        gain = esg["slo_hit_rate"] - inf["slo_hit_rate"]
        save = (inf["total_cost"] / esg["total_cost"] - 1) * 100
        print(f"    ESG vs INFless: hit {gain:+.2f}, cost saving {save:.0f}%")
