"""Online serving scenarios (PyTorch port) -- demo of the serving stack.

Drives the model-zoo cluster emulation through three scenario/policy
combinations and prints the telemetry each produces:

  1. a diurnal day/night load curve under the default EWMA pre-warmer;
  2. a flash crowd with no pre-warming at all (every burst pays cold
     starts) vs the HAS-GPU-style fine-grained autoscaler vs its
     vertical variant (fractional vGPU resizing of running pools);
  3. a heavy-tailed (Azure-like) trace with a tight SLO so the gateway's
     load shedding engages.

Host only: no model runs.  The profiles are the roofline model's at the
card's peaks (the default, ``cuda``) or the H100 data sheet's (``--device
cpu``).

  PYTHONPATH=src python examples/torch_serve_scenarios.py [--device cpu]
"""
import argparse

import torch

from repro_torch.cluster.gpu_profiles import zoo_tables
from repro_torch.launch.roofline import device_peaks
from repro_torch.launch.serve import emulate
from repro_torch.models.model import resolve_device
from repro_torch.serving import format_table

N = 80
SEED = 0


def main(device=None):
    dev = resolve_device(device)
    tables = zoo_tables(peaks=device_peaks(torch.cuda.get_device_name(dev))
                        if dev.type == "cuda" else None)
    rows = []
    print("== diurnal, EWMA pre-warm (default policy) ==")
    rows.append(emulate(scenario="diurnal", n=N, seed=SEED, log=print,
                        tables=tables))

    print("\n== flash crowd: no pre-warm vs fine-grained autoscaler ==")
    for policy in ("none", "finegrained", "vertical"):
        rows.append(emulate(scenario="flash-crowd", n=N, seed=SEED,
                            autoscaler=policy, log=print, tables=tables))

    print("\n== heavy-tailed arrivals, strict SLO (shedding engages) ==")
    rows.append(emulate(scenario="azure-tail", n=N, seed=SEED,
                        slo_mult=0.8, log=print, tables=tables))

    print("\n" + format_table(rows))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="whose peaks the profiles use (default: cuda, the "
                         "card's; 'cpu': the H100 data sheet's)")
    main(ap.parse_args().device)
