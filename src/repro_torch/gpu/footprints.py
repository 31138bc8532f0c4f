"""Model-state footprints + host<->HBM swap timing (Torpor/FaaSwap model).

Torpor (arXiv 2306.03622) observes that for GPU serverless the dominant
"cold start" component is loading model weights into device memory, and
that keeping weights in *host* RAM and swapping them in over PCIe on
demand is an order of magnitude cheaper than a full container cold start.
This module provides that middle tier's cost model:

  * ``swap_in_ms(model_mb)`` — host -> HBM transfer time for a model
    checkpoint of ``model_mb`` megabytes at PCIe-class bandwidth plus a
    fixed allocator/stream-setup charge;
  * per-function weight footprints for the paper's six image functions
    (plausible fp16 checkpoint sizes; the zoo derives its own from the
    parameter counts, see ``cluster/tpu_profiles.py``).

The three warm tiers the device model distinguishes:

  hot   weights resident in HBM          -> restart penalty 0
  warm  weights in host RAM              -> restart penalty swap_in_ms
  cold  nothing anywhere                 -> restart penalty profile.cold_ms

``tier_penalty_ms`` maps a tier to that restart penalty and is the single
source of truth shared by the device model (``swap_cost_ms`` queries), the
emulator's dispatch accounting and the memory-aware placement ranking.

Heterogeneous fleets add one more dimension: a ``GpuSKU`` describes a
device class (exec-rate multiplier, HBM capacity, host->HBM bandwidth,
$/slice-hour price factor, warm-up-from-zero latency) plus the spot
contract — preemptible capacity with a seeded reclamation process whose
mean inter-reclaim gap, warning lead and recovery outage live here too.
``DEFAULT_SKU`` is neutral on every axis so a homogeneous fleet built
from it is bit-identical to the pre-SKU emulator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

# Warm-state tiers (defined here, below the device model, so the cost
# helpers need no import from ``device`` — re-exported there).
HOT = "hot"      # weights resident in HBM
WARM = "warm"    # weights in host RAM (swap-in penalty on start)
COLD = "cold"    # no container anywhere (full cold start)

# Host -> device effective bandwidth.  PCIe 4.0 x16 peaks at 32 GB/s; real
# pinned-memory H2D copies sustain roughly half (Torpor reports ~1.5 s for
# multi-GB LLMs, consistent with this figure).  1 GB/s == 1 MB/ms.
H2D_GBPS = 16.0
# Fixed per-swap charge: device allocator + stream setup + cudnn/XLA
# re-binding of the resident executable to the new weight buffers.
SWAP_FIXED_MS = 5.0


def swap_in_ms(model_mb: float, gbps: float = H2D_GBPS) -> float:
    """Host->HBM restart penalty for a ``model_mb``-MB checkpoint.

    ``gbps`` lets per-SKU PCIe/NVLink bandwidth override the default
    PCIe-4.0 figure (1 GB/s == 1 MB/ms)."""
    if model_mb <= 0.0:
        return 0.0
    return SWAP_FIXED_MS + model_mb / gbps


def cold_components(model_mb: float,
                    cold_ms: Optional[float] = None,
                    gbps: float = H2D_GBPS) -> tuple[float, float]:
    """Split a full cold start into ``(provision_ms, weight_ms)``.

    ``weight_ms`` is the host->HBM checkpoint copy (the part a PCIe
    transfer engine can overlap or prefetch); ``provision_ms`` is the
    container/runtime setup that stays CPU-side.  The weight component
    is clamped to ``cold_ms`` — it is *part* of the measured cold start,
    never more than it — so ``provision + weight == cold_ms`` exactly
    (or ``(0, swap_in_ms)`` when no cold figure is known, matching the
    ``tier_penalty_ms`` lower-bound convention)."""
    weight = swap_in_ms(model_mb, gbps)
    if cold_ms is None:
        return 0.0, weight
    weight = min(weight, max(cold_ms, 0.0))
    return max(cold_ms - weight, 0.0), weight


def tier_penalty_ms(tier: str, model_mb: float,
                    cold_ms: Optional[float] = None,
                    gbps: float = H2D_GBPS) -> float:
    """Restart penalty a container pays when its warm state is ``tier``.

    ``cold_ms`` is the function's full cold-start time (container
    provisioning + weight load); when the caller cannot supply it the
    weight-load component alone is returned as an admissible lower
    bound (that keeps planners that price this penalty optimistic,
    never pessimistic).
    """
    if tier == HOT:
        return 0.0
    if tier == WARM:
        return swap_in_ms(model_mb, gbps)
    return cold_ms if cold_ms is not None else swap_in_ms(model_mb, gbps)


# ---------------------------------------------------------------------------
# Heterogeneous / preemptible fleet SKUs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GpuSKU:
    """One device class in a heterogeneous (possibly preemptible) fleet.

    Every field defaults to the neutral value the homogeneous emulator
    implicitly assumed, so ``DEFAULT_SKU`` leaves each code path
    arithmetically untouched (x * 1.0 is exact in IEEE-754):

      exec_rate        throughput multiplier vs the profiled baseline
                       device; exec time is divided by it
      hbm_per_vgpu_mb  HBM capacity per vGPU (None => the sim-level
                       ``hbm_per_vgpu_mb`` argument / unbounded)
      h2d_gbps         host->HBM bandwidth for swap-in / checkpoint
                       restore (PCIe or NVLink class)
      price_factor     multiplier on the vGPU component of $/slice-hour
                       (spot discounts < 1, premium parts > 1)
      warmup_ms        warm-up-from-zero: extra latency on the first
                       dispatch to a completely empty device (driver/
                       MIG partition bring-up)
      spot             preemptible capacity; reclamations are drawn from
                       a seeded exponential process with mean gap
                       ``reclaim_mean_s`` (scaled down inside storm
                       windows), announce themselves ``warn_ms`` ahead,
                       and take the device down for ``recover_ms``
    """
    name: str = "a100"
    exec_rate: float = 1.0
    hbm_per_vgpu_mb: Optional[float] = None
    h2d_gbps: float = H2D_GBPS
    price_factor: float = 1.0
    warmup_ms: float = 0.0
    spot: bool = False
    reclaim_mean_s: float = 0.0
    warn_ms: float = 2_000.0
    recover_ms: float = 8_000.0


DEFAULT_SKU = GpuSKU()

# Catalogue of plausible classes: exec rates are rough relative inference
# throughputs, price factors track on-demand vs spot market ratios.  The
# "a100" entry IS the neutral default — fleets spelled ["a100"] * n stay
# bit-identical to the homogeneous emulator.
SKU_CATALOG: dict[str, GpuSKU] = {
    "a100": DEFAULT_SKU,
    "h100": GpuSKU(name="h100", exec_rate=1.6, h2d_gbps=24.0,
                   price_factor=1.7, warmup_ms=150.0),
    "a100-spot": GpuSKU(name="a100-spot", price_factor=0.4, spot=True,
                        reclaim_mean_s=240.0),
    "a10g-spot": GpuSKU(name="a10g-spot", exec_rate=0.45,
                        hbm_per_vgpu_mb=6_000.0, h2d_gbps=8.0,
                        price_factor=0.22, warmup_ms=80.0, spot=True,
                        reclaim_mean_s=180.0),
    "t4-spot": GpuSKU(name="t4-spot", exec_rate=0.25,
                      hbm_per_vgpu_mb=4_000.0, h2d_gbps=6.0,
                      price_factor=0.12, warmup_ms=60.0, spot=True,
                      reclaim_mean_s=150.0),
}


def resolve_sku(sku: Union[str, GpuSKU, None]) -> GpuSKU:
    """Accept a catalogue name, a ``GpuSKU``, or None (=> default)."""
    if sku is None:
        return DEFAULT_SKU
    if isinstance(sku, GpuSKU):
        return sku
    try:
        return SKU_CATALOG[sku]
    except KeyError:
        raise KeyError(f"unknown GPU SKU {sku!r} "
                       f"(known: {sorted(SKU_CATALOG)})") from None


# fp16 checkpoint sizes (MB) for the paper's Table-3 image functions —
# typical published checkpoints for each task class (EDSR-class SR,
# DeepLab-class segmentation, DeblurGAN-class deblurring, ResNet-152-class
# classification, U^2-Net-class matting, MiDaS-large-class depth).
PAPER_MODEL_MB = {
    "super_resolution": 170.0,
    "segmentation": 460.0,
    "deblur": 380.0,
    "classification": 230.0,
    "background_removal": 680.0,
    "depth": 530.0,
}
