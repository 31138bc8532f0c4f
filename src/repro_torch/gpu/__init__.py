"""Shareable-GPU device model (fractional vGPU slices, HBM accounting,
model-state swap tiers).

  * ``device``     — :class:`DeviceModel`: per-invoker slice lattice,
                     resizable running allocations, two-tier warm pools;
  * ``footprints`` — model-weight footprints + the Torpor-style
                     host->HBM swap-in timing model;
  * ``transfer``   — :class:`TransferEngine`: per-device asynchronous
                     PCIe copy timeline (overlapped swap + prefetch).
"""
from repro_torch.gpu.device import (COLD, HOT, MIN_SLICES, SLICES_PER_VGPU, WARM,
                              Allocation, DeviceModel, DeviceStats,
                              OversubscribedError, WarmContainer, WeightSet)
from repro_torch.gpu.footprints import (DEFAULT_SKU, PAPER_MODEL_MB, SKU_CATALOG,
                                  GpuSKU, cold_components, resolve_sku,
                                  swap_in_ms, tier_penalty_ms)
from repro_torch.gpu.transfer import DEMAND, PREFETCH, Transfer, TransferEngine

__all__ = [
    "Allocation", "COLD", "DEFAULT_SKU", "DEMAND", "DeviceModel",
    "DeviceStats", "GpuSKU", "HOT", "MIN_SLICES", "OversubscribedError",
    "PAPER_MODEL_MB", "PREFETCH", "SKU_CATALOG", "SLICES_PER_VGPU",
    "Transfer", "TransferEngine", "WARM", "WarmContainer", "WeightSet",
    "cold_components", "resolve_sku", "swap_in_ms", "tier_penalty_ms",
]
