"""Roofline accounting for NVIDIA Hopper cards.

  compute term    = FLOPs_per_device / peak_FLOPs
  memory term     = bytes_per_device / HBM_bw
  collective term = wire_bytes_per_device / link_bw

The peaks come from NVIDIA's data sheets (dense rates, no sparsity) for
the card the process runs on, chosen by ``torch.cuda.get_device_name()``
from :data:`DEVICE_PEAKS`; an unknown name raises rather than guess.
MODEL_FLOPS uses active parameters for MoE.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    name: str
    peak_flops: float          # bf16 dense, FLOP/s
    hbm_bw: float              # B/s
    link_bw: float             # NVLink, B/s each way
    fp32_flops: float          # fp32 outside the tensor cores, FLOP/s


# data-sheet variants, matched against the device name in order
DEVICE_PEAKS = (
    ("H100 NVL", DevicePeaks("H100 NVL", 835e12, 3.9e12, 300e9, 60e12)),
    ("H100 PCIe", DevicePeaks("H100 PCIe", 756e12, 2.0e12, 300e9, 51e12)),
    ("H100", DevicePeaks("H100 SXM", 989e12, 3.35e12, 450e9, 67e12)),
    ("H200", DevicePeaks("H200 SXM", 989e12, 4.8e12, 450e9, 67e12)),
)


def device_peaks(device_name: str) -> DevicePeaks:
    """Peaks of the card ``torch.cuda.get_device_name()`` names."""
    for key, peaks in DEVICE_PEAKS:
        if key in device_name:
            return peaks
    raise KeyError(f"no data-sheet peaks for device {device_name!r}; "
                   f"known: {[k for k, _ in DEVICE_PEAKS]}")


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (per-device flops x chips)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower-bound step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_s / max-term.  1.0 = perfectly compute-bound."""
        return self.compute_s / self.bound_s if self.bound_s > 0 else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "roofline_fraction": self.roofline_fraction,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }


def analytic_memory_bytes(cfg, shape, n_chips: int) -> float:
    """Per-device HBM traffic estimate from model arithmetic.

    train:   params 2B read (fwd) + 2B (bwd) + grads 2B write
             + AdamW m/v read+write fp32 (16B) + param write 2B  = 24 B/param
             + activations: ~10 residual-width passes + mlp/attn projections,
             x (fwd + bwd + remat fwd) = x3
    prefill: params 2B + 1x activation pass + cache write
    decode:  params 2B + cache read/write + O(B*D) activations
    """
    p_local = cfg.n_params / n_chips
    d, f_, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    act = 2  # bf16
    if shape.kind == "train":
        b_loc = max(shape.global_batch / n_chips * 16, 1)  # dp only: B/dp
        toks = b_loc * shape.seq_len
        per_layer = (10 * d + 3 * min(f_, f_ * (cfg.top_k if cfg.n_experts
                                                else 1)) / 16 +
                     3 * cfg.n_heads * cfg.d_head / 16) * act
        act_bytes = toks * per_layer * l * 3.0
        return p_local * 24.0 + act_bytes
    if shape.kind == "prefill":
        b_loc = max(shape.global_batch / min(n_chips, 16), 1)
        toks = b_loc * shape.seq_len
        per_layer = (8 * d + 3 * (f_ if not cfg.n_experts else
                                  f_ * cfg.top_k) / 16 +
                     4 * cfg.n_kv_heads * cfg.d_head) * act
        cache = toks * 2 * cfg.n_kv_heads * cfg.d_head * act * l
        return p_local * 2.0 + toks * per_layer * l + cache / n_chips * 16
    # decode: weights + cache dominate
    cache_local = _cache_bytes(cfg, shape) / n_chips
    b = shape.global_batch
    act_bytes = b * d * l * 8 * act / min(n_chips, 16)
    return p_local * 2.0 + cache_local + act_bytes


def _cache_bytes(cfg, shape) -> float:
    l, kvh, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        return b * cfg.n_heads * cfg.d_head * cfg.d_head * 4 * l
    w = s
    if cfg.window:
        w = min(cfg.window, s)
    if cfg.chunk_attn and cfg.global_every:
        per_macro = (cfg.global_every - 1) * min(cfg.chunk_attn, s) + s
        return b * per_macro * kvh * dh * 2 * 2 * (l // cfg.global_every)
    extra = 0.0
    if cfg.family == "hybrid":
        extra = b * cfg.d_model * cfg.ssm_state * 4 * l
    return b * w * kvh * dh * 2 * 2 * l + extra


def model_flops(cfg, shape) -> float:
    """6 N D (train) / 2 N D (fwd) with N = active params."""
    n = cfg.n_active_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch            # one token per sequence
    return 2.0 * n * tokens


def roofline(cfg, shape, flops_per_device: float, bytes_upper: float,
             wire_bytes_per_device: float, n_chips: int,
             peaks: DevicePeaks) -> RooflineTerms:
    mf = model_flops(cfg, shape)
    mem_bytes = min(analytic_memory_bytes(cfg, shape, n_chips),
                    bytes_upper if bytes_upper > 0 else float("inf"))
    return RooflineTerms(
        compute_s=flops_per_device / peaks.peak_flops,
        memory_s=mem_bytes / peaks.hbm_bw,
        collective_s=wire_bytes_per_device / peaks.link_bw,
        flops_per_device=flops_per_device,
        bytes_per_device=mem_bytes,
        wire_bytes_per_device=wire_bytes_per_device,
        model_flops=mf,
        useful_ratio=mf / (flops_per_device * n_chips)
        if flops_per_device else 0.0,
    )
