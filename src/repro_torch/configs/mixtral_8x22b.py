"""Mixtral 8x22B [arXiv:2401.04088] — 8 experts top-2, sliding-window attention."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="mixtral_8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    norm="rmsnorm", mlp="swiglu", rope_theta=1e6,
    n_experts=8, top_k=2, capacity_factor=1.25,
    window=4096,
    source="arXiv:2401.04088",
)
