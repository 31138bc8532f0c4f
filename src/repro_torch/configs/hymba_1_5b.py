"""Hymba-1.5B [arXiv:2411.13676] — parallel attention + mamba heads, SWA."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="hymba_1_5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_head=64, d_ff=5504, vocab=32001,
    norm="rmsnorm", mlp="swiglu", rope_theta=1e4,
    window=1024, ssm_state=16,
    source="arXiv:2411.13676",
)
