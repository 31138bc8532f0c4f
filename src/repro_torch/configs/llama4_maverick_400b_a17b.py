"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-*] — MoE 128e top-1,
chunked-local attention (8192) with 1-in-4 global layers."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="llama4_maverick_400b_a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    norm="rmsnorm", mlp="swiglu", rope_theta=5e5,
    n_experts=128, top_k=1, capacity_factor=1.25,
    chunk_attn=8192, global_every=4,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (config family)",
)
