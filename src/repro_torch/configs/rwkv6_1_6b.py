"""RWKV6 (Finch) 1.6B [arXiv:2404.05892] — attention-free, data-dependent decay."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_1_6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # heads = d/64 (WKV heads)
    d_head=64, d_ff=7168, vocab=65536,
    norm="layernorm", mlp="gelu",  # channel-mix uses squared relu; flag unused
    ssm_state=64,
    source="arXiv:2404.05892",
)
