"""Qwen1.5-110B [hf:Qwen/Qwen1.5-*] — dense GQA decoder with QKV bias."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="qwen1_5_110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab=152064,
    norm="rmsnorm", mlp="swiglu", qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-110B",
)
