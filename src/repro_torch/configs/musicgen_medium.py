"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens (frontend stub)."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,  # MHA
    d_head=64, d_ff=6144, vocab=2048,
    norm="layernorm", mlp="gelu", rope_theta=1e4,
    frontend="encodec", n_prefix=0,
    source="arXiv:2306.05284",
)
