"""InternVL2-76B [arXiv:2404.16821] — InternViT frontend (stub) + 70B-class LM backbone."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    norm="rmsnorm", mlp="swiglu", rope_theta=5e5,
    frontend="vit", n_prefix=256,
    source="arXiv:2404.16821",
)
