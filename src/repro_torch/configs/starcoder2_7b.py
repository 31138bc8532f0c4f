"""StarCoder2-7B [arXiv:2402.19173; hf] — GQA, RoPE, GELU MLP, LayerNorm."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152,
    norm="layernorm", mlp="gelu", qkv_bias=True, rope_theta=1e5,
    source="arXiv:2402.19173; hf",
)
