"""InternLM2-1.8B [arXiv:2403.17297; hf] — dense GQA decoder."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="internlm2_1_8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544,
    norm="rmsnorm", mlp="swiglu", rope_theta=1e6,
    source="arXiv:2403.17297; hf",
)
