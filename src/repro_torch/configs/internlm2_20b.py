"""InternLM2-20B [arXiv:2403.17297; hf] — dense GQA decoder."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="internlm2_20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544,
    norm="rmsnorm", mlp="swiglu", rope_theta=1e6,
    source="arXiv:2403.17297; hf",
)
