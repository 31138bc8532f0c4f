"""Architecture + shape registry.

Every assigned architecture lives in ``src/repro/configs/<id>.py`` exposing
``CONFIG: ModelConfig``.  ``get_config(name)`` returns it; ``reduced(cfg)``
shrinks it for CPU smoke tests (same family / code paths, tiny dims).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

ARCH_IDS = [
    "internlm2_20b",
    "qwen1_5_110b",
    "internlm2_1_8b",
    "starcoder2_7b",
    "rwkv6_1_6b",
    "llama4_maverick_400b_a17b",
    "mixtral_8x22b",
    "internvl2_76b",
    "musicgen_medium",
    "hymba_1_5b",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | moe | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # derived if 0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp: str = "swiglu"              # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # --- attention flavour ---
    window: Optional[int] = None     # sliding-window size (None = full causal)
    chunk_attn: Optional[int] = None # llama4 chunked-local attention size
    global_every: Optional[int] = None  # 1-in-N layers use full attention
    # --- MoE ---
    n_experts: Optional[int] = None
    top_k: int = 1
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    # --- modality frontend stub ---
    frontend: Optional[str] = None   # vit | encodec | None
    n_prefix: int = 0                # prefix embeddings provided by frontend stub
    source: str = ""

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def subquadratic(self) -> bool:
        """True if decode state is o(context): SSM, SWA or chunked attention."""
        if self.family == "ssm":
            return True
        return self.window is not None or self.chunk_attn is not None

    @property
    def n_params(self) -> int:
        """Total parameter count (used for MODEL_FLOPS roofline term)."""
        return _count_params(self, active_only=False)

    @property
    def n_active_params(self) -> int:
        return _count_params(self, active_only=True)


def _count_params(c: ModelConfig, active_only: bool) -> int:
    d, f, L = c.d_model, c.d_ff, c.n_layers
    h, kv, dh = c.n_heads, c.n_kv_heads, c.d_head
    embed = c.vocab * d * (1 if c.tie_embeddings else 2)
    if c.family == "ssm":
        # RWKV6: time-mix (r,k,v,g,o ~ 5 d^2 + lora) + channel-mix (2 d*f)
        per_layer = 5 * d * d + 2 * d * f + 6 * d * 96
        return embed + L * per_layer
    attn = d * (h * dh) * 2 + d * (kv * dh) * 2
    if c.mlp == "swiglu":
        ffn = 3 * d * f
    else:
        ffn = 2 * d * f
    if c.n_experts:
        n_e = (c.top_k if active_only else c.n_experts)
        ffn = ffn * n_e
    per_layer = attn + ffn
    if c.family == "hybrid":
        per_layer += d * (2 * c.ssm_state + 2 * d)  # parallel SSM head branch
    return embed + L * per_layer


# ---------------------------------------------------------------------------
# Shapes (assigned: same 4 for every LM arch)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch x shape) is a runnable dry-run cell (per spec)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: long_500k skipped (DESIGN §4)"
    return True, ""


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=128,
        vocab=256,
        window=min(cfg.window, 32) if cfg.window else None,
        chunk_attn=min(cfg.chunk_attn, 32) if cfg.chunk_attn else None,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else None,
        capacity_factor=4.0 if cfg.n_experts else cfg.capacity_factor,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        n_prefix=min(cfg.n_prefix, 8) if cfg.n_prefix else 0,
    )
