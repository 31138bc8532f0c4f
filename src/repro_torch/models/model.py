"""Model facade over the ported families.

``Model(cfg, opts, device)`` exposes the step functions the serving layer
and the tests use:

    prefill(params, batch, max_len, cache)  -> (logits, cache)
    decode(params, cache, tokens)           -> (logits, cache)
    hidden(params, batch)                   -> hidden states
    param_specs() / init(seed)
    cache_specs(batch, max_len) / init_cache(batch, max_len)

Batches are dicts: {"tokens": (B, S) int, ["prefix_embeds": (B, P, D)]}.
The transformer families work; rwkv6 (ssm) and hymba (hybrid) raise
NotImplementedError until their slices land (ROADMAP items 2 and 3).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.transformer import RunOptions


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA unless the caller names another one.

    Raises when CUDA is asked for (or left to the default) and absent, so
    nothing silently runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def _family_module(cfg: ModelConfig):
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP items 2 and 3)")
    return transformer  # dense | vlm | audio (moe raises inside)


class Model:
    def __init__(self, cfg: ModelConfig, opts: RunOptions = RunOptions(),
                 device=None):
        self.cfg = cfg
        self.opts = opts
        self.device = resolve_device(device)
        self._m = _family_module(cfg)

    # ---- params -----------------------------------------------------------
    def param_specs(self):
        return self._m.param_specs(self.cfg, self.opts)

    def init(self, seed: int):
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return self._m.init_params(self.cfg, g, self.opts, self.device)

    # ---- steps ------------------------------------------------------------
    def prefill(self, params, batch, max_len: Optional[int] = None,
                cache: Optional[dict] = None):
        return self._m.forward(self.cfg, params, batch["tokens"],
                               batch.get("prefix_embeds"), self.opts,
                               "prefill", cache=cache, max_len=max_len)

    def hidden(self, params, batch):
        x, _ = self._m.forward(self.cfg, params, batch["tokens"],
                               batch.get("prefix_embeds"), self.opts,
                               "hidden")
        return x

    def decode(self, params, cache, tokens):
        return self._m.decode_step(self.cfg, params, cache, tokens, self.opts)

    # ---- caches -----------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int):
        return self._m.cache_specs(self.cfg, batch, max_len, self.opts)

    def init_cache(self, batch: int, max_len: int):
        return self._m.init_cache(self.cfg, batch, max_len, self.opts,
                                  self.device)


def get_model(cfg: ModelConfig, opts: RunOptions = RunOptions(),
              device=None) -> Model:
    return Model(cfg, opts, device)
