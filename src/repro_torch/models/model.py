"""Model facade over the ported families.

``Model(cfg, opts, device)`` exposes the step functions the serving layer,
the trainer and the tests use:

    loss(params, batch)                     -> scalar          (train)
    forward(params, batch)                  -> (logits, aux)   (train)
    prefill(params, batch, max_len, cache)  -> (logits, cache)
    decode(params, cache, tokens)           -> (logits, cache)
    hidden(params, batch)                   -> hidden states
    param_specs() / init(seed)
    cache_specs(batch, max_len) / init_cache(batch, max_len)
    input_specs(shape) / dummy_inputs(shape, seed)

Batches are dicts: {"tokens": (B, S) int, ["labels": (B, S) int],
["prefix_embeds": (B, P, D)]}.  Every family of the zoo runs: the
transformer families (dense, moe, vlm, audio), rwkv6 (ssm) and hymba
(hybrid).

``decode`` replays each set of buffers' step from a CUDA graph where
``decode_graph.why_eager`` allows it (plain CUDA tensors, no mesh, no
autograd), else runs the family's ``decode_step``; ``graphs`` counts the
captures and replays.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.registry import ModelConfig, ShapeSpec
from repro_torch.models import decode_graph, hymba, rwkv6, transformer
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
    if cfg.family == "ssm":
        return rwkv6
    if cfg.family == "hybrid":
        return hymba
    return transformer  # dense | moe | vlm | audio


class Model:
    def __init__(self, cfg: ModelConfig, opts: RunOptions = RunOptions(),
                 device=None):
        self.cfg = cfg
        self.opts = opts
        self.device = resolve_device(device)
        self._m = _family_module(cfg)
        self.graphs = decode_graph.DecodeGraphs()

    # ---- params -----------------------------------------------------------
    def param_specs(self):
        return self._m.param_specs(self.cfg, self.opts)

    def init(self, seed: int):
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return self._m.init_params(self.cfg, g, self.opts, self.device)

    # ---- steps ------------------------------------------------------------
    def loss(self, params, batch):
        return self._m.lm_loss(self.cfg, params, batch["tokens"],
                               batch["labels"], batch.get("prefix_embeds"),
                               opts=self.opts)

    def forward(self, params, batch):
        return self._m.forward(self.cfg, params, batch["tokens"],
                               batch.get("prefix_embeds"), self.opts, "train")

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
        if decode_graph.why_eager(self.opts, params, cache, tokens) is None:
            return self.graphs(self.decode_step, params, cache, tokens)
        return self.decode_step(params, cache, tokens)

    def decode_step(self, params, cache, tokens):
        """One eager decode step (what a graph of :meth:`decode` holds)."""
        return self._m.decode_step(self.cfg, params, cache, tokens, self.opts)

    # ---- caches -----------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int):
        return self._m.cache_specs(self.cfg, batch, max_len, self.opts)

    def init_cache(self, batch: int, max_len: int):
        return self._m.init_cache(self.cfg, batch, max_len, self.opts,
                                  self.device)

    # ---- inputs -----------------------------------------------------------
    def input_specs(self, shape: ShapeSpec) -> dict:
        """Meta-device stand-ins (shape and dtype, no storage) for every
        model input of a cell: tokens (int32), labels when training, and
        the vlm family's precomputed prefix embeddings."""
        cfg = self.cfg
        b = shape.global_batch

        def spec(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return {"tokens": spec((b, 1), torch.int32)}
        s = shape.seq_len
        specs = {}
        if cfg.frontend == "vit" and cfg.n_prefix:
            s_tok = s - cfg.n_prefix
            specs["prefix_embeds"] = spec((b, cfg.n_prefix, cfg.d_model),
                                          self.opts.act_dtype)
        else:
            s_tok = s
        specs["tokens"] = spec((b, s_tok), torch.int32)
        if shape.kind == "train":
            specs["labels"] = spec((b, s_tok), torch.int32)
        return specs

    def dummy_inputs(self, shape: ShapeSpec, seed: int) -> dict:
        """Inputs of :meth:`input_specs`' shapes on the model's device,
        drawn from a generator seeded with ``seed``: token ids uniform in
        [0, vocab), embeddings standard normal."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        out = {}
        for name, s in self.input_specs(shape).items():
            if s.dtype == torch.int32:
                out[name] = torch.randint(0, self.cfg.vocab, s.shape,
                                          generator=g, dtype=torch.int32,
                                          device=self.device)
            else:
                out[name] = torch.randn(s.shape, generator=g,
                                        dtype=torch.float32,
                                        device=self.device).to(s.dtype)
        return out


def get_model(cfg: ModelConfig, opts: RunOptions = RunOptions(),
              device=None) -> Model:
    return Model(cfg, opts, device)
