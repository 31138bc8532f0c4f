"""Deterministic synthetic-token data pipeline.

Batches are a pure function of (seed, step, host_slice), so training is
exactly replayable after a checkpoint restart and each host materialises
only its slice of the global batch: no data redistribution on restore,
and an elastic rescale just changes the slicing (same global stream).

The token stream is a mixture of Zipfian unigrams and short repeated
motifs, so small models have actual structure to learn (loss drops well
below the uniform-entropy floor).

The reference draws from ``jax.random``, which the port cannot reproduce
without JAX; the port draws the same structure from numpy's
``default_rng((seed, step))`` on the host, so a batch is the same whatever
device trains on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5


def _zipf_logits(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
    p = 1.0 / ranks ** cfg.zipf_a
    return np.log(p / p.sum()).astype(np.float32)


class TokenStream:
    """Stateless batch factory: ``batch(step)`` is deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        p = np.exp(_zipf_logits(cfg).astype(np.float64))
        self._cdf = np.cumsum(p / p.sum())

    def batch(self, step: int, host_slice: slice | None = None) -> dict:
        """{"tokens", "labels"}: (B, seq_len) int64 CPU tensors, the
        labels the tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b = cfg.global_batch
        # categorical draws from the Zipf unigram by inverse CDF
        u = rng.random((b, cfg.seq_len + 1))
        toks = np.minimum(np.searchsorted(self._cdf, u, side="right"),
                          cfg.vocab - 1)
        # overwrite whole rows with repeated motifs (learnable structure)
        motif = rng.integers(0, cfg.vocab, (b, cfg.motif_len))
        reps = (cfg.seq_len + 1 + cfg.motif_len - 1) // cfg.motif_len
        tiled = np.tile(motif, (1, reps))[:, : cfg.seq_len + 1]
        use_motif = rng.random((b, 1)) < cfg.motif_prob
        toks = np.where(use_motif, tiled, toks).astype(np.int64)
        if host_slice is not None:
            toks = toks[host_slice]
        toks = torch.from_numpy(toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_slice(self, host_id: int, n_hosts: int) -> slice:
        per = self.cfg.global_batch // n_hosts
        return slice(host_id * per, (host_id + 1) * per)
