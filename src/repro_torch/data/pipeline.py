"""Deterministic synthetic-token data pipeline.

Batches are a pure function of (seed, step, host_slice), so training is
exactly replayable after a checkpoint restart and each host materialises
only its slice of the global batch: no data redistribution on restore,
and an elastic rescale just changes the slicing (same global stream).

The token stream is a mixture of Zipfian unigrams and short repeated
motifs, so small models have actual structure to learn (loss drops well
below the uniform-entropy floor).

The draws are the reference's ``jax.random`` draws, token for token: the
threefry2x32 counter hash and the samplers built on it are integer and
bit operations, written here in torch (``int64`` lanes holding ``uint32``
values) for the key layout and counter order of ``jax_threefry_partitionable``
mode.  The one float step is the Gumbel noise ``-log(-log(u))`` of
``categorical``, where a float32 ``log`` may round an ulp away from
XLA's and flip a near-tied argmax.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ---------------------------------------------------------------------------
# threefry2x32 and jax.random's samplers
# ---------------------------------------------------------------------------
def threefry2x32(key, x0, x1):
    """The threefry2x32 hash (20 rounds) of counter pairs (x0, x1) under
    ``key``, a (2,) int64 tensor; x0 and x1 int64 tensors of one shape
    holding uint32 values.  Returns the two output words likewise."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int, device=None):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words (0, seed)."""
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key, data: int):
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    y0, y1 = threefry2x32(key, key.new_tensor([0]),
                          key.new_tensor([data & _MASK]))
    return torch.cat([y0, y1])


def split(key, num: int = 2):
    """``jax.random.split`` (partitionable): key i is the hash of the
    counter pair (0, i)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key, torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=1)


def random_bits(key, count: int, start: int = 0):
    """32 random bits for the flat (row-major) indices [start, start +
    count) of an array drawn whole (partitionable layout): index n gets
    y0 ^ y1 of the hash of (n >> 32, n & 0xFFFFFFFF)."""
    n = torch.arange(start, start + count, dtype=torch.int64,
                     device=key.device)
    y0, y1 = threefry2x32(key, n >> 32, n & _MASK)
    return y0 ^ y1


def _unit_float(bits):
    """jax.random's float32 in [0, 1) from 32 bits: 23 mantissa bits under
    the exponent of 1.0, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape: tuple):
    """``jax.random.uniform(key, shape)``, float32 in [0, 1)."""
    return _unit_float(random_bits(key, math.prod(shape))).reshape(shape)


def bernoulli(key, p: float, shape: tuple):
    """``jax.random.bernoulli(key, p, shape)`` (mode 'low')."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


def randint(key, shape: tuple, minval: int, maxval: int):
    """``jax.random.randint(key, shape, minval, maxval, int32)`` for
    0 <= maxval - minval < 2**31: two words of bits folded by a multiply
    and a remainder in uint32 arithmetic (wrapping), as jax does."""
    k1, k2 = split(key)
    hi, lo = (random_bits(k, math.prod(shape)) for k in (k1, k2))
    span = max(maxval - minval, 1)
    mult = (((2 ** 16 % span) ** 2) & _MASK) % span  # wraps past 2**32
    off = ((hi % span) * mult & _MASK) + lo % span
    off = (off & _MASK) % span
    return (minval + off).reshape(shape)


def categorical(key, logits, shape: tuple, rows=None):
    """``jax.random.categorical(key, logits, shape=shape)`` for 1-D
    ``logits`` (float32, on the key's device): the argmax over the vocab
    of logits + Gumbel noise.  The noise of ``shape + (vocab,)`` is drawn
    one leading row at a time, so its int64 lanes stay one row's size;
    ``rows`` (a range of leading rows) draws only those rows."""
    vocab = logits.shape[0]
    per_row = math.prod(shape[1:]) * vocab
    tiny = torch.finfo(torch.float32).tiny
    rows = range(shape[0]) if rows is None else rows
    out = []
    for row in rows:
        bits = random_bits(key, per_row, row * per_row)
        u = torch.clamp(_unit_float(bits) + tiny, min=tiny)
        g = -torch.log(-torch.log(u))
        out.append(torch.argmax(g.reshape(-1, vocab) + logits, -1))
    return torch.stack(out).reshape((len(rows),) + tuple(shape[1:]))


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------
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
    """Stateless batch factory: ``batch(step)`` is deterministic, the
    reference's batch, drawn on ``device`` (the CPU by default)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = torch.device("cpu" if device is None else device)
        self._logits = torch.from_numpy(_zipf_logits(cfg)).to(self.device)

    def batch(self, step: int, host_slice: slice | None = None) -> dict:
        """{"tokens", "labels"}: (B, seq_len) int64 tensors on the stream's
        device, the labels the tokens shifted by one."""
        cfg = self.cfg
        key = fold_in(prng_key(cfg.seed, self.device), step)
        b, width = cfg.global_batch, cfg.seq_len + 1
        sl = host_slice or slice(None)
        k1, k2, k3 = split(key, 3)
        # a host draws the Zipf rows of its slice only: each row's noise is
        # its own slice of the counter space
        toks = categorical(k1, self._logits, (b, width), range(b)[sl])
        # overwrite whole rows with repeated motifs (learnable structure)
        motif = randint(k2, (b, cfg.motif_len), 0, cfg.vocab)
        reps = (width + cfg.motif_len - 1) // cfg.motif_len
        tiled = motif.repeat(1, reps)[:, :width]
        use_motif = bernoulli(k3, cfg.motif_prob, (b, 1))
        toks = torch.where(use_motif[sl], tiled[sl], toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_slice(self, host_id: int, n_hosts: int) -> slice:
        per = self.cfg.global_batch // n_hosts
        return slice(host_id * per, (host_id + 1) * per)
