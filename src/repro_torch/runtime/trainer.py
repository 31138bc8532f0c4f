"""Fault-tolerant training loop.

Step-functional loop around (params, opt_state, step) with:
  * auto-resume from the latest checkpoint (crash / preemption restart),
  * periodic atomic checkpoints (``checkpoint.save`` publishes via rename),
  * deterministic data replay (batch = f(seed, step), drawn on the
    training device, see data/pipeline.py),
  * optional fault injection (``fail_at_step``), used by the tests to prove
    restart-equivalence: a run that crashes and resumes produces the same
    losses as an uninterrupted one,
  * optional int8 gradient compression with error feedback (optim/adamw).

A step is plain PyTorch autograd (``Model.loss`` backward) and one AdamW
update, as the reference's ``jax.value_and_grad`` step runs its jnp path:
no CUDA kernel of the port runs in training.  On the card the loop asks
for deterministic algorithms while it runs (the embedding gather's
backward otherwise accumulates with atomics), so a resumed run repeats
the uninterrupted one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import torch
import torch.utils.deterministic

from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.registry import ModelConfig
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.models.model import Model, RunOptions, get_model
from repro_torch.optim import adamw


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = "build/train_ckpt"
    log_every: int = 10
    fail_at_step: Optional[int] = None    # fault injection (tests)
    seed: int = 0


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms on a CUDA device for the block's span.

    ``warn_only``: an op with no deterministic CUDA version (``cumsum`` in
    RWKV6's plain WKV) warns and runs rather than failing the step.  Fresh
    allocations are not filled first: no step reads memory it has not
    written."""
    if device.type != "cuda":
        yield
        return
    # read by PyTorch's cuBLAS check at each call; it sizes the workspace
    # too when set before CUDA initialises (launch/train.py sets it first)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.utils.deterministic.fill_uninitialized_memory = was[2]


class Trainer:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig,
                 opts: RunOptions = RunOptions(remat="none"),
                 opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                 log_fn: Callable[[str], None] = print, device=None):
        self.model: Model = get_model(cfg, opts, device)
        self.device = self.model.device
        self.data = TokenStream(data_cfg, device=self.device)
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg
        self.log = log_fn
        self.losses: list[float] = []

    def init_state(self) -> dict:
        """Parameters drawn on the device from a generator seeded with
        ``tcfg.seed``; zero AdamW moments (and error feedback)."""
        params = self.model.init(self.tcfg.seed)
        return {"params": params, "opt": adamw.init(params),
                "err_fb": (adamw.init_error_feedback(params)
                           if self.opt_cfg.compress_grads else None)}

    def loss_and_grads(self, params: dict, batch: dict):
        """(loss, {name: grad}) of ``Model.loss`` at ``params`` on
        ``batch``; the loss a detached 0-d tensor on the device."""
        params = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        batch = {k: v.to(self.device) for k, v in batch.items()}
        loss = self.model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def train_step(self, state: dict, batch: dict) -> dict:
        """One step on ``state``, its tensors updated in place; returns
        {"loss", "grad_norm", "lr"} as 0-d tensors on the device."""
        loss, grads = self.loss_and_grads(state["params"], batch)
        state["params"], state["opt"], state["err_fb"], m = adamw.update(
            self.opt_cfg, state["params"], grads, state["opt"],
            state["err_fb"])
        return {"loss": loss, **m}

    def run(self) -> dict:
        tcfg = self.tcfg
        state = self.init_state()
        start = 0
        if ckpt.latest_step(tcfg.ckpt_dir) is not None:
            state, start = ckpt.restore(tcfg.ckpt_dir, state,
                                        device=self.device)
            self.log(f"[trainer] resumed from step {start}")
        t0 = time.time()
        with deterministic(self.device):
            for step in range(start, tcfg.steps):
                if tcfg.fail_at_step is not None and \
                        step == tcfg.fail_at_step and \
                        start <= tcfg.fail_at_step:
                    raise SimulatedFailure(f"injected failure at step {step}")
                m = self.train_step(state, self.data.batch(step))
                loss = float(m["loss"])
                self.losses.append(loss)
                if step % tcfg.log_every == 0:
                    self.log(f"[trainer] step {step:5d} loss {loss:.4f} "
                             f"gnorm {float(m['grad_norm']):.3f} "
                             f"({(time.time()-t0):.1f}s)")
                if (step + 1) % tcfg.ckpt_every == 0 or \
                        step + 1 == tcfg.steps:
                    ckpt.save(tcfg.ckpt_dir, step + 1, state)
        return {"final_loss": self.losses[-1] if self.losses else None,
                "losses": self.losses, "steps_run": tcfg.steps - start}
