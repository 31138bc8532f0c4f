"""Serving profiles for the model zoo on NVIDIA GPUs: the ESG <-> GPU bridge.

The paper reads function latencies from measured profile tables; here each
architecture becomes a servable function whose latency over the
(batch, vcpu, vgpu) lattice comes from a roofline model of the card
(``launch/roofline.py``'s :class:`DevicePeaks`, the H100 SXM by default).
The model is the reference's TPU zoo model term for term, with the card's
bf16 peak and HBM rate in place of the TPU chip's.

A "job" = one inference request: prefill(prompt_len) + gen_len decode steps.
``g`` vGPUs serve the task as a tensor-parallel group of g cards: the batch
split across them and each inference sharded, with a collective penalty
that grows with g.

The analytic model is scaled by an overhead factor, the reference's rule:
1 / useful_ratio of the port's own dry-run of the arch's ``decode_32k``
cell on the single-pod mesh (``launch/dryrun.py``, records in
``build/dryrun/``), clipped to [1, 4], else the fallback 1.3.  The
port's sharded steps split the computation over the mesh's 'model' axis
as GSPMD does (``launch/steps.py``), so the ratio is the step's own
(InternLM2-20B: useful 0.506, a factor of 1.98) and does not clip; with
no records the factor is 1.3.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from repro_torch.configs.registry import ARCH_IDS, ModelConfig, get_config
from repro_torch.core.profiles import FunctionProfile, ProfileTable
from repro_torch.launch.roofline import DevicePeaks, device_peaks

DEFAULT_OVERHEAD = 1.3
DRYRUN_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    prompt_len: int = 512
    gen_len: int = 64
    cpu_ms_per_job: float = 3.0        # tokenize/detokenize host work
    cold_ms: float = 8000.0            # weights load + compile cache hit
    input_mb: float = 0.05             # request payload


class GPUFunctionProfile(FunctionProfile):
    """FunctionProfile whose exec_ms comes from the card's roofline."""

    def __init__(self, cfg: ModelConfig, spec: ServingSpec = ServingSpec(),
                 overhead: float | None = None,
                 peaks: DevicePeaks | None = None):
        self._cfg = cfg
        self._spec = spec
        self._overhead = overhead if overhead is not None \
            else _calibrated_overhead(cfg.name)
        self._peaks = peaks if peaks is not None else device_peaks("H100")
        t1 = self._exec_ms_raw(1, 1, 1)
        super().__init__(name=cfg.name, t1_ms=t1, cold_ms=spec.cold_ms,
                         input_mb=spec.input_mb, cpu_frac=0.0,
                         model_mb=2.0 * cfg.n_params / 1e6)  # bf16 weights

    # latency model --------------------------------------------------------
    def _decode_ms(self, batch: int, gpus: int) -> float:
        n = self._cfg.n_active_params
        w_bytes = 2.0 * self._cfg.n_params          # bf16 weights read
        kv_bytes = 2.0 * 2 * self._cfg.n_layers * self._cfg.n_kv_heads * \
            self._cfg.d_head * self._spec.prompt_len * batch
        t_mem = (w_bytes + kv_bytes) / (gpus * self._peaks.hbm_bw)
        t_flop = 2.0 * n * batch / (gpus * self._peaks.peak_flops)
        link = 1.0 + 0.08 * np.log2(max(gpus, 1))   # collective penalty
        return max(t_mem, t_flop) * link * self._overhead * 1e3

    def _prefill_ms(self, batch: int, gpus: int) -> float:
        n = self._cfg.n_active_params
        toks = batch * self._spec.prompt_len
        t_flop = 2.0 * n * toks / (gpus * self._peaks.peak_flops)
        t_mem = 2.0 * self._cfg.n_params / (gpus * self._peaks.hbm_bw)
        link = 1.0 + 0.08 * np.log2(max(gpus, 1))
        return max(t_flop, t_mem) * link * self._overhead * 1e3

    def _exec_ms_raw(self, batch: int, vcpu: int, gpus: int) -> float:
        t = self._prefill_ms(batch, gpus) + \
            self._spec.gen_len * self._decode_ms(batch, gpus)
        t_cpu = self._spec.cpu_ms_per_job * batch / (vcpu ** 0.7)
        return t + t_cpu

    def exec_ms(self, c, quota_vgpu=None) -> float:  # Config(batch,vcpu,vgpu)
        # a fractional quota throttles the GPU part only: host tokenize /
        # detokenize work is unaffected by the accelerator share
        t_gpu = self._prefill_ms(c.batch, c.vgpu) + \
            self._spec.gen_len * self._decode_ms(c.batch, c.vgpu)
        t_cpu = self._spec.cpu_ms_per_job * c.batch / (c.vcpu ** 0.7)
        return t_gpu * self.quota_factor(c, quota_vgpu) + t_cpu


def _calibrated_overhead(arch: str) -> float:
    """Traced-FLOPs / model-FLOPs of the arch's ``decode_32k`` single-pod
    dry-run cell: how much wider the port's step is than the 2ND ideal."""
    f = DRYRUN_DIR / f"{arch}__decode_32k__single.json"
    try:
        useful = json.loads(f.read_text())["roofline"]["useful_ratio"]
    except (OSError, ValueError, KeyError, TypeError):
        return DEFAULT_OVERHEAD
    if useful and 0.02 < useful <= 1.0:
        return float(np.clip(1.0 / useful, 1.0, 4.0))
    return DEFAULT_OVERHEAD


def zoo_tables(archs: list[str] | None = None,
               spec: ServingSpec = ServingSpec(),
               max_chips: int = 8,
               peaks: DevicePeaks | None = None) -> dict[str, ProfileTable]:
    """One profile table per arch over vGPUs 1..``max_chips``."""
    out = {}
    for a in archs or ARCH_IDS:
        fp = GPUFunctionProfile(get_config(a), spec, peaks=peaks)
        out[a] = ProfileTable.build(fp, vgpus=tuple(range(1, max_chips + 1)))
    return out
