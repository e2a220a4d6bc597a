"""Quality gate: refuse to serve an int8 model that drifted from its fp32 twin.

The port's copy of ``distribuuuu_tpu/quant/gate.py`` (numpy only).

Quantization error is a *measured* quantity here, never an assumption: the
gate runs the same deterministic inputs through the int8 path and the fp32
engine forward and compares — top-1 agreement (the metric a classifier's
clients actually feel) and logit RMSE (the early-warning drift number).
Either exceeding its threshold fails the gate, and a failed gate is a
refused model (the port's `serve/engine.py` raises instead of hosting), with the whole
measurement journaled as a typed ``quant_quality`` record either way.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np


@dataclass
class GateResult:
    """The measurement a ``quant_quality`` journal record carries."""

    top1_agree: float
    logit_rmse: float
    min_top1_agree: float
    max_logit_rmse: float
    n: int
    passed: bool

    def fields(self) -> dict:
        return asdict(self)


def compare_logits(
    fp_logits: np.ndarray,
    q_logits: np.ndarray,
    *,
    min_top1_agree: float,
    max_logit_rmse: float,
) -> GateResult:
    """Gate verdict for one (fp32, int8) logit pair on identical inputs."""
    fp = np.asarray(fp_logits, np.float32)
    q = np.asarray(q_logits, np.float32)
    if fp.shape != q.shape:
        raise ValueError(f"logit shapes differ: fp {fp.shape} vs int8 {q.shape}")
    n = int(fp.shape[0])
    agree = float(np.mean(fp.argmax(axis=-1) == q.argmax(axis=-1)))
    rmse = float(np.sqrt(np.mean((fp - q) ** 2)))
    return GateResult(
        top1_agree=round(agree, 6),
        logit_rmse=round(rmse, 6),
        min_top1_agree=float(min_top1_agree),
        max_logit_rmse=float(max_logit_rmse),
        n=n,
        passed=bool(agree >= min_top1_agree and rmse <= max_logit_rmse),
    )
