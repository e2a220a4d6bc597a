"""The port's ``quant/`` (counterpart of ``distribuuuu_tpu/quant``): int8
post-training quantization for serving (``ptq``) and its quality gate
(``gate``). Quantization-aware training (JAX's ``quant/qat.py``) is not
ported yet (ROADMAP item 8b)."""

from distribuuuu_tpu_torch.quant.gate import GateResult, compare_logits
from distribuuuu_tpu_torch.quant.ptq import (
    CalibrationSite,
    Int8Model,
    calibrate,
    prune_variables,
    quantize,
    quantize_weight,
)

__all__ = [
    "CalibrationSite",
    "GateResult",
    "Int8Model",
    "calibrate",
    "compare_logits",
    "prune_variables",
    "quantize",
    "quantize_weight",
]
