"""The port's ``quant/`` (counterpart of ``distribuuuu_tpu/quant``): int8
post-training quantization for serving (``ptq``), its quality gate
(``gate``) and quantization-aware training (``qat``)."""

from distribuuuu_tpu_torch.quant.gate import GateResult, compare_logits
from distribuuuu_tpu_torch.quant.ptq import (
    CalibrationSite,
    Int8Model,
    calibrate,
    prune_variables,
    quantize,
    quantize_weight,
)
from distribuuuu_tpu_torch.quant.qat import (
    QATModel,
    calibrate_qat,
    fake_quant_act,
    fake_quant_weight,
)

__all__ = [
    "CalibrationSite",
    "GateResult",
    "Int8Model",
    "QATModel",
    "calibrate",
    "calibrate_qat",
    "compare_logits",
    "fake_quant_act",
    "fake_quant_weight",
    "prune_variables",
    "quantize",
    "quantize_weight",
]
