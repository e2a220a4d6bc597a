"""Multi-model inference engine: the compute half of the port's serving path.

Counterpart of ``distribuuuu_tpu/serve/engine.py``. Each hosted model is a
zoo model (a ResNet or BoTNet-50, built for ``SERVE.IM_SIZE`` crops) loaded
from a torch state_dict onto one device, channels-last, in eval mode. The
JAX engine's ahead-of-time ladder becomes eager execution plus a
:meth:`InferenceEngine.warmup` over every ladder size; the forward
contract is the same: exactly-ladder-sized batches of the wire dtype in,
float32 logits as numpy out, anything else refused loudly.

Not in this slice: ``:int8`` specs and ``stage``/``promote`` (continuous
deployment) raise ``NotImplementedError``; per-size CUDA graphs are later
work (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from distribuuuu_tpu_torch import resolve_device
from distribuuuu_tpu_torch.convert import load_weights
from distribuuuu_tpu_torch.data.transforms import device_normalize
from distribuuuu_tpu_torch.logging import logger
from distribuuuu_tpu_torch.models import build_model

QUANT_MODES = ("int8",)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ModelSpec:
    """One hosted model: routing name, zoo arch, weights file, quant mode."""

    name: str
    arch: str
    weights: str
    quant: str = ""


def parse_model_specs(entries: list[str]) -> list[ModelSpec]:
    """Parse ``SERVE.MODELS`` entries (``"name=arch@weights_path[:int8]"``).

    Malformed entries and duplicate names raise with the full entry. Only
    an exact known quant mode is stripped from the tail, so weight paths
    containing ``:`` parse unchanged.
    """
    specs: list[ModelSpec] = []
    seen: set[str] = set()
    for entry in entries:
        head, sep, weights = str(entry).partition("@")
        name, sep2, arch = head.partition("=")
        quant = ""
        base, colon, tail = weights.rpartition(":")
        if colon and tail in QUANT_MODES:
            weights, quant = base, tail
        if not (sep and sep2 and name and arch and weights):
            raise ValueError(
                f"SERVE.MODELS entry {entry!r} is not 'name=arch@weights_path' "
                f"(e.g. 'rn50=resnet50@/weights/resnet50.pt')"
            )
        if name in seen:
            raise ValueError(f"SERVE.MODELS: duplicate model name {name!r}")
        seen.add(name)
        specs.append(ModelSpec(name=name, arch=arch, weights=weights, quant=quant))
    return specs


@dataclass
class HostedModel:
    """One model's module on the device."""

    spec: ModelSpec
    module: torch.nn.Module
    load_s: float = 0.0


class InferenceEngine:
    """Hosts N models on one device behind a fixed batch ladder.

    ``device=None`` means the card and raises when there is none; the CPU
    is used only when passed explicitly (``device="cpu"``), as the tests do.
    """

    def __init__(
        self,
        *,
        batch_sizes: list[int],
        im_size: int,
        num_classes: int,
        input_dtype: str = "uint8",
        compute_dtype: str = "float32",
        device=None,
    ):
        self.device = resolve_device(device)
        sizes = [int(b) for b in batch_sizes]
        if not sizes or len(set(sizes)) != len(sizes):
            raise ValueError(f"SERVE.BATCH_SIZES must be distinct, got {batch_sizes}")
        if any(b < 1 for b in sizes):
            raise ValueError(f"SERVE.BATCH_SIZES must be >= 1, got {batch_sizes}")
        if input_dtype not in ("uint8", "float32"):
            raise ValueError(f"SERVE.INPUT_DTYPE must be uint8/float32, got {input_dtype!r}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute dtype must be bfloat16/float32, got {compute_dtype!r}")
        self.batch_sizes = sorted(sizes)
        self.im_size = int(im_size)
        self.num_classes = int(num_classes)
        self.input_dtype = np.dtype(input_dtype)
        self.compute_dtype = _DTYPES[compute_dtype]
        self._lock = threading.Lock()
        self.models: dict[str, HostedModel] = {}
        self.forwards = 0  # forward passes executed, warmup included

    # -- loading -------------------------------------------------------------

    def load(self, spec: ModelSpec) -> HostedModel:
        """Load one model's weights onto the device."""
        if spec.quant:
            raise NotImplementedError(
                f"{spec.name}: ':{spec.quant}' serving is not ported yet "
                f"(ROADMAP.md Queue 1, item 'Quant')"
            )
        if spec.arch.startswith("mae_"):
            raise ValueError(f"{spec.name}: {spec.arch} emits pixel reconstructions, not class "
                             f"logits; it trains with TRAIN.TASK mae and is not served")
        with self._lock:
            if spec.name in self.models:
                raise ValueError(f"model {spec.name!r} already hosted")
        tic = time.time()
        module = build_model(spec.arch, num_classes=self.num_classes, dtype=self.compute_dtype,
                             im_size=self.im_size)
        module.load_state_dict(load_weights(spec.weights), strict=True)
        module = module.to(self.device, memory_format=torch.channels_last).eval()
        hosted = HostedModel(spec, module, time.time() - tic)
        with self._lock:
            if spec.name in self.models:
                raise ValueError(f"model {spec.name!r} already hosted")
            self.models[spec.name] = hosted
        logger.info(
            f"serve: hosted {spec.name} ({spec.arch}) from {spec.weights} on "
            f"{self.device}: weights {hosted.load_s:.2f}s, ladder {self.batch_sizes}"
        )
        return hosted

    def load_all(self, specs: list[ModelSpec]) -> None:
        for spec in specs:
            self.load(spec)

    def stage(self, name: str, weights: str):
        raise NotImplementedError(
            "continuous deployment (stage/promote) is not ported yet "
            "(ROADMAP.md Queue 1, item 'Serving')"
        )

    promote = stage

    def warmup(self) -> float:
        """Run every (model, ladder size) once on zeros, so cuDNN's first-call
        setup and the kernel build stay off the first request's latency."""
        tic = time.time()
        with self._lock:
            names = list(self.models)
        for name in names:
            for b in self.batch_sizes:
                self.forward(name, np.zeros((b, self.im_size, self.im_size, 3), self.input_dtype))
        wall = time.time() - tic
        logger.info(f"serve: warmup ran every (model, batch) pair in {wall:.2f}s")
        return wall

    # -- inference -----------------------------------------------------------

    def hosted(self, name: str) -> HostedModel:
        with self._lock:
            hosted = self.models.get(name)
            hosting = ", ".join(sorted(self.models))
        if hosted is None:
            raise KeyError(f"unknown model {name!r}; hosting: {hosting}")
        return hosted

    def forward(self, name: str, batch: np.ndarray) -> np.ndarray:
        """Run one exactly-ladder-sized batch; returns float32 logits.

        The batcher owns padding; this layer refuses non-ladder sizes and
        wrong dtypes. Copying the logits to the host is the one sync.
        """
        hosted = self.hosted(name)
        b = int(batch.shape[0])
        if b not in self.batch_sizes:
            raise ValueError(
                f"batch size {b} is not in {name!r}'s ladder {self.batch_sizes} — "
                f"pad to a ladder size first"
            )
        if batch.dtype != self.input_dtype:
            raise ValueError(
                f"batch dtype {batch.dtype} != the engine's input dtype "
                f"{self.input_dtype} (SERVE.INPUT_DTYPE)"
            )
        expected = (self.im_size, self.im_size, 3)
        if tuple(batch.shape[1:]) != expected:
            raise ValueError(f"batch images are {tuple(batch.shape[1:])}, expected {expected}")
        with torch.inference_mode():
            images = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
            logits = hosted.module(device_normalize(images)).float().cpu().numpy()
        with self._lock:
            self.forwards += 1
        return logits

    def forward_timed(self, name: str, batch: np.ndarray) -> tuple[np.ndarray, float]:
        """`forward` plus its wall in ms, the result fetch included."""
        tic = time.monotonic()
        logits = self.forward(name, batch)
        return logits, 1000.0 * (time.monotonic() - tic)

    def runner(self) -> Callable[[str, np.ndarray], np.ndarray]:
        """The batcher-facing dispatch callable."""
        return self.forward
