"""Multi-model inference engine: the compute half of the port's serving path.

Counterpart of ``distribuuuu_tpu/serve/engine.py``. Each hosted model is a
zoo model (a ResNet or BoTNet-50, built for ``SERVE.IM_SIZE`` crops) loaded
from a torch state_dict onto one device, channels-last, in eval mode. The
JAX engine's ahead-of-time ladder becomes eager execution plus a
:meth:`InferenceEngine.warmup` over every ladder size; the forward
contract is the same: exactly-ladder-sized batches of the wire dtype in,
float32 logits as numpy out, anything else refused loudly.

The port compiles nothing ahead of time. The counterpart of the JAX
engine's per-(model, size) compile is the warmup's forward at each ladder
size, where cuDNN picks its plans and the first launch is paid: each
journals a ``serve_compile`` record with that forward's ``wall_s``, and
:attr:`InferenceEngine.aot_compiles` counts them (``serve_start`` carries
the count).

A spec ending in ``:int8`` hosts the post-training-quantized model
(``quant/``, JAX's dtpu-quant): calibrated on seeded synthetic batches of
the wire dtype, quantized, then gated against the fp forward on
deterministic inputs (top-1 agreement and logit RMSE against ``QUANT``'s
thresholds). A failed gate refuses to serve unless ``QUANT.GATE`` is off;
the measurement is journaled as a ``quant_quality`` record either way. The
hosted module is then the int8 one, its fp weights freed.

Not in this slice: ``stage``/``promote`` (continuous deployment) raise
``NotImplementedError``; per-size CUDA graphs are later work (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from distribuuuu_tpu_torch import resolve_device
from distribuuuu_tpu_torch.convert import golden_inputs, load_weights
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
    """One model's module on the device. An int8 model's module is the
    quantized one (``quant.prune_variables``); ``gate`` is its quality-gate
    measurement, ``quant_s`` the calibrate+quantize+gate wall and
    ``resident_bytes`` what its weights held on the card before and after
    the fp ones were freed (``torch.cuda.memory_allocated`` deltas)."""

    spec: ModelSpec
    module: torch.nn.Module
    load_s: float = 0.0
    gate: Any = None
    quant_s: float = 0.0
    resident_bytes: dict = field(default_factory=dict)


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
        journal_event: Callable[..., None] | None = None,
        quant_cfg: dict | None = None,
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
        self.aot_compiles = 0  # warmup forwards journaled as serve_compile
        self._event = journal_event or (lambda kind, **fields: None)
        # cfg.QUANT's knobs, engine-shaped (ServeReplica builds this dict; a
        # bare engine in tests gets the same defaults)
        q = dict(quant_cfg or {})
        self.quant_cfg = {
            "calib_batches": int(q.get("calib_batches", 4)),
            "calib_batch_size": int(q.get("calib_batch_size", 8)),
            "calib_seed": int(q.get("calib_seed", 1234)),
            "gate": bool(q.get("gate", True)),
            "gate_n": int(q.get("gate_n", 16)),
            "gate_seed": int(q.get("gate_seed", 0)),
            "min_top1_agree": float(q.get("min_top1_agree", 0.99)),
            "max_logit_rmse": float(q.get("max_logit_rmse", 0.25)),
        }

    # -- loading -------------------------------------------------------------

    def load(self, spec: ModelSpec) -> HostedModel:
        """Load one model's weights onto the device (and quantize it, for an
        ``:int8`` spec)."""
        if spec.arch.startswith("mae_"):
            raise ValueError(f"{spec.name}: {spec.arch} emits pixel reconstructions, not class "
                             f"logits; it trains with TRAIN.TASK mae and is not served")
        with self._lock:
            if spec.name in self.models:
                raise ValueError(f"model {spec.name!r} already hosted")
        tic = time.time()
        base = self._allocated()
        module = build_model(spec.arch, num_classes=self.num_classes, dtype=self.compute_dtype,
                             im_size=self.im_size)
        module.load_state_dict(load_weights(spec.weights), strict=True)
        module = module.to(self.device, memory_format=torch.channels_last).eval()
        hosted = HostedModel(spec, module, time.time() - tic)
        if spec.quant:
            fp_bytes = self._allocated() - base
            int8_bytes = fp_bytes + self._quantize(hosted)
            if self.device.type == "cuda":
                hosted.resident_bytes = {"fp": fp_bytes, "int8": int8_bytes}
        with self._lock:
            if spec.name in self.models:
                raise ValueError(f"model {spec.name!r} already hosted")
            self.models[spec.name] = hosted
        quant_note = f" [{spec.quant}]" if spec.quant else ""
        logger.info(
            f"serve: hosted {spec.name} ({spec.arch}{quant_note}) from {spec.weights} on "
            f"{self.device}: weights {hosted.load_s:.2f}s, ladder {self.batch_sizes}"
        )
        return hosted

    def _allocated(self) -> int:
        """Bytes the card's allocator holds in tensors (0 off the card)."""
        return torch.cuda.memory_allocated(self.device) if self.device.type == "cuda" else 0

    # -- int8 (quant/) -------------------------------------------------------

    def _synthetic_batches(self, n_batches: int, batch_size: int, seed: int) -> list:
        """Seeded wire-dtype calibration batches (uint8 pixels or
        post-normalization floats, matching what requests will carry)."""
        rng = np.random.default_rng(seed)
        shape = (batch_size, self.im_size, self.im_size, 3)
        batches = []
        for _ in range(n_batches):
            if self.input_dtype == np.uint8:
                batches.append(rng.integers(0, 256, size=shape, dtype=np.uint8))
            else:
                batches.append(np.asarray(rng.standard_normal(shape), np.float32))
        return batches

    def _gate_inputs(self, n: int, seed: int) -> np.ndarray:
        """Deterministic gate inputs: `convert.golden_inputs` for float wire,
        seeded uint8 pixels otherwise."""
        if self.input_dtype == np.uint8:
            rng = np.random.default_rng(seed)
            return rng.integers(0, 256, size=(n, self.im_size, self.im_size, 3), dtype=np.uint8)
        return golden_inputs(n, self.im_size, seed)

    def _quantize(self, hosted: HostedModel) -> int:
        """Calibrate -> quantize -> quality-gate one hosted model, then make
        its module the int8 one and free the fp weights it no longer reads.
        A failed gate raises (refuse to serve) unless ``QUANT.GATE`` is
        off; the measurement is journaled as a ``quant_quality`` record in
        every case. Returns what the int8 module holds on the card less
        what the fp one held, from two allocator deltas: what quantizing
        allocated and what the prune then freed (so a cuBLAS workspace made
        by the calibration's first GEMM counts in neither)."""
        from distribuuuu_tpu_torch.quant import (
            calibrate,
            compare_logits,
            prune_variables,
            quantize,
        )
        from distribuuuu_tpu_torch.quant.ptq import supported

        spec, module, qc = hosted.spec, hosted.module, self.quant_cfg
        if not supported(module):
            raise NotImplementedError(
                f"{spec.name}: ':{spec.quant}' serving takes the ResNet family and DenseNet; "
                f"{spec.arch} is not ported to it yet (ROADMAP Queue 1 item 8c)")
        tic = time.time()

        def fwd(images):
            # the serve pipeline, device_normalize included: activation
            # ranges are recorded where requests will land
            return module(device_normalize(images)).float()

        def on_device(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        with torch.inference_mode():
            batches = [on_device(b) for b in self._synthetic_batches(
                qc["calib_batches"], qc["calib_batch_size"], qc["calib_seed"])]
            sites = calibrate(module, batches, apply_fn=fwd)
            del batches
            before = self._allocated()
            qmodel, qparams = quantize(module, sites)
            quantized = self._allocated() - before
            gate_x = on_device(self._gate_inputs(qc["gate_n"], qc["gate_seed"]))
            fp_logits = fwd(gate_x).cpu().numpy()
            q_logits = qmodel.apply(module, qparams, gate_x, apply_fn=fwd).cpu().numpy()
            del gate_x
        result = compare_logits(fp_logits, q_logits, min_top1_agree=qc["min_top1_agree"],
                                max_logit_rmse=qc["max_logit_rmse"])
        hosted.gate = result
        hosted.quant_s = time.time() - tic
        self._event("quant_quality", model=spec.name, mode=spec.quant, **result.fields(),
                    calib_batches=qc["calib_batches"], layers=qmodel.n_quantized,
                    folded_bn=len(qmodel.folded), wall_s=round(hosted.quant_s, 3))
        logger.info(
            f"serve: {spec.name} int8 quality gate: top-1 agree "
            f"{100.0 * result.top1_agree:.2f}%, logit RMSE {result.logit_rmse:.4f} over "
            f"{result.n} fixture inputs ({qmodel.n_quantized} layer(s) quantized, "
            f"{len(qmodel.folded)} BN(s) folded) -> {'PASSED' if result.passed else 'FAILED'}"
        )
        if not result.passed:
            msg = (
                f"refusing to serve {spec.name!r} int8: quality gate failed "
                f"(top-1 agree {result.top1_agree:.4f} < "
                f"{qc['min_top1_agree']} or logit RMSE "
                f"{result.logit_rmse:.4f} > {qc['max_logit_rmse']} vs the "
                f"fp32 engine on {result.n} fixture inputs). Remedy: a "
                f"QUANT.QAT fine-tune (straight-through-estimator fake-quant "
                f"training, docs/PERFORMANCE.md 'Quantized training') moves "
                f"the weights to a quantization-robust minimum; re-serve the "
                f"fine-tuned checkpoint with the same ':int8' spec"
            )
            if qc["gate"]:
                raise RuntimeError(msg)
            logger.warning(msg + " — serving anyway (QUANT.GATE False)")
        # the gate needed the fp module; the served one does not: its sites
        # and folded BNs become the int8 modules and their fp tensors go
        before = self._allocated()
        prune_variables(module, qmodel, qparams)
        del qparams  # the int8 modules keep what they read
        return quantized - (before - self._allocated())

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
        setup and the kernel build stay off the first request's latency;
        each forward's wall (the logits' copy to the host included) is
        journaled as that pair's ``serve_compile``."""
        tic = time.time()
        with self._lock:
            hosted = [(name, h.spec.quant) for name, h in self.models.items()]
        for name, quant in hosted:
            for b in self.batch_sizes:
                t0 = time.time()
                self.forward(name, np.zeros((b, self.im_size, self.im_size, 3), self.input_dtype))
                self.aot_compiles += 1
                self._event("serve_compile", model=name, batch_size=b,
                            wall_s=round(time.time() - t0, 4), quant=quant)
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
