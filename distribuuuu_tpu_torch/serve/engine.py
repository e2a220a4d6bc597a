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

Continuous deployment (``serve/deploy.py``) adds a second slot a model:
:meth:`InferenceEngine.stage` builds an incoming version beside the serving
one with the incumbent's spec (for ``:int8`` its own calibration, gate and
prune) and runs every ladder size once before any canary request,
``forward(..., version="canary")`` reaches it, and :meth:`promote` or
:meth:`discard_staged` settle the rollout by dropping the engine's
reference to the old or the staged version. The registries change under
``_lock`` (dict operations only, never across a build or a forward), and a
forward keeps its own reference, so an in-flight batch finishes on the
version it started with before that version's tensors are freed. A weights
path may be a ``.pt`` state_dict or one of the port's checkpoint
directories (``checkpoint.pt`` and its manifest, verified first when
``verify_integrity``); each hosted version reports :func:`version_of`.

Not in this slice: per-size CUDA graphs (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np
import torch

from distribuuuu_tpu_torch import checkpoint as ckpt
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


def version_of(weights_path: str) -> dict:
    """What a weights path is: its checkpoint position (epoch and step from
    the checkpoint naming contract, as ``checkpoint.watch_candidates`` ranks
    them; -1/-1 for any other path) and its manifest's hash ("" without
    one). ``GET /healthz`` reports it a model; the deploy watcher orders
    candidates against it."""
    name = str(weights_path).rstrip("/").rsplit("/", 1)[-1]
    epoch, step = -1, -1
    m = ckpt._CKPT_RE.match(name)
    if m:
        epoch, step = int(m.group(1)), 0
    elif (m := ckpt._MID_RE.match(name)):
        epoch, step = int(m.group(1)), int(m.group(2))
    return {"path": str(weights_path), "epoch": epoch, "step": step,
            "manifest_hash": ckpt.manifest_hash(weights_path)}


def _state_dict(path: str, verify_integrity: bool) -> dict:
    """The model state_dict at ``path``: a ``.pt``/``.pth`` file, or one of
    the port's checkpoint directories (its manifest verified first when
    ``verify_integrity``; a corrupt one raises)."""
    if os.path.isfile(os.path.join(str(path), ckpt._FILE_NAME)):
        if verify_integrity:
            status, errors = ckpt.verify_checkpoint(path)
            if status == "corrupt":
                raise ValueError(f"{path} fails its manifest: {'; '.join(errors[:3])}")
        return torch.load(os.path.join(str(path), ckpt._FILE_NAME), map_location="cpu",
                          weights_only=True)["model"]
    return load_weights(path)


@dataclass
class HostedModel:
    """One model's module on the device. An int8 model's module is the
    quantized one (``quant.prune_variables``); ``gate`` is its quality-gate
    measurement, ``quant_s`` the calibrate+quantize+gate wall and
    ``resident_bytes`` what its weights held on the card before and after
    the fp ones were freed (``torch.cuda.memory_allocated`` deltas);
    ``version`` is :func:`version_of` its weights, ``warmed`` the ladder
    sizes a staged version ran before its canary."""

    spec: ModelSpec
    module: torch.nn.Module
    load_s: float = 0.0
    gate: Any = None
    quant_s: float = 0.0
    resident_bytes: dict = field(default_factory=dict)
    version: dict = field(default_factory=dict)
    warmed: list = field(default_factory=list)


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
        verify_integrity: bool = True,
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
        self.verify_integrity = bool(verify_integrity)
        # the registries change on the deploy thread (stage, promote,
        # discard) while the dispatch threads resolve names through them:
        # _lock covers dict operations only, never a build or a forward
        self._lock = threading.Lock()
        self.models: dict[str, HostedModel] = {}
        self.staged: dict[str, HostedModel] = {}  # incoming versions under canary
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
        with self._lock:
            if spec.name in self.models:
                raise ValueError(f"model {spec.name!r} already hosted")
        hosted = self._build_hosted(spec)
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

    def _build_hosted(self, spec: ModelSpec) -> HostedModel:
        """Build, load and (for an ``:int8`` spec) quantize one version
        without registering it: :meth:`load`'s and :meth:`stage`'s."""
        if spec.arch.startswith("mae_"):
            raise ValueError(f"{spec.name}: {spec.arch} emits pixel reconstructions, not class "
                             f"logits; it trains with TRAIN.TASK mae and is not served")
        tic = time.time()
        base = self._allocated()
        module = build_model(spec.arch, num_classes=self.num_classes, dtype=self.compute_dtype,
                             im_size=self.im_size)
        module.load_state_dict(_state_dict(spec.weights, self.verify_integrity), strict=True)
        module = module.to(self.device, memory_format=torch.channels_last).eval()
        hosted = HostedModel(spec, module, time.time() - tic, version=version_of(spec.weights))
        if spec.quant:
            fp_bytes = self._allocated() - base
            int8_bytes = fp_bytes + self._quantize(hosted)
            if self.device.type == "cuda":
                hosted.resident_bytes = {"fp": fp_bytes, "int8": int8_bytes}
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

    # -- continuous deployment (serve/deploy.py) -----------------------------

    def stage(self, name: str, weights: str) -> HostedModel:
        """Build an incoming version of hosted model ``name`` from
        ``weights`` with the incumbent's spec (an ``:int8`` one runs its own
        calibration, gate and prune: a failed gate raises and nothing is
        staged), run every ladder size once on zeros (each a
        ``serve_compile`` record), and hold it for ``version="canary"``
        forwards. The incumbent keeps serving throughout."""
        incumbent = self.hosted(name)
        with self._lock:
            if name in self.staged:
                raise ValueError(f"model {name!r} already has a staged version")
        hosted = self._build_hosted(replace(incumbent.spec, weights=str(weights)))
        tic = time.time()
        for b in self.batch_sizes:
            t0 = time.time()
            self._run(hosted, np.zeros((b, self.im_size, self.im_size, 3), self.input_dtype))
            hosted.warmed.append(b)
            self.aot_compiles += 1
            self._event("serve_compile", model=name, batch_size=b,
                        wall_s=round(time.time() - t0, 4), quant=hosted.spec.quant)
        with self._lock:
            if name in self.staged:
                raise ValueError(f"model {name!r} already has a staged version")
            self.staged[name] = hosted
        logger.info(f"serve: staged {name} <- {weights} (weights {hosted.load_s:.2f}s, ladder "
                    f"{self.batch_sizes} run in {time.time() - tic:.2f}s; incumbent "
                    f"{incumbent.version.get('path', '?')} still serving)")
        return hosted

    def promote(self, name: str) -> dict:
        """Make the staged version the serving one; returns the old version
        (:func:`version_of`). The engine drops its reference to the old
        version, whose tensors are freed once a batch still running on it
        returns; a dispatch resolving ``name`` meanwhile sees the old or the
        new version, never neither."""
        with self._lock:
            staged = self.staged.pop(name, None)
            if staged is None:
                raise ValueError(f"model {name!r} has no staged version to promote")
            old = self.models[name]
            self.models[name] = staged
        logger.info(f"serve: promoted {name} -> {staged.version.get('path', '?')} (retired "
                    f"{old.version.get('path', '?')})")
        return dict(old.version)

    def discard_staged(self, name: str) -> None:
        """Drop the staged version of ``name`` (a failed canary), freed once
        a canary batch still running on it returns."""
        with self._lock:
            self.staged.pop(name, None)

    def versions(self) -> dict[str, dict]:
        """Each model's serving version, with the staged one beside it while
        a rollout is in flight (the ``/healthz`` payload)."""
        with self._lock:
            hosted, staged = list(self.models.items()), dict(self.staged)
        out = {}
        for name, h in hosted:
            v = dict(h.version)
            if name in staged:
                v["staged"] = dict(staged[name].version)
            out[name] = v
        return out

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

    def forward(self, name: str, batch: np.ndarray, version: str = "live") -> np.ndarray:
        """Run one exactly-ladder-sized batch; returns float32 logits.

        The batcher owns padding; this layer refuses non-ladder sizes and
        wrong dtypes. Copying the logits to the host is the one sync.
        ``version="canary"`` runs the staged version when there is one (a
        canary-routed retry after the rollout settled takes the incumbent).
        """
        hosted = self.hosted(name)
        if version == "canary":
            with self._lock:
                hosted = self.staged.get(name, hosted)
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
        return self._run(hosted, batch)

    def _run(self, hosted: HostedModel, batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            images = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
            logits = hosted.module(device_normalize(images)).float().cpu().numpy()
        with self._lock:
            self.forwards += 1
        return logits

    def forward_timed(self, name: str, batch: np.ndarray,
                      version: str = "live") -> tuple[np.ndarray, float]:
        """`forward` plus its wall in ms, the result fetch included."""
        tic = time.monotonic()
        logits = self.forward(name, batch, version=version)
        return logits, 1000.0 * (time.monotonic() - tic)

    def runner(self) -> Callable[[str, np.ndarray], np.ndarray]:
        """The batcher-facing dispatch callable."""
        return self.forward
