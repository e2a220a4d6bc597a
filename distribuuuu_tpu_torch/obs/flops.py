"""Step FLOPs and MFU (counterpart of ``obs/flops.py``).

Model FLOPs utilization is achieved model FLOP/s over the hardware's peak.
Three pieces live here:

- **The step's cost** (:func:`step_flops`), in place of JAX's
  ``lowered_step_cost``: the config's model is built on the ``meta``
  device and one step's forward, loss and backward run under
  ``torch.utils.flop_counter.FlopCounterMode``, once a run, before the
  run's model is built. A process's first count takes seconds, most of
  them the import of ``torch._dynamo`` behind the mode's dispatch
  (ResNet-50 b128: 6.7-10.5 s on an H100 machine's host); ``OBS.MFU
  False`` skips it. A meta tensor is not a CUDA
  tensor, so every kernel wrapper
  takes its plain version and nothing launches on the card. The count is
  of one batch rank's step (``TRAIN.BATCH_SIZE x ACCUM_STEPS`` samples),
  multiplied by the batch ranks of the run, so it is per **global** step
  as JAX's lowered module is; a seq group computes one batch rank's
  tokens between its members. ``MODEL.REMAT`` counts the recompute.
- **The counting convention.** This is FlopCounterMode's count: the full
  kernel window of every convolution (the taps that fall in the padding
  included), 2 FLOPs a multiply-add, products only (matmuls, convolutions,
  attention; no elementwise op). XLA's lowered count differs: it counts
  only the taps that land inside the unpadded input, and it adds
  elementwise ops. For a ResNet-18 step at 64^2, batch 8, it reads 0.790
  of this count (jax 0.9.0 on the CPU): at that size the last stage's
  feature map is 2x2 and most 3x3 taps fall in the padding; for a
  ResNet-50 step at 224^2 it reads 0.986 (``tests/test_torch_obs.py``
  holds both to the inner-tap hand count).
- **Peak table + :func:`mfu`**: dense bf16 tensor-core FLOP/s by the card's
  name (:func:`peak_flops_per_device`); the CPU and unknown cards give
  None and MFU is omitted, never made up; ``OBS.PEAK_TFLOPS_PER_DEVICE``
  overrides.
"""

from __future__ import annotations

import time

import torch

from distribuuuu_tpu_torch.logging import logger

# Dense bf16 tensor-core TFLOP/s a card, from NVIDIA's H100 datasheet (the
# sparse figures are twice these), keyed by lower-case substrings of
# ``torch.cuda.get_device_name()``; the longest matching key wins.
_PEAK_BF16_TFLOPS: dict[str, float] = {
    "h100 80gb hbm3": 989.4,
    "h100 sxm": 989.4,
    "h100 pcie": 756.0,
}


def peak_flops_per_device(device=None, override_tflops: float = 0.0) -> float | None:
    """Peak dense FLOP/s of one card, or None when unknown.

    ``override_tflops`` (``OBS.PEAK_TFLOPS_PER_DEVICE``) wins when > 0;
    else the table, by the longest key found in the card's name. The CPU
    and an unknown card give None."""
    if override_tflops and override_tflops > 0:
        return float(override_tflops) * 1e12
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    return peak_for_kind(torch.cuda.get_device_name(device))


def peak_for_kind(kind: str) -> float | None:
    """The table's FLOP/s for a card's name (the longest key found in it),
    or None."""
    kind = kind.lower()
    best = None
    for key, tflops in _PEAK_BF16_TFLOPS.items():
        if key in kind and (best is None or len(key) > len(best[0])):
            best = (key, tflops)
    return best[1] * 1e12 if best else None


def step_flops(batch_ranks: int = 1) -> float | None:
    """FLOPs of one **global** training step of the live config: one batch
    rank's forward, loss and backward counted on the meta device, times
    ``batch_ranks`` (the processes reading distinct batch shards). None,
    logged, when the count fails: MFU is then omitted for the run."""
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.models import layers
    from distribuuuu_tpu_torch.metrics import cross_entropy_loss
    from distribuuuu_tpu_torch.trainer import build_cfg_model, mae_loss
    from torch.utils.flop_counter import FlopCounterMode

    tic = time.perf_counter()
    try:
        with torch.device("meta"):
            model = build_cfg_model().train()
        for m in model.modules():  # a draw costs no counted FLOP; the meta device has no generator
            if isinstance(m, layers.RandomMask):
                m.rate = 0.0
        n = cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.ACCUM_STEPS
        im = cfg.TRAIN.IM_SIZE
        x = torch.empty((n, im, im, 3), device="meta")
        with FlopCounterMode(display=False) as counter:
            if cfg.TRAIN.TASK == "mae":
                tokens = (im // model.patch) ** 2
                loss = mae_loss(model, x, torch.zeros((n, tokens), dtype=torch.bool,
                                                      device="meta"))
            else:
                labels = torch.zeros((n,), dtype=torch.long, device="meta")
                loss = cross_entropy_loss(model(x), labels, cfg.TRAIN.LABEL_SMOOTH)
            loss.backward()
        flops = float(counter.get_total_flops()) * max(1, int(batch_ranks))
    except Exception as exc:  # a model the meta device cannot run: MFU is optional
        logger.info(f"step cost unavailable ({exc!r}); MFU disabled")
        return None
    logger.info(f"step cost (FlopCounterMode on the meta device): {flops:.4e} FLOPs a global "
                f"step, priced in {time.perf_counter() - tic:.2f} s")
    return flops


def mfu(
    flops_per_step: float | None,
    step_time_s: float,
    device_count: int,
    peak_flops_per_dev: float | None,
) -> float | None:
    """Model FLOPs utilization in [0, 1]: achieved FLOP/s over fleet peak.

    ``flops_per_step`` is per *global* step (the convention above); the
    fleet peak is ``device_count * peak_flops_per_dev``. Returns None when
    either the step cost or the hardware peak is unknown.
    """
    if not flops_per_step or not peak_flops_per_dev or step_time_s <= 0:
        return None
    if device_count <= 0:
        return None
    return (flops_per_step / step_time_s) / (device_count * peak_flops_per_dev)
