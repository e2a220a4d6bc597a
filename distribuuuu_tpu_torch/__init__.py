"""distribuuuu_tpu_torch: the PyTorch/CUDA port of distribuuuu_tpu for NVIDIA Hopper.

It serves the classification zoo (``python -m
distribuuuu_tpu_torch.serve``), with the fused conv epilogue and BoTNet's
attention running as hand-written CUDA kernels; trains and evaluates the
whole zoo (``python -m distribuuuu_tpu_torch.train_net`` / ``test_net``),
MAE pretraining included, on a JPEG ImageFolder or its tar shards, every
BN through the epilogue kernel forward and its backward kernel, with
``MODEL.REMAT`` and ``MODEL.PRETRAINED`` (provisioned by ``python -m
distribuuuu_tpu_torch.convert``); and trains the expert-parallel switch-MoE layer
(``parallel.switch_moe``) over a ``torch.distributed`` group on
hand-written dispatch and combine kernels.
Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a card and
without that explicit choice they raise.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and raises
    when there is none. The CPU is used only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; distribuuuu_tpu_torch runs on the "
                "GPU unless the caller passes device='cpu' explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)
