"""Parallelism of the port: expert-parallel switch MoE over ``torch.distributed``."""

from distribuuuu_tpu_torch.parallel.moe import switch_moe, token_slot_positions

__all__ = ["switch_moe", "token_slot_positions"]
