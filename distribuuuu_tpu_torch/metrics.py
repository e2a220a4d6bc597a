"""Loss, accuracy counts and meters (the port's copy of ``metrics.py``).

The step computes on-device count sums (:func:`topk_correct`) that the
trainer keeps on the card and fetches once per ``TRAIN.PRINT_FREQ`` window;
the meters below are fed from those fetched sums, never from per-step host
reads.
"""

from __future__ import annotations

import datetime
import time

import torch
import torch.nn.functional as F

from distribuuuu_tpu_torch.logging import logger


def _topk_rank(logits, labels):
    """Rank of the true label among the logits: the count of logits strictly
    greater than the true label's (ties count in its favour); in top-k iff
    rank < k. No sort."""
    true_logit = logits.gather(-1, labels[:, None].long())
    return (logits > true_logit).sum(-1)


def topk_correct(logits, labels, ks=(1, 5)) -> dict:
    """Per-k float32 count of samples whose true label is in the top-k logits."""
    rank = _topk_rank(logits, labels)
    return {k: (rank < k).sum().float() for k in ks}


def topk_correct_weighted(logits, labels, weights, ks=(1, 5)) -> dict:
    """:func:`topk_correct` with per-sample weights (zero-weight padding)."""
    rank = _topk_rank(logits, labels)
    return {k: ((rank < k).float() * weights).sum() for k in ks}


def per_example_nll(logits, labels):
    """Float32 per-example negative log-likelihood."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    return -log_probs.gather(-1, labels[:, None].long())[:, 0]


def cross_entropy_loss(logits, labels, label_smooth: float = 0.0):
    """Mean softmax cross-entropy in float32, with optional label smoothing:
    ``(1 - s) * nll + s * mean(-log_probs)`` per example, term for term as
    the JAX package's."""
    nll = per_example_nll(logits, labels)
    if label_smooth > 0.0:
        log_probs = F.log_softmax(logits.float(), dim=-1)
        smooth_loss = -log_probs.mean(-1)
        nll = (1.0 - label_smooth) * nll + label_smooth * smooth_loss
    return nll.mean()


class AverageMeter:
    """Running average of a scalar (``val``/``avg``/``sum``/``count``,
    ``update(val, n)``); ``avg``/``val`` are writable for callers that
    mirror exact totals kept elsewhere."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """Formatted progress line with this epoch's and the whole run's ETA."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.batch_fmtstr = self._get_batch_fmtstr(num_batches)
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix
        self._run = None  # (tic, cur_epoch, start_epoch, max_epoch)

    def configure_run_eta(self, *, tic: float, cur_epoch: int, start_epoch: int,
                          max_epoch: int) -> None:
        """Extrapolate the whole run's remaining time over the epochs run in
        this process since ``tic``."""
        self._run = (tic, cur_epoch, start_epoch, max_epoch)

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(meter) for meter in self.meters]
        entries.append(self.cal_eta(batch))
        run_eta = self.cal_run_eta(batch)
        if run_eta:
            entries.append(run_eta)
        logger.info("  ".join(entries))

    def cal_eta(self, batch: int) -> str:
        time_meter = next((m for m in self.meters if m.name == "Time"), None)
        if time_meter is None or batch == 0:
            return "ETA: N/A"
        remain = max(self.num_batches - batch, 0)
        return f"ETA: {datetime.timedelta(seconds=int(time_meter.avg * remain))}"

    def cal_run_eta(self, batch: int) -> str | None:
        if self._run is None:
            return None
        tic, cur_epoch, start_epoch, max_epoch = self._run
        frac = batch / max(self.num_batches, 1)
        ratio_running = (cur_epoch - start_epoch + frac) / max_epoch
        if ratio_running <= 0:
            return "ETA(run): N/A"
        ratio_remaining = 1.0 - (cur_epoch + frac) / max_epoch
        seconds = round((time.time() - tic) / ratio_running * max(ratio_remaining, 0.0))
        return f"ETA(run): {datetime.timedelta(seconds=seconds)}"

    @staticmethod
    def _get_batch_fmtstr(num_batches: int) -> str:
        fmt = "{:" + str(len(str(num_batches // 1))) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"


def construct_meters(num_batches: int, prefix: str, topk: int = 5):
    """The meter set Time/Data/Loss/Acc@1/Acc@k and its progress line."""
    batch_time = AverageMeter("Time", ":.3f")
    data_time = AverageMeter("Data", ":.3f")
    losses = AverageMeter("Loss", ":.4e")
    top1 = AverageMeter("Acc@1", ":6.2f")
    topk_m = AverageMeter(f"Acc@{topk}", ":6.2f")
    meters = [batch_time, data_time, losses, top1, topk_m]
    progress = ProgressMeter(num_batches, meters, prefix=prefix)
    return batch_time, data_time, losses, top1, topk_m, progress


def count_parameters(model) -> float:
    """Parameter count in millions."""
    return sum(p.numel() for p in model.parameters()) / 1e6
