"""Training and evaluation loops of the port (counterpart of ``trainer.py``).

One process a GPU, data-parallel over the process group:

| JAX (shard_map over Mesh('data'))        | here                                        |
|------------------------------------------|---------------------------------------------|
| ``pmean(grads, 'data')``                  | one all-reduce of the flat gradient buffer (the loss rides in its last slot), divided by the world |
| ``pmean(new_stats)`` after every step     | one all-reduce of the flat BN-statistics buffer |
| SyncBN: BN ``axis_name='data'``           | ``BatchNorm.sync_group``: ``[E[x], E[x^2]]`` all-reduced in the forward |
| non-finite guard (``jnp.where(keep, ..)``) | the same selection on the flat buffers, ``keep`` a device bool |
| metric psums, fetched at PRINT_FREQ      | device sums per step, all-reduced and fetched at PRINT_FREQ |

:class:`TrainState` keeps every parameter as a view into one float32
buffer, its gradient as a view into a second and every BN running
statistic as a view into a third, so the collectives, the guard and the
optimizer each act on one tensor. On the card every BN runs K1 forward and
K1-bwd backward (53 of each per ResNet-50 or BoTNet-50 step, 121 per
DenseNet-121, 59 per RegNetY-16GF, 49 per EfficientNet-B0, none in ViT),
and BoTNet's MHSA the attention kernel and its backward kernel (3 of each
a step, the backward on its one-launch cluster route at 224^2, on the
blockwise route at 512^2); on the CPU their plain versions. Under
``MODEL.REMAT`` each block's forward runs again in the backward, so K1
and the attention launch once more a recomputed BN or attention (105 K1 a
ResNet-50 step: the stem's BN is not recomputed). Dropout and drop path
draw from a generator seeded each micro-step from ``(seed, epoch, step,
micro-step, rank)`` (:func:`dropout_seed`).

``TRAIN.TASK mae`` (an ``mae_*`` arch): the loss is the masked patches'
pixel MSE (:func:`mae_loss`); the mask is drawn first from the same
micro-step stream, on the device, so a resumed run draws it again; eval
uses one fixed mask from ``RNG_SEED or 0`` for every batch. The top-k
counters stay zero, so the meters and checkpoints are the classifier's.
``MODEL.PRETRAINED`` warm-starts from the port's converted checkpoint
(:func:`_pretrained_path`), without the optimizer.

Fault tolerance, as the JAX trainer's (:mod:`distribuuuu_tpu_torch.resilience`):
at every step boundary the watchdog is beaten, the fault injector may kill,
hang or preempt, and a preemption (SIGTERM, SIGINT, an injected step)
writes a mid-epoch checkpoint and raises ``Preempted``. One process reads
its preemption flag at every step; with several, each rank's flag rides
the all-reduce of the metric window (every ``TRAIN.PRINT_FREQ`` steps), so
every rank reads the same sum after the same step and stops at the next
boundary, with no added sync or collective a step. A resume re-enters the
epoch at the checkpoint's step (remapped from its sample offset on another
world size); non-finite steps back to back raise ``NonFiniteDivergence``.
"""

from __future__ import annotations

import importlib
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from distribuuuu_tpu_torch import checkpoint as ckpt
from distribuuuu_tpu_torch import optim, resilience
from distribuuuu_tpu_torch.config import cfg, dump_cfg, get_default, lookup
from distribuuuu_tpu_torch.data.loader import (
    DevicePrefetcher,
    HostDataLoader,
    construct_train_loader,
    construct_val_loader,
    service_address,
)
from distribuuuu_tpu_torch.data.transforms import device_normalize
from distribuuuu_tpu_torch.logging import logger, setup_logger
from distribuuuu_tpu_torch.metrics import (
    construct_meters,
    count_parameters,
    cross_entropy_loss,
    per_example_nll,
    topk_correct,
    topk_correct_weighted,
)
from distribuuuu_tpu_torch.models import build_model, layers
from distribuuuu_tpu_torch.models.mae import patchify
from distribuuuu_tpu_torch.ops import attention as att
from distribuuuu_tpu_torch.ops import epilogue as ep
from distribuuuu_tpu_torch.runtime.dist import setup_distributed
from distribuuuu_tpu_torch.runtime.seeding import configure_determinism, setup_seed

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _aligned_offsets(tensors) -> tuple[list[int], int]:
    """Offsets of ``tensors`` laid out one after another in a flat f32
    buffer, each rounded up to 4 elements so that every view starts 16 bytes
    aligned, as an allocation of its own would (K1's vector route and
    PyTorch's vectorised kernels need it; an odd-sized parameter, such as
    EfficientNet-B0's 6-wide SE bias, would misalign every view after it);
    and the buffer's length. The gaps hold zeros."""
    offsets, o = [], 0
    for t in tensors:
        o = -(-o // 4) * 4
        offsets.append(o)
        o += t.numel()
    return offsets, o


class TrainState:
    """A model, its flat parameter/gradient/statistics buffers and the
    optimizer. ``grads`` has one slot more than ``params``: the step's loss,
    all-reduced with the gradients. Each parameter and buffer is a 16-byte
    aligned view (:func:`_aligned_offsets`)."""

    def __init__(self, model: torch.nn.Module, group=None):
        self.model, self.group = model, group
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        offsets, total = _aligned_offsets([p for _, p in named])
        device = named[0][1].device
        self.params = torch.zeros(total, device=device)
        self.grads = torch.zeros(total + 1, device=device)
        self.segments = []
        for (_, p), o in zip(named, offsets):
            k = p.numel()
            self.params[o:o + k].copy_(p.detach().reshape(-1))
            p.data = self.params[o:o + k].view(p.shape)
            p.grad = self.grads[o:o + k].view(p.shape)
            self.segments.append((o, k, p.dim()))
        bufs = [b for _, b in model.named_buffers()]
        offsets, total = _aligned_offsets(bufs)
        self.stats = torch.zeros(total, device=device)
        for b, o in zip(bufs, offsets):
            self.stats[o:o + b.numel()].copy_(b.reshape(-1))
            b.data = self.stats[o:o + b.numel()].view(b.shape)
        self.optimizer = optim.construct_optimizer(self.params, self.segments)
        # the dropout and drop-path layers that draw in training, one
        # generator reseeded for them (and, before them, for an MAE model's
        # patch mask) each micro-step, and the base of its stream
        # (:func:`dropout_seed`), which a mid-epoch checkpoint carries as
        # JAX's carries its rng_key
        self.masks = [m for m in model.modules()
                      if isinstance(m, layers.RandomMask) and m.rate > 0.0]
        self.mask_generator = torch.Generator(device=device)
        self.dropout_seed: int | None = None

    @property
    def draws(self) -> bool:
        return bool(self.masks)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    def unflatten(self, flat: torch.Tensor) -> dict:
        """A flat parameter-shaped buffer (the momentum, say) by parameter name."""
        shapes = dict(self.model.named_parameters())
        return {n: flat[o:o + k].view(shapes[n].shape)
                for n, (o, k, _) in zip(self.names, self.segments)}


def dropout_seed(seed: int, epoch: int, step: int, micro: int, rank: int) -> int:
    """The seed of one micro-step's dropout stream on one rank, from
    ``(seed, epoch, step, micro, rank)`` alone, as JAX folds ``epoch``,
    ``step`` and the device into its key and splits it per micro-step.
    Ranks draw different masks, and a resumed run draws the same ones
    without any saved generator state."""
    hi, lo = np.random.SeedSequence([seed, epoch, step, micro, rank]).generate_state(2)
    return (int(hi) << 32 | int(lo)) >> 1


def mae_loss(model, images: torch.Tensor, mask: torch.Tensor, weights=None) -> torch.Tensor:
    """The masked-autoencoder loss of JAX's ``_forward_loss_mae``: ``model``
    (an ``mae_*`` arch) on the normalised NHWC ``images`` with ``mask``
    (``[B, L]`` bool, True: masked), each patch's mean squared error in f32
    against :func:`patchify` of the images, summed over the masked patches
    (each weighted by its sample's ``weights``, when given: a padded eval
    sample counts for nothing) and divided by their count, at least 1."""
    pred = model(images, mask)
    target = patchify(images.float(), model.patch)
    mask_f = mask.float()
    if weights is not None:
        mask_f = mask_f * weights.float()[:, None]
    err = (pred.float() - target).square().mean(-1)  # [B, L]
    return (err * mask_f).sum() / mask_f.sum().clamp_min(1.0)


def mae_mask(n: int, tokens: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """``[n, tokens]`` Bernoulli(``MODEL.MAE_MASK_RATIO``) draws from
    ``generator`` (on its device unless ``device`` says where to put them)."""
    u = torch.rand((n, tokens), generator=generator, device=generator.device)
    return (u < cfg.MODEL.MAE_MASK_RATIO).to(device or generator.device)


def train_step(state: TrainState, batch: dict, lr: float, *, accum_steps: int = 1,
               topk: int = 5, label_smooth: float = 0.0, guard: bool = True,
               dropout_key: tuple | None = None, task: str = "classify",
               mask: torch.Tensor | None = None) -> dict:
    """One optimizer step on the local batch (``image`` uint8 or float NHWC,
    ``label``), on the batch's device. Forward and backward per micro-batch
    (BN statistics updated in order), gradients and loss averaged over the
    micro-batches and over the group, the running statistics averaged over
    the group, then the update. With ``guard``, a non-finite loss or
    gradient leaves parameters, optimizer state and statistics as they
    were. ``dropout_key``: ``(seed, epoch, step, rank)``, from which each
    micro-step's dropout and drop-path masks are drawn
    (:func:`dropout_seed`); a model that draws none needs none.
    ``task`` "mae": the loss is :func:`mae_loss`, top-k stays zero, and
    each micro-step's patch mask is ``mask``'s rows (``[n, L]``), or, when
    ``mask`` is None, drawn from the micro-step's stream before any
    dropout (so ``dropout_key`` is needed).
    Returns this rank's metric sums as 0-d device tensors (no sync)."""
    model = state.model.train()
    images, labels = batch["image"], batch["label"]
    n = images.shape[0]
    if n % accum_steps:
        raise ValueError(f"batch {n} does not split into {accum_steps} micro-batches")
    mae = task == "mae"
    if mae and mask is None and dropout_key is None:
        raise ValueError("TRAIN.TASK mae draws its mask from the dropout stream: pass "
                         "dropout_key (or the mask)")
    mb = n // accum_steps
    state.grads.zero_()
    stats_before = state.stats.clone() if guard else None
    zero = torch.zeros((), device=images.device)
    loss_sum, correct = 0.0, {1: zero, topk: zero}
    for i in range(accum_steps):
        sl = slice(i * mb, (i + 1) * mb)
        gen = None
        if dropout_key is not None and (state.masks or mae):
            gen = state.mask_generator.manual_seed(
                dropout_seed(*dropout_key[:3], i, dropout_key[3]))
        for m in state.masks:  # without a key the layers raise rather than draw
            m.generator = gen
        x = device_normalize(images[sl])
        if mae:
            tokens = (x.shape[1] // model.patch) * (x.shape[2] // model.patch)
            m_i = mask[sl] if mask is not None else mae_mask(mb, tokens, gen)
            loss = mae_loss(model, x, m_i)
        else:
            logits = model(x)
            loss = cross_entropy_loss(logits, labels[sl], label_smooth)
        loss.backward()
        loss_sum = loss_sum + loss.detach()
        if not mae:
            for k, v in topk_correct(logits.detach(), labels[sl], ks=(1, topk)).items():
                correct[k] = correct[k] + v
    loss = loss_sum / accum_steps
    grads = state.grads[:-1]
    if accum_steps > 1:
        grads.div_(accum_steps)
    state.grads[-1:].copy_(loss.reshape(1))
    if state.world > 1:
        dist.all_reduce(state.grads, group=state.group)
        state.grads.div_(state.world)
        if state.stats.numel():
            dist.all_reduce(state.stats, group=state.group)
            state.stats.div_(state.world)
    n_t = torch.full((), float(n), device=loss.device)
    keep = None
    if guard:
        keep = torch.isfinite(state.grads[-1]) & torch.isfinite(grads).all()
    state.optimizer.step(state.params, grads, lr, keep)
    metrics = {"loss_sum": loss * n_t, "n": n_t, "correct1": correct[1],
               f"correct{topk}": correct[topk]}
    if guard:
        state.stats.copy_(torch.where(keep, state.stats, stats_before))
        metrics = {k: torch.where(keep, v, zero) for k, v in metrics.items()}
        metrics["skipped"] = (~keep).float()
    return metrics


@torch.no_grad()
def eval_step(model, batch: dict, totals: torch.Tensor, topk: int = 5,
              task: str = "classify") -> torch.Tensor:
    """Add the batch's ``[sum(nll * w), sum(w), correct@1, correct@k]`` to
    ``totals`` (a 4-vector on the device) and return it. ``task`` "mae":
    ``[mae_loss * sum(w), sum(w), 0, 0]`` under one fixed mask, drawn from
    ``RNG_SEED or 0`` on the CPU for every batch and run (so the card and
    the CPU evaluate the same mask), the weights excluding padded samples."""
    model.eval()
    x = device_normalize(batch["image"])
    w = batch["weight"]
    if task == "mae":
        tokens = (x.shape[1] // model.patch) * (x.shape[2] // model.patch)
        gen = torch.Generator().manual_seed(cfg.RNG_SEED or 0)
        loss = mae_loss(model, x, mae_mask(x.shape[0], tokens, gen, x.device), w)
        zero = torch.zeros((), device=x.device)
        return totals + torch.stack([loss * w.sum(), w.sum(), zero, zero])
    logits = model(x).float()
    nll = per_example_nll(logits, batch["label"])
    c = topk_correct_weighted(logits, batch["label"], w, ks=(1, topk))
    return totals + torch.stack([(nll * w).sum(), w.sum(), c[1], c[topk]])


# Keys the port accepts, so that the JAX package's YAMLs and command lines
# merge, but does not honour yet: any value other than the default raises
# with the ROADMAP Queue 1 item that ports the subsystem.
UNPORTED_KEYS = (("MESH.SEQ", "item 12"), ("MESH.FSDP_MIN_SIZE", "item 12"),
                 ("DATA.ADVERTISE_HOST", "item 13"))


def _check_supported() -> None:
    """Raise on a config value whose subsystem the port does not have yet."""
    todo = (("MESH.FSDP", cfg.MESH.FSDP in (0, 1), "item 12"),
            # a fleet-scheduled dataplane (the key or DTPU_DATA_SERVICE); a
            # host:port address is ported
            ("DATA.SERVICE", service_address().lower() != "fleet", "item 13"),
            *((key, lookup(key) == get_default(key), item) for key, item in UNPORTED_KEYS))
    for key, ok, item in todo:
        if not ok:
            raise NotImplementedError(f"this {key} is not ported yet (ROADMAP Queue 1 {item})")
    if cfg.MODEL.DTYPE not in _DTYPES:
        raise ValueError(f"MODEL.DTYPE must be 'float32' or 'bfloat16', got {cfg.MODEL.DTYPE!r}")
    if cfg.MODEL.BN_DTYPE not in ("auto", *_DTYPES):
        raise ValueError(f"MODEL.BN_DTYPE must be 'auto', 'float32' or 'bfloat16', "
                         f"got {cfg.MODEL.BN_DTYPE!r}")


def build_cfg_model(generator: torch.Generator | None = None) -> torch.nn.Module:
    """``MODEL.ARCH`` with the config's classes, compute dtype, BN boundary
    dtype (``auto`` follows ``MODEL.DTYPE``) and ``MODEL.REMAT``, weights
    drawn from ``generator`` with the JAX initialisers
    (:func:`layers.init_weights`). ``MODEL.STEM_S2D`` reaches the factory,
    which refuses it outside the ResNet family (a TypeError, as JAX's).
    ``TRAIN.TASK`` and ``MODEL.SEQ_ATTN`` are checked as JAX's
    ``_build_cfg_model`` checks them: ``mae`` needs an ``mae_*`` arch (and
    gets ``MODEL.MAE_DECODER_DIM``), and an ``mae_*`` arch needs ``mae``."""
    for mod in filter(None, (m.strip() for m in cfg.MODEL.MODULE.split(","))):
        importlib.import_module(mod)
    if cfg.TRAIN.TASK not in ("classify", "mae"):
        raise ValueError(f"TRAIN.TASK must be 'classify' or 'mae', got {cfg.TRAIN.TASK!r}")
    if cfg.MODEL.SEQ_ATTN not in ("none", "ring", "ulysses"):
        raise ValueError(f"MODEL.SEQ_ATTN must be 'none', 'ring' or 'ulysses', "
                         f"got {cfg.MODEL.SEQ_ATTN!r}")
    dtype = _DTYPES[cfg.MODEL.DTYPE]
    bn = cfg.MODEL.BN_DTYPE
    bn_dtype = dtype if bn == "auto" else _DTYPES[bn]
    # the ResNet family's option, as in JAX: another family's factory
    # refuses the keyword with a TypeError
    kwargs = {"stem_s2d": True} if cfg.MODEL.STEM_S2D else {}
    if cfg.TRAIN.TASK == "mae":
        if not cfg.MODEL.ARCH.startswith("mae_"):
            raise ValueError(f"TRAIN.TASK 'mae' needs a pixel-decoder arch (mae_*), got "
                             f"MODEL.ARCH {cfg.MODEL.ARCH!r}")
        kwargs["decoder_dim"] = cfg.MODEL.MAE_DECODER_DIM
    elif cfg.MODEL.ARCH.startswith("mae_"):
        raise ValueError(f"MODEL.ARCH {cfg.MODEL.ARCH!r} emits pixel reconstructions, not "
                         f"class logits: set TRAIN.TASK 'mae'")
    model = build_model(cfg.MODEL.ARCH, num_classes=cfg.MODEL.NUM_CLASSES, dtype=dtype,
                        bn_dtype=bn_dtype, im_size=cfg.TRAIN.IM_SIZE, remat=cfg.MODEL.REMAT,
                        **kwargs)
    if generator is not None:
        layers.init_weights(model, generator)
    return model


def _check_crop(model) -> None:
    """A model whose position tables are sized by the crop at construction
    (``crop_sized``: BoTNet-50, ViT) refuses an eval crop other than the
    training one, as the JAX trainer does for botnet50: now, rather than at
    the first validation after an epoch."""
    if getattr(model, "crop_sized", False) and cfg.TRAIN.IM_SIZE != cfg.TEST.CROP_SIZE:
        raise ValueError(f"{cfg.MODEL.ARCH} requires TRAIN.IM_SIZE == TEST.CROP_SIZE (got "
                         f"{cfg.TRAIN.IM_SIZE} vs {cfg.TEST.CROP_SIZE}): its position tables "
                         f"are sized by the training crop")


def _pretrained_path() -> str:
    """``MODEL.PRETRAINED``'s directory, ``$DTPU_PRETRAINED_DIR/<arch>``
    (default ``~/.cache/distribuuuu_tpu_torch/pretrained/<arch>``, the
    port's own root: a JAX Orbax directory is never found by default). A
    missing directory, or one without the port's ``checkpoint.pt`` (such as
    an Orbax one), raises ``FileNotFoundError`` naming the command that
    provisions it from a torchvision ``.pth``."""
    root = os.environ.get("DTPU_PRETRAINED_DIR", os.path.join(
        os.path.expanduser("~"), ".cache", "distribuuuu_tpu_torch", "pretrained"))
    path = os.path.join(root, cfg.MODEL.ARCH)
    provision = (f"provision it once with: python -m distribuuuu_tpu_torch.convert --arch "
                 f"{cfg.MODEL.ARCH} --src <torchvision .pth> --dst {path}")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"MODEL.PRETRAINED=True but no converted weights at {path}; "
                                f"{provision}")
    if not os.path.isfile(os.path.join(path, "checkpoint.pt")):
        raise FileNotFoundError(f"MODEL.PRETRAINED=True but {path} holds no checkpoint.pt of "
                                f"the port (a JAX Orbax directory cannot be read); {provision}")
    return path


def _load_pretrained(state: TrainState) -> str:
    """Verify ``MODEL.PRETRAINED``'s checkpoint against its manifest and load
    its model into ``state`` (the optimizer untouched); returns its path."""
    path = _pretrained_path()
    status, errors = ckpt.verify_checkpoint(path)
    if status != "ok":
        raise RuntimeError(f"MODEL.PRETRAINED: {path} is {status} against its manifest "
                           f"({errors or 'no dtpu_manifest.json'}); provision it again with "
                           f"python -m distribuuuu_tpu_torch.convert")
    ckpt.load_checkpoint(path, state, load_opt=False)
    return path


def _launch_counts() -> tuple[int, ...]:
    """K1, K1-bwd, their scalar routes, the attention kernel, its backward
    and the backward's calls on each route (cluster, blockwise, scalar)."""
    return (ep.LAUNCHES, ep.BWD_LAUNCHES, ep.SCALAR_LAUNCHES, ep.BWD_SCALAR_LAUNCHES,
            att.LAUNCHES, att.BWD_LAUNCHES,
            *(att.BWD_ROUTE_CALLS[r] for r in _ROUTES))


_ROUTES = ("cluster", "blockwise", "scalar")  # the attention backward's routes


class _Profiler:
    """TRAIN.PROFILE: a torch.profiler window over PROFILE_STEPS steps from
    PROFILE_START; its device events go to OUT_DIR/profile/train_steps.json
    with the window's wall time (the device synchronised at both ends)."""

    def __init__(self, device):
        self.device, self.prof, self.tic = device, None, 0.0

    def before(self, it: int) -> None:
        if it == cfg.TRAIN.PROFILE_START and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if self.device.type == "cuda" else [])
            self._sync()
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.tic = time.perf_counter()

    def after(self, it: int) -> None:
        if self.prof is None or it != cfg.TRAIN.PROFILE_START + cfg.TRAIN.PROFILE_STEPS - 1:
            return
        self._sync()
        wall = time.perf_counter() - self.tic
        self.prof.__exit__(None, None, None)
        events = [(e.name, e.time_range.start, e.time_range.end) for e in self.prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > 0]
        out = os.path.join(cfg.OUT_DIR, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, "train_steps.json")
        with open(path, "w") as f:
            json.dump({"steps": cfg.TRAIN.PROFILE_STEPS, "wall_ms": 1e3 * wall,
                       "batch": cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.ACCUM_STEPS,
                       "events": events}, f)
        logger.info(f"Profiled {cfg.TRAIN.PROFILE_STEPS} steps from step "
                    f"{cfg.TRAIN.PROFILE_START}: {len(events)} device events -> {path}")
        self.prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _fetch(window: list, state: TrainState, stop: bool = False) -> tuple[list[dict], bool]:
    """The window's per-step metric sums on the host, summed over the group,
    and whether any rank asked to stop: with several processes this rank's
    preemption flag ``stop`` rides the same all-reduce, so every rank gets
    the same answer after the same step."""
    keys = list(window[0])
    t = torch.stack([torch.stack([m[k] for k in keys]) for m in window]).reshape(-1)
    if state.world > 1:
        t = torch.cat([t, torch.full((1,), float(stop), dtype=t.dtype, device=t.device)])
        dist.all_reduce(t, group=state.group)
    flat = t.tolist()  # the sync point
    if state.world > 1:
        stop = flat.pop() > 0
    rows = [dict(zip(keys, flat[i:i + len(keys)])) for i in range(0, len(flat), len(keys))]
    for v in rows:
        if "skipped" in v:  # identical on every rank: summed world times
            v["skipped"] /= state.world
    return rows, stop


def _preempt(state: TrainState, epoch: int, it: int, best_acc1: float, samples_per_step: int,
             is_primary: bool) -> None:
    """Write the emergency checkpoint before step ``it`` (rank 0; the other
    ranks wait for it), log its wall time and bytes, raise ``Preempted``."""
    if is_primary:
        tic = time.perf_counter()
        path = ckpt.save_mid_checkpoint(cfg.OUT_DIR, epoch, it, state, best_acc1,
                                        samples_per_step=samples_per_step)
        wall = time.perf_counter() - tic
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
        logger.warning(f"Preempted at epoch {epoch} step {it}: emergency checkpoint {path} "
                       f"committed in {1e3 * wall:.1f} ms ({size} bytes); exiting")
    if state.world > 1:  # no rank leaves before the checkpoint is durable
        dist.barrier(group=state.group)
        if not is_primary:
            logger.warning(f"Preempted at epoch {epoch} step {it}: rank "
                           f"{dist.get_rank(state.group)} exiting with rank 0's checkpoint")
    resilience.RUN_STATS.preempted_at = (epoch, it)
    raise resilience.Preempted(f"preempted at epoch {epoch} step {it}")


def train_epoch(loader, state: TrainState, epoch: int, device, is_primary: bool, *,
                start_epoch: int = 0, run_tic: float | None = None, profiler=None,
                start_step: int = 0, best_acc1: float = 0.0, injector=None) -> None:
    """One epoch from batch ``start_step`` (a mid-epoch resume: the loader
    skips the consumed batches unread)."""
    lr = optim.get_epoch_lr(epoch)
    if is_primary:
        logger.info(f"Epoch[{epoch}] current learning rate: {lr:.6f}")
    loader.set_epoch(epoch, start_batch=start_step)
    if start_step and is_primary:
        logger.info(f"Epoch[{epoch}] resuming mid-epoch at step {start_step}/{len(loader)}")
    topk = cfg.TRAIN.TOPK
    batch_time, data_time, losses, top1, topk_m, progress = construct_meters(
        len(loader), prefix=f"Epoch[{epoch}] ", topk=topk)
    progress.configure_run_eta(tic=run_tic or time.time(), cur_epoch=epoch,
                               start_epoch=start_epoch, max_epoch=cfg.OPTIM.MAX_EPOCH)
    step_imgs = cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.ACCUM_STEPS * state.world
    steps_per_epoch = len(loader)
    # the group's verdict on stopping, from the last window (one process:
    # None, its own flag is read at every step)
    agreed = None if state.world == 1 else False
    epoch_skipped = consec = 0
    window: list = []
    first_window = True
    launches0 = _launch_counts()
    epoch_start = t_end = t_window = time.time()
    for it, batch in enumerate(DevicePrefetcher(loader, device, cfg.TRAIN.PREFETCH,
                                                 cfg.TRAIN.PIN_MEMORY), start=start_step):
        data_time.update(time.time() - t_end)
        gstep = epoch * steps_per_epoch + it
        resilience.watchdog_beat(gstep)
        if injector is not None and injector.should_kill(gstep):
            injector.kill_now()  # a hard death: no cleanup, no checkpoint
        if injector is not None and injector.should_hang(gstep):
            injector.hang_now()  # the watchdog's prey
        if injector is not None and injector.should_preempt(gstep):
            # gstep is the same on every rank: no agreement needed
            resilience.request_preemption(f"injected at global step {gstep}")
            stop_here = True
        else:
            stop_here = resilience.preemption_stop_requested(agreed)
        if stop_here:
            _preempt(state, epoch, it, best_acc1, step_imgs, is_primary)
        if injector is not None and injector.is_nan_step(gstep):
            batch = resilience.poison_batch_nan(batch)
            if is_primary:
                logger.warning(f"FAULT INJECTION: NaN batch at global step {gstep}")
        if profiler is not None:
            profiler.before(it)
        window.append(train_step(state, batch, lr, accum_steps=cfg.TRAIN.ACCUM_STEPS,
                                 topk=topk, label_smooth=cfg.TRAIN.LABEL_SMOOTH,
                                 guard=cfg.FAULT.NONFINITE_GUARD,
                                 dropout_key=(state.dropout_seed, epoch, it, state.rank),
                                 task=cfg.TRAIN.TASK))
        if profiler is not None:
            profiler.after(it)
        if it % cfg.TRAIN.PRINT_FREQ == 0 or it == len(loader) - 1:
            vals, stop = _fetch(window, state, resilience.preemption_requested())
            if agreed is not None:
                agreed = stop
            now = time.time()
            if first_window:  # the first window carries cuDNN's autotuning: shown, not averaged
                batch_time.val = (now - t_window) / len(window)
                first_window = False
            else:
                batch_time.update((now - t_window) / len(window), n=len(window))
            t_window = now
            for v in vals:
                if v.get("skipped", 0.0) >= 0.5:
                    epoch_skipped += 1
                    consec += 1
                    if consec >= cfg.FAULT.MAX_CONSECUTIVE_SKIPS:
                        raise resilience.NonFiniteDivergence(
                            f"{consec} consecutive non-finite steps at epoch {epoch} step {it}: "
                            f"aborting (FAULT.MAX_CONSECUTIVE_SKIPS="
                            f"{cfg.FAULT.MAX_CONSECUTIVE_SKIPS})")
                else:
                    consec = 0
            n = sum(v["n"] for v in vals)
            if n > 0:
                losses.update(sum(v["loss_sum"] for v in vals) / n, n=int(n))
                top1.update(100.0 * sum(v["correct1"] for v in vals) / n, n=int(n))
                topk_m.update(100.0 * sum(v[f"correct{topk}"] for v in vals) / n, n=int(n))
            window.clear()
            if is_primary:
                progress.display(it)
        t_end = time.time()
    wall = time.time() - epoch_start
    resilience.RUN_STATS.skipped_steps[epoch] = epoch_skipped
    fwd, bwd, fwd_s, bwd_s, att_f, att_b, *att_r = (
        b - a for a, b in zip(launches0, _launch_counts()))
    steps = max(1, len(loader) - start_step)  # the steps this run took
    if is_primary:
        logger.info(f"Epoch[{epoch}] K1 launches: {fwd} forward ({fwd / steps:.2f} a step), "
                    f"{bwd} backward ({bwd / steps:.2f} a step), scalar route {fwd_s} forward, "
                    f"{bwd_s} backward; attention {att_f} forward ({att_f / steps:.2f} a step), "
                    f"{att_b} backward ({att_b / steps:.2f} a step); backward calls by route: "
                    + ", ".join(f"{r} {c}" for r, c in zip(_ROUTES, att_r)))
        if epoch_skipped:
            logger.warning(f"Epoch[{epoch}] skipped_steps: {epoch_skipped} non-finite step(s) "
                           f"left parameters and optimizer state untouched")
        peak = (f"; peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                if torch.device(device).type == "cuda" else "")
        logger.info(f"Epoch[{epoch}] done: {wall:.1f}s, {step_imgs * steps / wall:.0f} img/s; "
                    f"steady state {1e3 * batch_time.avg:.2f} ms a step, "
                    f"{step_imgs / max(batch_time.avg, 1e-9):.0f} img/s; data wait "
                    f"{100 * data_time.sum / wall:.1f}% of the epoch{_input_tail(loader)}{peak}")


def validate(loader, model, device, is_primary: bool, group=None, prefix="Test: "):
    """Weighted top-1/top-k and loss over ``loader``; returns ``(acc1, acck)``."""
    topk = cfg.TRAIN.TOPK
    batch_time, data_time, losses, top1, topk_m, progress = construct_meters(
        len(loader), prefix=prefix, topk=topk)
    totals = torch.zeros(4, device=device)
    t_end = t_window = time.time()
    window_n = 0

    def summed(t):
        t = t.clone()
        if group is not None:
            dist.all_reduce(t, group=group)
        return t.tolist()

    for it, batch in enumerate(DevicePrefetcher(loader, device, cfg.TRAIN.PREFETCH,
                                                 cfg.TRAIN.PIN_MEMORY)):
        data_time.update(time.time() - t_end)
        resilience.watchdog_beat(it, phase="eval")
        totals = eval_step(model, batch, totals, topk, cfg.TRAIN.TASK)
        window_n += 1
        if it % cfg.TEST.PRINT_FREQ == 0 or it == len(loader) - 1:
            loss_s, n, c1, ck = summed(totals)
            now = time.time()
            if it == 0:
                batch_time.val = (now - t_window) / window_n
            else:
                batch_time.update((now - t_window) / window_n, n=window_n)
            t_window, window_n = now, 0
            n = max(n, 1.0)
            losses.avg = losses.val = loss_s / n
            top1.avg = top1.val = 100.0 * c1 / n
            topk_m.avg = topk_m.val = 100.0 * ck / n
            if is_primary:
                progress.display(it)
        t_end = time.time()
    loss_s, n, c1, ck = summed(totals)
    n = max(n, 1.0)
    acc1, acck = 100.0 * c1 / n, 100.0 * ck / n
    if is_primary:
        mse = f"; masked-MSE loss {loss_s / n:.6f}" if cfg.TRAIN.TASK == "mae" else ""
        logger.info(f" * Acc@1 {acc1:.3f} Acc@{topk} {acck:.3f} over {n:.0f} images{mse}"
                    f"{_input_tail(loader)}")
    return acc1, acck


def _setup(device):
    configure_determinism(cfg.CUDNN.DETERMINISTIC, cfg.CUDNN.BENCHMARK)
    _check_supported()
    info = setup_distributed(device)
    if cfg.MESH.DATA not in (-1, info.world_size):
        raise ValueError(f"MESH.DATA {cfg.MESH.DATA} != the {info.world_size} processes of the "
                         f"run (the port is data-parallel over every process)")
    setup_logger(cfg.OUT_DIR if info.is_primary else None)
    if not info.is_primary:  # one progress log for the run: rank 0's
        logger.setLevel("WARNING")
    return info


def _sync_bn(model, group) -> None:
    if cfg.MODEL.SYNCBN and group is not None:
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                m.sync_group = group


def _pin_device(device: torch.device):
    """The device whose context the loader pins its batches in
    (TRAIN.PIN_MEMORY on a card), else None."""
    return device if cfg.TRAIN.PIN_MEMORY and device.type == "cuda" else None


def _log_input(*loaders) -> None:
    """One line a loader: its images, batches, where it decodes (here, or
    the dataplane service and its pool) and the decoder backend."""
    for ld in loaders:
        if isinstance(ld, HostDataLoader) or hasattr(ld, "address"):
            if hasattr(ld, "address"):  # a dataplane ServiceLoader
                pool = ld.pool
                where = (f"service {ld.address} ({pool.get('workers', '?')} DATA.WORKERS x "
                         f"{pool.get('worker_threads', '?')} threads)")
            else:
                where = f"{ld.workers} workers"
            logger.info(f"Input: {'train' if ld.train else 'val'} {len(ld.dataset)} images "
                        f"({ld.shard_size} in this process's shard, {len(ld)} batches of "
                        f"{ld.host_batch}) from {ld.dataset.root}; decoder: {ld.decoder}; "
                        f"{where}; pinned: {ld.pin_device is not None}")


def _input_tail(loader) -> str:
    """Where ``loader``'s batches came from, for the end of an epoch's line."""
    if hasattr(loader, "address"):  # a dataplane ServiceLoader
        return f"; input: service {loader.address}, {loader.fallbacks} fallback(s)"
    return "; input: local"


def train_model(device=None):
    """A full training run on ``device`` (None: the card). Returns
    ``(state, best_acc1)``."""
    info = _setup(device)
    gen = setup_seed(cfg.RNG_SEED, info.rank, info.group, info.device)
    if info.is_primary:
        dump_cfg()
    resilience.reset_run_stats()
    # a flag left by an earlier preempted run in this process must not stop this one
    resilience.clear_preemption()
    if cfg.FAULT.HANDLE_SIGNALS:
        resilience.install_preemption_handler()
    try:
        return _train(info, gen)
    finally:
        resilience.uninstall_preemption_handler()


def _train(info, gen):
    injector = resilience.FaultInjector()
    if injector.active:
        logger.warning(f"FAULT INJECTION active: io_indices={sorted(injector.io_indices)} "
                       f"(failures={injector.io_failures}), nan_steps="
                       f"{sorted(injector.nan_steps)}, preempt_step={injector.preempt_step}, "
                       f"hang_step={injector.hang_step}, kill_step={injector.kill_step}")
    model = build_cfg_model(gen)
    _check_crop(model)
    model = model.to(info.device)
    _sync_bn(model, info.group)
    state = TrainState(model, info.group)
    state.dropout_seed = gen.initial_seed()  # a mid-epoch resume replaces it with the saved one
    # the samples a step consumes over the group: the unit of the elastic remap
    samples_per_step = cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.ACCUM_STEPS * info.world_size
    logger.info(f"Processes: {info.world_size} (rank 0 on {info.device}), global batch "
                f"{samples_per_step}")
    logger.info(f"Model:\n{cfg.MODEL.ARCH}")
    logger.info(f"Params(M): {count_parameters(model):.3f}")
    train_loader = construct_train_loader(info.world_size, info.rank, _pin_device(info.device))
    val_loader = construct_val_loader(info.world_size, info.rank, _pin_device(info.device))
    _log_input(train_loader, val_loader)
    start_epoch, start_step, best_acc1 = 0, 0, 0.0
    res = None
    if cfg.TRAIN.AUTO_RESUME:
        # the supervisor's poison escalation rides the env var (it never edits YAMLs)
        rollback = int(os.environ.get("DTPU_RESUME_ROLLBACK", cfg.RESUME.ROLLBACK))
        if rollback > 0:
            logger.warning(f"Auto-resume with rollback depth {rollback}: the {rollback} most "
                           f"advanced known-good checkpoint(s) will be skipped")
        res = ckpt.restore_latest(cfg.OUT_DIR, state, step_granular=cfg.RESUME.STEP_GRANULAR,
                                  verify_integrity=cfg.RESUME.VERIFY_INTEGRITY,
                                  skip_corrupt=cfg.RESUME.SKIP_CORRUPT,
                                  samples_per_step=samples_per_step, rollback=rollback)
        if res is not None:
            start_epoch, start_step, best_acc1, path = res
            logger.info(f"Resumed from {path} (epoch {start_epoch}, step {start_step}, best "
                        f"{best_acc1:.3f})")
    if res is None and cfg.MODEL.WEIGHTS:
        ckpt.load_checkpoint(cfg.MODEL.WEIGHTS, state, load_opt=cfg.TRAIN.LOAD_OPT)
        logger.info(f"Warm-started weights from {cfg.MODEL.WEIGHTS}")
    elif res is None and cfg.MODEL.PRETRAINED:
        path = _load_pretrained(state)
        logger.info(f"Initialized from pretrained weights ({cfg.MODEL.ARCH}) at {path}")
    profiler = _Profiler(info.device) if cfg.TRAIN.PROFILE and info.is_primary else None
    run_tic = time.time()
    # armed over train and eval (both hang when a peer dies); its first beat
    # window holds the first steps' cuDNN autotuning: HANG_TIMEOUT_S must cover it
    resilience.start_watchdog(cfg.FAULT.HANG_TIMEOUT_S)
    try:
        for epoch in range(start_epoch, cfg.OPTIM.MAX_EPOCH):
            train_epoch(train_loader, state, epoch, info.device, info.is_primary,
                        start_epoch=start_epoch, run_tic=run_tic,
                        profiler=profiler if epoch == start_epoch else None,
                        start_step=start_step if epoch == start_epoch else 0,
                        best_acc1=best_acc1, injector=injector)
            acc1, _ = validate(val_loader, model, info.device, info.is_primary, info.group)
            is_best = acc1 > best_acc1
            best_acc1 = max(acc1, best_acc1)
            resilience.watchdog_beat(phase="checkpoint")
            if info.is_primary:
                path = ckpt.save_checkpoint(cfg.OUT_DIR, epoch, state, best_acc1, is_best)
                logger.info(f"Saving checkpoint: {path} (best Acc@1 {best_acc1:.3f})")
    finally:
        # disarmed first: a finished or failing run must not be killed by its own watchdog
        resilience.stop_watchdog()
    if info.is_primary:  # every epoch checkpoint written: the emergency ones are dominated
        ckpt.prune_mid_checkpoints(cfg.OUT_DIR, before_epoch=cfg.OPTIM.MAX_EPOCH)
    return state, best_acc1


def test_model(device=None):
    """Evaluate ``MODEL.WEIGHTS`` (a checkpoint) on the val loader; returns
    ``(acc1, acck)``."""
    info = _setup(device)
    model = build_cfg_model(torch.Generator().manual_seed(0))
    _check_crop(model)
    model = model.to(info.device)
    state = TrainState(model, info.group)
    logger.info(f"Params(M): {count_parameters(model):.3f}")
    if cfg.MODEL.WEIGHTS:
        ckpt.load_checkpoint(cfg.MODEL.WEIGHTS, state, load_opt=False)
        logger.info(f"Loaded weights from {cfg.MODEL.WEIGHTS}")
    elif cfg.MODEL.PRETRAINED:
        path = _load_pretrained(state)
        logger.info(f"Loaded pretrained weights ({cfg.MODEL.ARCH}) from {path}")
    val_loader = construct_val_loader(info.world_size, info.rank, _pin_device(info.device))
    _log_input(val_loader)
    return validate(val_loader, model, info.device, info.is_primary, info.group)
