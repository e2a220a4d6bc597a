"""Config tree + CLI loading for the port's serving and training slices.

The keys the port reads, with ``distribuuuu_tpu/config.py``'s defaults and
precedence (defaults < ``--cfg`` YAML < trailing ``KEY VALUE`` overrides),
plus every key the repository's training and serving YAMLs set, so they
merge unchanged. Keys marked "not yet ported" are accepted and checked by
the trainer (``trainer._check_supported``): a non-default value raises with
the ROADMAP item that ports it. The few whose default turns a JAX
subsystem on are gaps at their default, and say so below. ``QUANT`` holds
the JAX package's 11 keys (int8 serving and ``QUANT.QAT`` fine-tuning),
``SERVE.DEPLOY`` its 13 (continuous deployment into a replica). The
``FLEET`` subtree and ``SERVE.INGRESS`` are not part of these slices and
are absent. ``OBS`` holds the JAX package's 16 keys (``obs/``: the training
run's telemetry).
"""

from __future__ import annotations

import argparse
import sys

from distribuuuu_tpu_torch.cfgnode import CfgNode as CN

_C = CN()
cfg = _C

_C.MODEL = CN()
_C.MODEL.ARCH = "resnet18"
# comma-separated modules imported before MODEL.ARCH is resolved, so an
# out-of-tree package can register archs with @register_model
_C.MODEL.MODULE = ""
_C.MODEL.NUM_CLASSES = 1000
# torchvision-pretrained init: the port's checkpoint directory
# $DTPU_PRETRAINED_DIR/<arch> (default ~/.cache/distribuuuu_tpu_torch/
# pretrained), provisioned once from a torchvision .pth with ``python -m
# distribuuuu_tpu_torch.convert``; loaded without the optimizer
_C.MODEL.PRETRAINED = False
# batch statistics averaged over the process group (one all-reduce per BN)
_C.MODEL.SYNCBN = False
# serving: a torch .pt/.pth state_dict when SERVE.MODELS is empty;
# training/eval: a checkpoint directory (or its .pt) to warm-start from
_C.MODEL.WEIGHTS = None
# random uint8 images with label 0 in place of TRAIN.DATASET (replayed:
# measures the step without the input side)
_C.MODEL.DUMMY_INPUT = False
# compute dtype of convs and linears; params, optimizer state and BN
# statistics stay float32
_C.MODEL.DTYPE = "bfloat16"
# activation checkpointing: each family's block is recomputed in the
# backward (torch.utils.checkpoint), the same function bit for bit
_C.MODEL.REMAT = False
# the space-to-depth stem is the plain 7x7/2 stem by construction (the same
# function and the same (7,7,3,64) parameter); the port always computes the
# plain stem, so this key changes nothing
_C.MODEL.STEM_S2D = False
# accepted so JAX-side YAMLs merge; on the card the epilogue kernel always runs
_C.MODEL.FUSED_EPILOGUE = None
_C.MODEL.FUSED_MOE = None
# sequence-parallel attention: "none", "ring" or "ulysses", read only at
# MESH.SEQ > 1 (parallel/seq.py; "none" there raises), inert at 1
_C.MODEL.SEQ_ATTN = "none"
# TRAIN.TASK mae: the Bernoulli rate of a masked patch and the pixel
# decoder's width
_C.MODEL.MAE_MASK_RATIO = 0.25
_C.MODEL.MAE_DECODER_DIM = 512
# dtype BN emits between conv stages: "auto" tracks MODEL.DTYPE in
# training (bf16 training: bf16 boundaries); serving keeps float32
# boundaries, as the JAX engine does. Statistics are float32 either way.
_C.MODEL.BN_DTYPE = "auto"

_C.TRAIN = CN()
_C.TRAIN.BATCH_SIZE = 32  # per process (per GPU); global = BATCH_SIZE x world
_C.TRAIN.IM_SIZE = 224
# an ImageFolder (root/<split>/<class>/<image>) or a directory of tar
# shards of one (root/<split>/*.tar)
_C.TRAIN.DATASET = "./data/ILSVRC/"
_C.TRAIN.SPLIT = "train"
_C.TRAIN.AUTO_RESUME = True
_C.TRAIN.LOAD_OPT = True
# decode threads of a process's loader (PIL and the native decoder release
# the GIL)
_C.TRAIN.WORKERS = 4
# the loader's producer thread writes each batch into pinned memory, so the
# H2D copy is asynchronous; False copies from pageable memory
_C.TRAIN.PIN_MEMORY = True
_C.TRAIN.PRINT_FREQ = 30
_C.TRAIN.TOPK = 5
# "classify" (softmax cross-entropy, top-k) or "mae" (masked pixel
# reconstruction of a mae_* arch; top-k stays zero)
_C.TRAIN.TASK = "classify"
# batches staged on the device ahead of compute; the loader's queue holds
# twice as many decoded host batches
_C.TRAIN.PREFETCH = 2
_C.TRAIN.DUMMY_EPOCH_SAMPLES = 1000  # samples per DUMMY_INPUT epoch
_C.TRAIN.LABEL_SMOOTH = 0.0
# gradients averaged over ACCUM_STEPS micro-batches of BATCH_SIZE per step
_C.TRAIN.ACCUM_STEPS = 1
# XLA compile cache: nothing to cache in eager PyTorch; accepted
_C.TRAIN.COMPILE_CACHE = True
_C.TRAIN.COMPILE_CACHE_DIR = ""
# torch.profiler window of PROFILE_STEPS steps from global step
# PROFILE_START of epoch 0 (obs/profiler.py; written with OBS.ENABLED off
# too): its device events go to OUT_DIR/profile/gstep_<N>/
_C.TRAIN.PROFILE = False
_C.TRAIN.PROFILE_START = 10
_C.TRAIN.PROFILE_STEPS = 5

_C.TEST = CN()
_C.TEST.DATASET = "./data/ILSVRC/"
_C.TEST.SPLIT = "val"
_C.TEST.BATCH_SIZE = 200
_C.TEST.IM_SIZE = 256
_C.TEST.PRINT_FREQ = 10
_C.TEST.CROP_SIZE = 224

# BENCHMARK -> torch.backends.cudnn.benchmark; DETERMINISTIC ->
# cudnn.deterministic and torch.use_deterministic_algorithms
_C.CUDNN = CN()
_C.CUDNN.BENCHMARK = True
_C.CUDNN.DETERMINISTIC = False

_C.OPTIM = CN()
# "sgd" (torch-exact momentum, coupled weight decay on every parameter) or
# "lamb" (BETA1/BETA2/EPS apply to lamb only)
_C.OPTIM.OPTIMIZER = "sgd"
_C.OPTIM.BETA1 = 0.9
_C.OPTIM.BETA2 = 0.999
_C.OPTIM.EPS = 1e-6
# learning-rate policy: "cos" or "steps", constant within an epoch
_C.OPTIM.MAX_EPOCH = 100
_C.OPTIM.LR_POLICY = "cos"
_C.OPTIM.BASE_LR = 0.2
_C.OPTIM.MIN_LR = 0.0
_C.OPTIM.STEPS = []
_C.OPTIM.LR_MULT = 0.1
_C.OPTIM.MOMENTUM = 0.9
_C.OPTIM.DAMPENING = 0.0
_C.OPTIM.NESTEROV = True
_C.OPTIM.WARMUP_FACTOR = 0.1
_C.OPTIM.WARMUP_EPOCHS = 5
_C.OPTIM.WEIGHT_DECAY = 5e-5

# device mesh over the processes (one GPU a process), JAX's ('data', 'fsdp',
# 'seq') order (runtime/mesh.py): DATA x FSDP x SEQ must be the world, -1 a
# wildcard for DATA and FSDP; parameters and optimizer state of at least
# FSDP_MIN_SIZE elements shard over FSDP (parallel/fsdp.py); SEQ > 1 splits
# each sample's tokens over a seq group (parallel/seq.py; ViT and MAE)
_C.MESH = CN()
_C.MESH.DATA = -1
_C.MESH.FSDP = 1
_C.MESH.FSDP_MIN_SIZE = 16384
_C.MESH.SEQ = 1

_C.FAULT = CN()
# a step with a non-finite loss or gradient leaves parameters, optimizer
# state (its step counter too) and BN statistics as they were
_C.FAULT.NONFINITE_GUARD = True
# abort after this many consecutive skipped steps (checked at PRINT_FREQ)
_C.FAULT.MAX_CONSECUTIVE_SKIPS = 10
# retryable IO (resilience.retry: the loader's sample reads, every dataplane
# socket exchange, the emergency checkpoint's write): attempts, and
# full-jitter exponential backoff from RETRY_BASE_DELAY seconds capped at
# RETRY_MAX_DELAY
_C.FAULT.RETRY_ATTEMPTS = 3
_C.FAULT.RETRY_BASE_DELAY = 0.1
_C.FAULT.RETRY_MAX_DELAY = 2.0
# a sample that fails every retry is substituted: in eval by a zero image of
# weight 0, in train by the first readable of the next three samples
_C.FAULT.DEGRADE = True
# the first SIGTERM/SIGINT writes a mid-epoch emergency checkpoint at the
# next step boundary and exits 143/130
_C.FAULT.HANDLE_SIGNALS = True
# the watchdog: no step progress for this many seconds dumps every thread's
# stack into the rank log and exits 124 (0 = off); it must cover the first
# steps' cuDNN autotuning
_C.FAULT.HANG_TIMEOUT_S = 0.0
# fault injection (tests; DTPU_FAULT_* overrides each): I/O errors at these
# sample indices, INJECT_IO_FAILURES times each (-1: always); NaN images at
# these global steps; a preemption, a hang or a SIGKILL before that step
_C.FAULT.INJECT_IO_INDICES = []
_C.FAULT.INJECT_IO_FAILURES = 1
_C.FAULT.INJECT_NAN_STEPS = []
_C.FAULT.INJECT_PREEMPT_STEP = -1
_C.FAULT.INJECT_HANG_STEP = -1
_C.FAULT.INJECT_KILL_STEP = -1

# resume: from the most advanced checkpoint, an emergency mid-epoch one
# included (STEP_GRANULAR; remapped by its sample offset on another world
# size); each is verified against its sha256 manifest (VERIFY_INTEGRITY) and
# a corrupt one quarantined as corrupt_*; one that fails to load anyway is
# skipped (SKIP_CORRUPT); ROLLBACK (or DTPU_RESUME_ROLLBACK) skips that many
# known-good checkpoints
_C.RESUME = CN()
_C.RESUME.STEP_GRANULAR = True
_C.RESUME.SKIP_CORRUPT = True
_C.RESUME.VERIFY_INTEGRITY = True
_C.RESUME.ROLLBACK = 0

# Dataplane (``python -m distribuuuu_tpu_torch.dataplane --cfg ...``): a
# dispatcher owning the seed+epoch-keyed sample permutation plus N decode
# worker processes; trainers opt in per run, and the sample stream is
# bitwise the local decode's either way.
_C.DATA = CN()
# Where this run's loaders get batches: "" or "local" = decode in this
# process (HostDataLoader); "host:port" = stream from a running dataplane
# dispatcher; "fleet" (a fleet-scheduled service) is not yet ported (ROADMAP
# Queue 1 item 13). The DTPU_DATA_SERVICE env var overrides this key.
_C.DATA.SERVICE = ""
# Dispatcher bind. PORT 0 derives a stable port from OUT_DIR
# (runtime/dist.derive_dataplane_port).
_C.DATA.HOST = "127.0.0.1"
_C.DATA.PORT = 0
# The address clients are told to connect to ("" = DATA.HOST): a dispatcher
# bound to 0.0.0.0 must advertise a routable address. Read by the fleet's
# co-scheduling, which is not yet ported: a value raises (item 13).
_C.DATA.ADVERTISE_HOST = ""
# Decode worker pool: processes x threads (THREADS 0: cpu_count/WORKERS).
_C.DATA.WORKERS = 2
_C.DATA.WORKER_THREADS = 0
# Decoded-batch LRU cache, keyed by (root, transform fingerprint, epoch
# seed, batch): several jobs, eval re-reads and resumed epochs share one
# decode.
_C.DATA.CACHE_MB = 256
# A lease not completed within this window re-issues to another worker (a
# worker whose connection drops re-issues at once; this clock covers only
# silently wedged workers).
_C.DATA.LEASE_TIMEOUT_S = 30.0
# How many batches ahead of the slowest consumer the dispatcher leases per
# stream (the decode-ahead depth and the ready-buffer bound).
_C.DATA.WINDOW = 8
# Client behaviour when the dispatcher dies: finish the epoch with local
# decode at the exact next undelivered batch (the same stream, logged and
# counted), and return to the service at the next epoch. Off: fail the run.
_C.DATA.FALLBACK = True

# Observability (``obs/``): the rank-0 JSONL journal of the training run,
# MFU and goodput, the launch and build counters, profiler windows, memory
# records.
_C.OBS = CN()
# master switch; off, every telemetry call site does nothing (the legacy
# TRAIN.PROFILE window still writes)
_C.OBS.ENABLED = True
# the journal's file name under OUT_DIR (JSONL, one typed record a line)
_C.OBS.JOURNAL = "telemetry.jsonl"
# os.fsync the journal after every record (the default flushes a record)
_C.OBS.FSYNC = False
# count the global step's FLOPs once a run (FlopCounterMode on the meta
# device) and report MFU a window against the card's peak from the
# built-in table; PEAK_TFLOPS_PER_DEVICE (TFLOP/s a card, 0 = the table)
# overrides it. An unknown card (or the CPU) omits MFU.
_C.OBS.MFU = True
_C.OBS.PEAK_TFLOPS_PER_DEVICE = 0.0
# torch.profiler windows of PROFILE_STEPS steps from each listed global
# step (epoch * steps_per_epoch + step), under OUT_DIR/profile/gstep_*;
# SIGUSR1 asks a live run for one at the next step (PROFILE_SIGUSR1 gates
# the handler); PROFILE_TOP_OPS kernels go into the profile record
_C.OBS.PROFILE_AT_STEPS = []
_C.OBS.PROFILE_STEPS = 5
_C.OBS.PROFILE_SIGUSR1 = True
_C.OBS.PROFILE_TOP_OPS = 20
# a memory record (the allocator's counters) at each epoch's end
_C.OBS.MEMORY_SNAPSHOTS = True
# span records a PRINT_FREQ window (data wait, compute) and a checkpoint
_C.OBS.TRAIN_SPANS = True
# rules of the live plane's alarm engine (obs/alarms.py), read by the serving
# frontend, the dataplane's /metrics plane and the export sidecar, never by
# the training process
_C.OBS.ALARMS = [
    "goodput_floor=goodput<0.1:for=3",
    "data_wait_ceiling=data_wait_frac>0.5:for=3",
    "heartbeat_stale=heartbeat_age_s>300",
    "skip_streak=consecutive_skips>3",
]
# the /metrics exporter's port (0: none), bind and journal tail cadence, read
# by the dataplane service; the trainer accepts them and reads nothing of
# them, as the JAX trainer does
_C.OBS.METRICS_PORT = 0
_C.OBS.METRICS_HOST = "127.0.0.1"
_C.OBS.TAIL_INTERVAL_S = 2.0
# the JAX package's kernel-verdict registry: not ported (a value raises)
_C.OBS.PERFDB = ""

# agent supervision: not yet ported (accepted for serve_resnet50.yaml)
_C.AGENT = CN()
_C.AGENT.SERVE = False
_C.AGENT.NPROCS = 1

_C.SERVE = CN()
# batch ladder, ascending; every batch is padded up to the smallest size >= it
_C.SERVE.BATCH_SIZES = [1, 8, 32]
# dispatch when the largest size fills or the oldest request waited this long
_C.SERVE.MAX_QUEUE_DELAY_MS = 5.0
# max pending examples per model; more are shed (HTTP 503)
_C.SERVE.MAX_QUEUE_DEPTH = 256
# "name=arch@weights.pt" entries; empty: MODEL.ARCH + MODEL.WEIGHTS
_C.SERVE.MODELS = []
_C.SERVE.HOST = "127.0.0.1"
# 0 picks a free port; the DTPU_SERVE_PORT env var overrides
_C.SERVE.PORT = 0
# "http" (POST /v1/predict, GET /healthz) or "stdin" (JSONL per line)
_C.SERVE.MODE = "http"
# image side (0 -> TEST.CROP_SIZE) and wire dtype (uint8 pixels or float32)
_C.SERVE.IM_SIZE = 0
_C.SERVE.INPUT_DTYPE = "uint8"
# 0 / "" -> MODEL.NUM_CLASSES / MODEL.DTYPE
_C.SERVE.NUM_CLASSES = 0
_C.SERVE.DTYPE = ""
# run every ladder size once at startup
_C.SERVE.WARMUP = True
# a checkpoint directory's weights are verified against its sha256 manifest
# before they load (a .pt state_dict has no manifest)
_C.SERVE.VERIFY_INTEGRITY = True
# cadence of the serve_slo rollups in OUT_DIR's journal
_C.SERVE.SLO_WINDOW_S = 10.0
# a serve_request record a request, and its queue_wait/pad/execute/total
# span records under its x-dtpu-trace-id (the SLO rollups are always on)
_C.SERVE.JOURNAL_REQUESTS = True
_C.SERVE.TRACE_SPANS = True

# Continuous train->serve deployment (``serve/deploy.py``). A non-empty
# WATCH_DIR (a training run's OUT_DIR or its checkpoints/) arms a watcher
# thread a replica: each new integrity-verified checkpoint is staged beside
# the serving version (its own PTQ and gate for an :int8 spec), gated on
# golden-fixture logits against the incumbent, given CANARY_FRACTION of the
# traffic (sticky by trace id) for CANARY_S or MIN_CANARY_REQUESTS, and
# promoted when its p99 stays within SLO_P99_FACTOR of the incumbent's; a
# failure rolls back and bumps the checkpoint's strike count under
# OUT_DIR/deploy/ (MAX_STRIKES: never tried again). Replicas serialize their
# rollouts through a lease file held at most LOCK_LEASE_S.
_C.SERVE.DEPLOY = CN()
_C.SERVE.DEPLOY.WATCH_DIR = ""
# the hosted model to deploy into ("": the sole one)
_C.SERVE.DEPLOY.MODEL = ""
_C.SERVE.DEPLOY.POLL_S = 5.0
_C.SERVE.DEPLOY.CANARY_FRACTION = 0.1
_C.SERVE.DEPLOY.CANARY_S = 30.0
_C.SERVE.DEPLOY.MIN_CANARY_REQUESTS = 20
_C.SERVE.DEPLOY.SLO_P99_FACTOR = 2.0
# the quality gate: finite logits, top-1 agreement with the incumbent on
# GATE_N inputs, and (MAX_LOGIT_RMSE > 0) an RMSE bound
_C.SERVE.DEPLOY.GATE_N = 16
_C.SERVE.DEPLOY.GATE_SEED = 0
_C.SERVE.DEPLOY.MIN_TOP1_AGREE = 0.5
_C.SERVE.DEPLOY.MAX_LOGIT_RMSE = 0.0
_C.SERVE.DEPLOY.MAX_STRIKES = 2
_C.SERVE.DEPLOY.LOCK_LEASE_S = 600.0

# Post-training int8 quantization (``quant/``). A hosted model opts in per
# entry: SERVE.MODELS "name=arch@weights.pt:int8" quantizes that model's
# conv/linear weights per-channel symmetric int8 (BatchNorm folded where
# possible) and calibrates per-tensor activation scales over CALIB_BATCHES
# seeded synthetic batches of the wire dtype.
_C.QUANT = CN()
_C.QUANT.CALIB_BATCHES = 4
_C.QUANT.CALIB_BATCH_SIZE = 8
_C.QUANT.CALIB_SEED = 1234
# Quality gate (quant/gate.py): the int8 path against the fp engine forward
# on GATE_N deterministic inputs (convert.golden_inputs for float wire,
# seeded uint8 pixels otherwise). Either threshold failing refuses to serve
# the model; the measurement is journaled as a ``quant_quality`` record
# either way. GATE False serves anyway (the record is still written).
_C.QUANT.GATE = True
_C.QUANT.GATE_N = 16
_C.QUANT.GATE_SEED = 0
_C.QUANT.MIN_TOP1_AGREE = 0.99
_C.QUANT.MAX_LOGIT_RMSE = 0.25
# Quantization-aware fine-tuning through train_net (``quant/qat.py``): every
# train and eval forward runs each conv and linear on the fake-quant grid
# (QAT_MODE int8 or fp8) with a straight-through gradient, its scales
# calibrated on the run's weights over CALIB_BATCHES seeded batches.
# QAT_DISTILL > 0 adds the distillation term toward the model's own fp logits.
_C.QUANT.QAT = False
_C.QUANT.QAT_MODE = "int8"
_C.QUANT.QAT_DISTILL = 0.0

_C.OUT_DIR = "./exp"
_C.CFG_DEST = "config.yaml"
_C.RNG_SEED = None

_CFG_DEFAULT = _C.clone()
_CFG_DEFAULT.freeze()


def lookup(key: str, node=None):
    """The value of a dotted key (``"TEST.DATASET"``) in ``node``, by default
    the live config."""
    node = _C if node is None else node
    for part in key.split("."):
        node = node[part]
    return node


def get_default(key: str):
    return lookup(key, _CFG_DEFAULT)


def reset_cfg() -> None:
    """Reset the config to its defaults (leaves the singleton mutable)."""
    _C.defrost()
    _C.clear()
    for k, v in _CFG_DEFAULT.clone().items():
        _C[k] = v


def dump_cfg() -> None:
    """Write the config to OUT_DIR/CFG_DEST (the run's provenance)."""
    import os

    os.makedirs(_C.OUT_DIR, exist_ok=True)
    with open(os.path.join(_C.OUT_DIR, _C.CFG_DEST), "w") as f:
        _C.dump(stream=f)


def load_cfg_fom_args(description: str = "Config file options.", argv=None) -> None:
    """``--cfg FILE`` then trailing ``KEY VALUE`` overrides (the JAX CLI
    contract, including its spelling)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cfg", dest="cfg_file", default=None, type=str)
    # accepted for launcher compatibility; the trainer reads LOCAL_RANK
    parser.add_argument("--local_rank", "--local-rank", default=None)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.cfg_file is not None:
        _C.merge_from_file(args.cfg_file)
    if args.opts:
        _C.merge_from_list(args.opts)
