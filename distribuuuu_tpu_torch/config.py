"""Config tree + CLI loading for the port's serving and training slices.

The keys the port reads, with ``distribuuuu_tpu/config.py``'s defaults and
precedence (defaults < ``--cfg`` YAML < trailing ``KEY VALUE`` overrides),
plus every key the repository's training and serving YAMLs set, so they
merge unchanged. Keys marked "not yet ported" are accepted and checked by
the trainer (``trainer._check_supported``): a non-default value raises with
the ROADMAP item that ports it. The few whose default turns a JAX
subsystem on are gaps at their default, and say so below. The ``OBS``,
``QUANT``, ``FLEET`` subtrees and ``SERVE.DEPLOY``/``SERVE.INGRESS`` are
not part of these slices and are absent.
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
# MESH.SEQ > 1 (not yet ported, ROADMAP Queue 1 item 12), inert at 1
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
# torch.profiler window of PROFILE_STEPS steps from PROFILE_START (epoch of
# the run's first step); its device events go to OUT_DIR/profile/
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

# device mesh: the port is data-parallel over the process group (one GPU a
# process); DATA -1 means every process. FSDP and SEQ > 1 and FSDP_MIN_SIZE:
# not yet ported (ROADMAP Queue 1 item 12)
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
# integrity manifests: not yet ported (weights are torch state_dicts)
_C.SERVE.VERIFY_INTEGRITY = True
# SLO rollup cadence; rollups go to the log
_C.SERVE.SLO_WINDOW_S = 10.0
# per-request journal records and trace spans: not yet ported
_C.SERVE.JOURNAL_REQUESTS = True
_C.SERVE.TRACE_SPANS = True

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
