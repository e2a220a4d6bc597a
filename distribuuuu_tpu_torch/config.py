"""Config tree + CLI loading for the port's serving slice.

The keys the slice reads, with ``distribuuuu_tpu/config.py``'s defaults and
precedence (defaults < ``--cfg`` YAML < trailing ``KEY VALUE`` overrides),
plus every key ``config/serve_resnet50.yaml`` sets, so the shipped YAML
merges unchanged. Keys marked "not yet ported" are accepted and not acted
on. The ``SERVE.DEPLOY`` and ``SERVE.INGRESS`` subtrees (rollout watcher,
multi-pod router) are not part of this slice and are absent.
"""

from __future__ import annotations

import argparse
import sys

from distribuuuu_tpu_torch.cfgnode import CfgNode as CN

_C = CN()
cfg = _C

_C.MODEL = CN()
_C.MODEL.ARCH = "resnet18"
_C.MODEL.NUM_CLASSES = 1000
# single-model host when SERVE.MODELS is empty: a torch .pt/.pth state_dict
_C.MODEL.WEIGHTS = None
# compute dtype of convs and linears; params and BN stay float32
_C.MODEL.DTYPE = "bfloat16"
# the space-to-depth stem is the plain 7x7/2 stem by construction; the
# port always computes the plain stem, so this key changes nothing
_C.MODEL.STEM_S2D = False
# accepted so JAX-side YAMLs merge; on the card the epilogue kernel always runs
_C.MODEL.FUSED_EPILOGUE = None
# BN boundary dtype for training; serving keeps float32 boundaries, as the
# JAX engine does. Not yet ported (the training slice reads it)
_C.MODEL.BN_DTYPE = "auto"

_C.TEST = CN()
_C.TEST.CROP_SIZE = 224

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

_CFG_DEFAULT = _C.clone()
_CFG_DEFAULT.freeze()


def reset_cfg() -> None:
    """Reset the config to its defaults (leaves the singleton mutable)."""
    _C.defrost()
    _C.clear()
    for k, v in _CFG_DEFAULT.clone().items():
        _C[k] = v


def load_cfg_fom_args(description: str = "Config file options.", argv=None) -> None:
    """``--cfg FILE`` then trailing ``KEY VALUE`` overrides (the JAX CLI
    contract, including its spelling)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cfg", dest="cfg_file", default=None, type=str)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.cfg_file is not None:
        _C.merge_from_file(args.cfg_file)
    if args.opts:
        _C.merge_from_list(args.opts)
