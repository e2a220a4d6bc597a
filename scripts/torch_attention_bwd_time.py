#!/usr/bin/env python3
"""Device times of the PyTorch port's bf16 attention backward past the
cluster route's cut (L > 256), at the timed cases of ``chip_smoke.py``'s
[attention-bwd] there (``ATTN_BWD_CASES``: K4's and K5's shapes, batch 8 at
512^2, and the 512^2 training step's, batch 32).

    python3 scripts/torch_attention_bwd_time.py                  # this checkout
    python3 scripts/torch_attention_bwd_time.py --tree DIR       # the port in DIR
    python3 scripts/torch_attention_bwd_time.py --compare DIR    # DIR, this, this, DIR

Each case calls the public entry point (``fused_attention_backward``, or
``fused_attention_abs_backward`` in table mode) of the package found in the
tree, so two checkouts whose backward kernels differ time against each other
on one card: ``--compare`` runs the other tree, this one, this one and the
other tree, one process each, in that order, and prints the four rows of each
case. A case is timed as [attention-bwd] times it (this checkout's
``attention_bwd_inputs``, ``rotated_timings`` and ``kernel_split``): device ms
a call (the calls replayed from a CUDA graph over input sets that move at
least 128 MiB a replay, so inputs come from device memory, not the 50 MB L2),
ms a call back to back and as a single call (the wrapper's host cost
included), and each CUDA kernel's device µs a call from ``torch.profiler``.
Needs a CUDA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_tree(tree: Path) -> list:
    sys.path.insert(0, str(tree))  # the port under test
    import torch

    from distribuuuu_tpu_torch.ops import attention as att

    # this checkout's chip_smoke (the other tree has one of its own), for its
    # cases, inputs and timers
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    bw = chip_smoke.hbm_bytes_per_s(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, n, l, d, dv, dtype, bias_dtype, timed in chip_smoke.ATTN_BWD_CASES:
        if not (timed and dtype == "bfloat16" and l > att.CLUSTER_MAX_L):
            continue
        fn = (att.fused_attention_abs_backward if bias_dtype == "table"
              else att.fused_attention_backward)

        def inputs(_=0):
            return chip_smoke.attention_bwd_inputs(gen, b, n, l, d, dv, dtype, bias_dtype)

        args = inputs()
        nbytes = chip_smoke.attention_bwd_bound(b * n, l, d, dv, dtype, bias_dtype, bw)[2]
        row = chip_smoke.rotated_timings(fn, lambda i: args if i == 0 else inputs(), nbytes)
        rows.append(dict(case=name, bn=b * n, l=l, mode=bias_dtype,
                         route=att.backward_route(torch.bfloat16, l),
                         kernels_us=chip_smoke.kernel_split(lambda: fn(*args)), **row))
        del args
        torch.cuda.empty_cache()
    return rows


def show(label: str, r: dict) -> str:
    return (f"{r['case']} [{label}: {r['route']}]: B*N {r['bn']}, L {r['l']}, {r['mode']}: device "
            f"{r['device_ms']:.4f} ms, back to back {r['back_to_back_ms']:.4f}, single call "
            f"{r['single_call_ms']:.4f}; " + ", ".join(
                f"{k} {v:.1f} us" for k, v in r["kernels_us"].items()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="checkout whose port to time")
    ap.add_argument("--compare", type=Path, help="another checkout: time it, this, this, it")
    ap.add_argument("--json", action="store_true", help="print the rows as one JSON line")
    args = ap.parse_args()
    if args.compare is None:
        rows = run_tree(args.tree.resolve())
        print(json.dumps(rows) if args.json else "\n".join(show("this", r) for r in rows))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    runs = []
    for label, tree in (("other", args.compare), ("this", ROOT), ("this", ROOT),
                        ("other", args.compare)):
        out = subprocess.run([sys.executable, __file__, "--tree", str(tree.resolve()), "--json"],
                             capture_output=True, text=True, check=True).stdout
        runs.append((label, json.loads(out.splitlines()[-1])))
    for i in range(len(runs[0][1])):
        for label, rows in runs:
            print(show(label, rows[i]))
    print(json.dumps({"card": smi, "runs": runs}))


if __name__ == "__main__":
    main()
