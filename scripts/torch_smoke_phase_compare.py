#!/usr/bin/env python3
"""One phase of ``chip_smoke.py`` alone, in this checkout or in two in turns.

    python3 scripts/torch_smoke_phase_compare.py train_fsdp                 # this checkout
    python3 scripts/torch_smoke_phase_compare.py train_fsdp --compare DIR   # DIR, this
    python3 scripts/torch_smoke_phase_compare.py train_fsdp --compare DIR --turns 2
                                                                # DIR, this, this, DIR

Each run is a process of its own from the root of its checkout: it imports
that checkout's ``chip_smoke``, builds the kernels (``phase_build``, not
timed), then times ``phase_<PHASE>`` as the smoke calls it, with the smoke's
own lines and checks (the ``test_net`` runs a phase defers to the smoke's
end are not made). Phases whose arguments without a default are among
``card``, ``smi``, ``tmp``, ``bw`` and ``deferred`` can run (``train_mae``,
``train_fsdp``, ``serve_int8``, ``train_preempt``, ``train_qat``, ``deploy``,
...). The phase's wall in s, per run, with the card's
name and power limit, as the last line (JSON). Needs a CUDA GPU; imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r"""
import inspect, json, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
phase = getattr(cs, "phase_" + sys.argv[1])
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = torch.cuda.get_device_name(0)
smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
cs.phase_build()
deferred = []
with tempfile.TemporaryDirectory() as tmp:
    given = dict(card=card, smi=smi, tmp=Path(tmp), bw=cs.hbm_bytes_per_s(card), deferred=deferred)
    args = [given[p] for p, v in inspect.signature(phase).parameters.items()
            if v.default is inspect.Parameter.empty]
    tic = time.perf_counter()
    phase(*args)
    wall = time.perf_counter() - tic
print("PHASE_RESULT " + json.dumps({"wall_s": wall, "card": smi}))
"""


def run_tree(tree: Path, phase: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, phase], cwd=tree, capture_output=True,
                          text=True, timeout=1200)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.exit(f"{tree}: phase {phase} failed (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("PHASE_RESULT ")][-1]
    return dict(json.loads(line.split(" ", 1)[1]), tree=str(tree))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", help="the name after phase_ in chip_smoke.py, e.g. train_fsdp")
    ap.add_argument("--compare", type=Path, help="another checkout's root")
    ap.add_argument("--turns", type=int, default=1, help="with --compare: 2 runs DIR, this, "
                    "this, DIR")
    a = ap.parse_args()
    order = [ROOT] if a.compare is None else [a.compare.resolve(), ROOT]
    if a.compare is not None and a.turns == 2:
        order += order[::-1]
    runs = [run_tree(tree, a.phase) for tree in order]
    for r in runs:
        print(f"[phase {a.phase}] {r['tree']}: {r['wall_s']:.1f} s ({r['card']})")
    print(json.dumps({"phase": a.phase, "runs": runs}))


if __name__ == "__main__":
    main()
