"""The port's tutorials run with ``--cpu`` (8 gloo ranks each, as the JAX
tutorials' 8-device CPU mesh; ~13 s each here) and print their lessons.

- ``tutorial/torch_huge_head_tp.py``: data 2 x model 4, the sharded head's
  final acc@1 >= 0.9;
- ``tutorial/torch_pipeline_moe.py``: 8 stages x 4 microbatches equal to the
  dense stack at every one of 21 steps, then 8 experts whose task loss
  falls below 0.8 with aux below 1.5.

Each tutorial checks its own lessons and exits non-zero when one fails; the
test also reads the lines. A run past its deadline is killed with its
ranks (they share its process group)."""

import os
import re
import signal
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 150


def _run(name: str) -> str:
    proc = subprocess.Popen([sys.executable, str(ROOT / "tutorial" / name), "--cpu"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{name} passed its {DEADLINE_S} s deadline:\n{out[-3000:]}")
    assert proc.returncode == 0, f"{name} exited {proc.returncode}:\n{out[-3000:]}"
    return out


def test_huge_head_tutorial_learns_2048_classes():
    out = _run("torch_huge_head_tp.py")
    assert "mesh: data=2 model=4 | classes: 2048 | head shard/rank: 128x512" in out, out
    final = re.search(r"final acc@1 (\S+) \(>= 0\.9: the sharded head learned 2048 classes\)",
                      out)
    assert final is not None and float(final[1]) >= 0.9, out


def test_pipeline_moe_tutorial_lessons_hold():
    out = _run("torch_pipeline_moe.py")
    assert "[pipeline] 8 stages x 4 microbatches over {stage: 8}" in out, out
    assert "pipeline == dense at every step of the trajectory." in out, out
    final = re.search(r"final   loss (\S+)  aux (\S+)", out)
    assert final is not None and float(final[1]) < 0.8 and float(final[2]) < 1.5, out
    assert "router stayed balanced and the mixture learned." in out, out
