"""The port's examples (examples/torch_*.py) run to their end on the CPU:
each the JAX example's steps and asserts through repro_torch, with
--device cpu; the distributed one also in a gloo world of two ranks."""
import os
import subprocess
import sys

import pytest

from torch_worlds import REPO
from torch_worlds import run_env_world as run_world

EXAMPLES = ("torch_quickstart", "torch_serve_async", "torch_stream_refit",
            "torch_distributed_clustering", "torch_cluster_embeddings",
            "torch_train_lm")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(tmp_path, name):
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / f"{name}.py"), "--device",
         "cpu"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip()


def test_distributed_example_over_two_ranks(tmp_path):
    res = run_world([str(REPO / "examples" /
                         "torch_distributed_clustering.py"), "--device",
                     "cpu"], 2, tmp_path)
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
    assert "ranks=2 n=4096 accuracy=" in res[0][1]
    assert not res[1][1].strip()                 # rank 0 prints


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_the_card_by_default(tmp_path, name):
    """Without --device an example runs on the card, and with no card it
    fails: no fallback to the CPU."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / f"{name}.py")],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
