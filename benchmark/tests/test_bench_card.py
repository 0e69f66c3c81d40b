"""The entry on and off the card: without a card (or without the program
beside the benchmark) a run fails and prints no result; on the card a
short run of a cell comes out correct."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gin.pretrain_node_b512", "--seed", str(2**31 + 3), "--seconds",
         "2", "--trace", "0", *extra], cwd=cwd, capture_output=True,
        text=True, timeout=600)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(harness.ROOT)
    assert r.returncode != 0 and r.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark")
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = _run(harness.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
