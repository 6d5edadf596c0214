"""``run.py`` refuses to run without a card, and in a checkout that holds
only the benchmark, printing no result."""

import os
import shutil
import subprocess
import sys

import pytest

from port_bench import spec

ARGS = ["--workload", "dav2_vitl.batch8_504", "--seed", str(2**31 + 99), "--seconds", "1", "--trace", "0"]


def run(cwd, env=None):
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run(spec.ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_one_short_run_on_the_card(card):
    """A short run of the first cell on the card prints a correct result line."""
    import json

    out = run(spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
