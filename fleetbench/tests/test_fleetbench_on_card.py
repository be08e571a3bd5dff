"""A short ``su-hour`` run on the card, through the benchmark's own command.
Skips without a card; run on the card with
``python -m pytest -m cuda fleetbench/tests/test_fleetbench_on_card.py``."""

import json
import subprocess
import sys

import pytest

from conftest import CHECKOUT


@pytest.mark.cuda
def test_su_hour_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "fleetbench/run.py", "--workload", "su-hour",
                           "--seed", str(2**31 + 77), "--seconds", "10", "--trace", "0"],
                          cwd=CHECKOUT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert {"sweep_s", "sweep_rss_mb", "setup_s"} <= set(line["metrics"])
