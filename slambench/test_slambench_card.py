"""A run of every cell on the card: the command as the benchmark's check
runs it, at the benchmark's `run_seconds` (a shorter window may end before
the frames whose calls the check compares), a correct result line."""

import json
import os
import subprocess
import sys

import pytest

from slambench import testing
from slambench.lib import spec

BENCH = spec.load_benchmark(testing.ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run([sys.executable, os.path.join("slambench", "run.py"), "--workload", cell,
                          "--seed", "7", "--seconds", str(BENCH["run_seconds"]), "--trace", "0"],
                         cwd=testing.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] >= 1, line
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"frames_per_s", "host_rss_mb", "setup_s"}
