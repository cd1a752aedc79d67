"""On the card, at each cell's own size: the control (the reference with
float8 products, put in the program's place) fails the cell's check on
three seeds, and the program passes it on the same seeds. Skips without a
CUDA device; run on the chip with

    python -m pytest -m gpu perfbench/tests/test_perfbench_gpu.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = "2900000001,2900000002,2900000003"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_at_cell_size(cell, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their own size on the card")
    run_s = json.loads((REPO / "BENCHMARK.json").read_text())["run_seconds"]
    out = tmp_path / "readings.jsonl"
    proc = subprocess.run([sys.executable, str(HERE / "calibrate.py"), "--workload", cell,
                           "--seeds", SEEDS, "--control-seeds", SEEDS, "--seconds", str(run_s),
                           "--out", str(out)], capture_output=True, text=True, timeout=3000)
    assert proc.returncode == 0, proc.stderr[-3000:]
    limits = json.loads((HERE / "checks" / f"{cell}.json").read_text())["numbers"]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    for row in rows:
        got = row["numbers"]
        over = [k for k in limits if got.get(k) is None or got[k] > limits[k]["limit"]]
        if row["kind"] == "program":
            assert not over, row
        else:
            assert over, row
