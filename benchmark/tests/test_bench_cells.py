"""Each cell's run on the CPU at a tiny size, the harness's look for a card
skipped: sound, it is correct; with a fault planted under the timed path,
or with the control (the reference in float8 in the program's place), it
is not. The same limits as on the card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import run
from harness import compare, env

CPU = torch.device("cpu")
TINY = {"gcn-papers100m-1pct.train": {"graph": {"scale": 0.0002}},
        "hgt-ogbn-mag.serve": {"graph": {"scale": 0.002}},
        "hgt-ogbn-mag-halfedges.train": {"graph": {"scale": 0.01}}}
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102)


def _run(name, seed, plant=None, control=False):
    cell = run.Cell(run.ROOT, name, cfg_override=TINY[name])
    return cell, run.run_cell(cell, seed, 0.05, False, CPU,
                              env.Phases(time.perf_counter()),
                              control=control, plant=plant)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct(name, seed):
    _, res = _run(name, seed)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,fault", [
    ("gcn-papers100m-1pct.train", "unchanged"),
    ("gcn-papers100m-1pct.train", "half_batch"),
    ("hgt-ogbn-mag-halfedges.train", "unchanged"),
    ("hgt-ogbn-mag-halfedges.train", "half_batch"),
    ("hgt-ogbn-mag.serve", "altered"),
    ("hgt-ogbn-mag.serve", "half_batch")])
def test_planted_fault_is_not_correct(name, fault, seed):
    _, res = _run(name, seed, plant=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct(name, seed):
    cell, res = _run(name, seed, control=True)
    ok, rows = compare.verdict(res["numbers"], cell.limits)
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_on_the_card_at_the_cells_size(name):
    """The control at the cell's own size on a card fails the limits (one
    process a cell, as `calibrate.py` runs it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(run.BENCH_DIR, "calibrate.py"),
         "--workload", name, "--mode", "control", "--seeds",
         str(2 ** 31 + 77)], capture_output=True, text=True, cwd=run.ROOT,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    numbers = json.loads(out.stdout.strip().splitlines()[-1])["numbers"]
    ok, rows = compare.verdict(numbers, run.Cell(run.ROOT, name).limits)
    assert not ok, rows
