"""The harness: everything found by name from files; a cell, a
configuration and a per-layer metric added as files and entries only;
the run refusing without a card; the forbidden modules."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import torch

import run
from harness import env

TINY_GCN = {"graph": {"scale": 0.0001}}


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pyc"):
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_cell_config_metric_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration (gcn-tiny, with its
    model and reference files), a cell on it and a per-layer metric
    (steps.train) by new files and new entries of BENCHMARK.json; no file
    the benchmark had changes, and the harness runs the new cell and
    reads the new metric."""
    bdir = tmp_path / "benchmark"
    shutil.copytree(run.BENCH_DIR, bdir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(bdir)
    bench = json.loads(open(os.path.join(run.ROOT, "BENCHMARK.json")).read())

    cfg = json.loads((bdir / "configs" / "gcn-papers100m-1pct.json")
                     .read_text())
    cfg.update(name="gcn-tiny", graph=dict(cfg["graph"], scale=0.0001))
    (bdir / "configs" / "gcn-tiny.json").write_text(json.dumps(cfg))
    for what in ("models", "reference"):
        shutil.copy(bdir / what / "gcn-papers100m-1pct.py",
                    bdir / what / "gcn-tiny.py")
    shutil.copy(bdir / "limits" / "gcn-papers100m-1pct.train.json",
                bdir / "limits" / "gcn-tiny.train.json")
    (bdir / "metrics" / "steps.train.py").write_text(
        "def read(ctx):\n"
        "    return float(ctx['window']['units'])\n")
    bench["configs"].append({"name": "gcn-tiny", "source": "test",
                             "file": "benchmark/configs/gcn-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "gcn-tiny.train", "config": "gcn-tiny",
                               "traffic": "train", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append("gcn-tiny.train")
    bench["per_layer"].append({"name": "steps.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "training loop",
                               "moves": "train_step_ms",
                               "workloads": ["gcn-tiny.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(bdir)
    assert all(after[k] == v for k, v in before.items())

    cell = run.Cell(str(tmp_path), "gcn-tiny.train")
    assert cell.cfg["graph"]["scale"] == 0.0001
    assert cell.paths["model"].endswith("models/gcn-tiny.py")
    assert [m["name"] for m in cell.per_layer] == ["steps.train"]
    assert {m["name"] for m in cell.end_to_end} == {"train_step_ms",
                                                   "setup_s"}
    cpu = torch.device("cpu")
    res = run.run_cell(cell, 3, 0.2, True, cpu, env.Phases(time.perf_counter()))
    assert res["metrics"]["steps.train"]["value"] >= 1
    assert set(res["checks"]) == set(cell.limits)
    res = run.run_cell(cell, 3, 0.2, False, cpu,
                       env.Phases(time.perf_counter()))
    assert set(res["metrics"]) == {"train_step_ms", "setup_s"}


def test_every_name_resolves():
    """Every cell of BENCHMARK.json finds its files, and every metric its
    reader."""
    bench = json.loads(open(os.path.join(run.ROOT, "BENCHMARK.json")).read())
    for w in bench["workloads"]:
        cell = run.Cell(run.ROOT, w["name"], bench)
        for p in cell.paths.values():
            assert os.path.isfile(p), p
        assert cell.limits
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(cell.reader(m["name"]), "read")
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(run.BENCH_DIR, "run.py"), "--workload",
         "gcn-papers100m-1pct.train", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=run.ROOT, timeout=300)
    assert out.returncode == 3
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_run_alone_without_the_port(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the run fails and prints no result."""
    shutil.copytree(run.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hgt-ogbn-mag.serve", "--seed", "7", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "gammagl_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    assert not {"gammagl_tpu_torch.fake", "jaxfoo"} & set(
        env.forbidden_modules())
    monkeypatch.setitem(sys.modules, "gammagl_tpu.layers", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"gammagl_tpu.layers", "jaxlib"} <= set(env.forbidden_modules())


def test_seed_past_32_bits():
    assert run.seed_of(2 ** 31 + 12345) == 2 ** 31 + 12345
    assert 0 <= run.seed_of(-5) < 2 ** 62
