"""The benchmark of gammagl_tpu_torch, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for. Everything is found by name from `BENCHMARK.json`: the cell's
configuration (``benchmark/configs/<config>.json``, its system under test
``benchmark/models/<model>.py`` and its plain reference
``benchmark/reference/<model>.py``, where ``<model>`` is the file's
``model`` key or else the configuration's name), its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``generator`` names a
general generator in ``benchmark/generators/``), its limits
(``benchmark/limits/<cell>.json``) and one reader a metric
(``benchmark/metrics/<metric>.py``). A cell, configuration or metric is
added by adding files and entries.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit);
the compared numbers are also the last lines of standard error. Exit
codes: 0 a result printed; 3 no card, or fewer than the cell asks for; 4
a forbidden module (JAX or the JAX package) loaded; 1 any other failure.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from harness import env  # noqa: E402

PACKAGE = "gammagl_tpu_torch"


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) else v)
    return out


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of ``workloads`` and everything its name leads to."""

    def __init__(self, root, name, bench=None, cfg_override=None):
        self.root = root
        self.bench = bench or _read_json(os.path.join(root,
                                                      "BENCHMARK.json"))
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        cfg_entry = [c for c in self.bench["configs"]
                     if c["name"] == self.entry["config"]][0]
        bdir = os.path.join(root, "benchmark")
        self.cfg = _merge(_read_json(os.path.join(root, cfg_entry["file"])),
                          cfg_override or {})
        self.traffic = _read_json(os.path.join(
            bdir, "traffic", self.entry["traffic"] + ".json"))
        self.limits = {k: v["limit"] for k, v in _read_json(os.path.join(
            bdir, "limits", name + ".json")).items()}
        # a configuration of other sizes may name the model file (and
        # plain reference) of another: ``"model": <name>``
        model = self.cfg.get("model", self.entry["config"])
        self.paths = {
            "model": os.path.join(bdir, "models", model + ".py"),
            "reference": os.path.join(bdir, "reference", model + ".py"),
            "generator": os.path.join(bdir, "generators",
                                      self.traffic["generator"] + ".py"),
        }
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if _applies(m, name)]
        self.metric_dir = os.path.join(bdir, "metrics")

    def module(self, what):
        return load_module(self.paths[what],
                           f"bench_{what}_{self.entry['config']}")

    def reader(self, metric):
        return load_module(os.path.join(self.metric_dir, metric + ".py"),
                           "bench_metric_" + metric.replace(".", "_")
                           .replace("-", "_"))


class Context:
    """What a traffic generator is handed."""

    def __init__(self, cell, seed, seconds, trace, device, phases,
                 control=False, plant=None):
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.phases = device, phases
        self.model = cell.module("model")
        self.reference = cell.module("reference")
        self.control, self.plant = control, plant

    def memory_peak(self):
        import torch
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def release(self):
        import torch
        gc.collect()
        env.sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def import_port(root, phases):
    """Import the port from this checkout (never from elsewhere) and load
    its kernel library on a card."""
    if not os.path.isfile(os.path.join(root, PACKAGE, "__init__.py")):
        raise FileNotFoundError(
            f"{PACKAGE} is not in {root}: the benchmark measures the port "
            "of the checkout it runs from")
    if root not in sys.path:
        sys.path.insert(1, root)
    import gammagl_tpu_torch  # noqa: F401
    where = os.path.dirname(os.path.abspath(gammagl_tpu_torch.__file__))
    if where != os.path.join(root, PACKAGE):
        raise ImportError(f"{PACKAGE} was imported from {where}, not from "
                          f"the checkout {root}")
    phases.mark("imports (torch, the port)")


def run_cell(cell, seed, seconds, trace, device, phases, control=False,
             plant=None):
    """Drive the cell and read its metrics; returns the result's fields."""
    import torch
    ctx = Context(cell, seed, seconds, trace, device, phases, control, plant)
    out = load_module(cell.paths["generator"], "bench_generator").run(ctx)
    numbers = out["numbers"]
    if out.get("worst"):
        env.log(f"worst leaves: {out['worst']}")
    if control:
        return {"numbers": numbers}
    from harness.compare import verdict
    correct, rows = verdict(numbers, cell.limits)
    mctx = {"kind": out["window"]["kind"], "setup_s": out["setup_s"],
            "window": out["window"], "trace": out.get("trace"),
            "work": out["work"]}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(mctx)
        if value is None:
            env.log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.entry["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        tr = out["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    result["_log"] = {"window": {k: v for k, v in out["window"].items()
                                 if k not in ("host_s", "latency_s")},
                      "reference_s": out.get("reference_s"),
                      "numbers": numbers}
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def seed_of(seed):
    """Any whole number as a generator seed."""
    return int(seed) % (1 << 62)


def open_card(cell, phases):
    """The card the cell runs on, with the port imported and its kernel
    library loaded; None when torch sees fewer cards than the cell asks
    for."""
    import torch
    want = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        env.log(f"no result: the cell asks for {want} card(s) and torch "
                f"sees {have}")
        return None
    import_port(ROOT, phases)
    from gammagl_tpu_torch.ops.cuda._build import load_library
    load_library()
    phases.mark("library (load, or build at a checkout's first run)")
    env.log(f"card: {env.card_facts()}")
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    return device


def main(argv=None):
    args = parse(argv)
    env.prepare_environment(ROOT)
    phases = env.Phases(T_START)
    cell = Cell(ROOT, args.workload)
    device = open_card(cell, phases)
    if device is None:
        return 3
    result = run_cell(cell, seed_of(args.seed), args.seconds, bool(args.trace),
                      device, phases)
    bad = env.forbidden_modules()
    if bad:
        env.log("no result: forbidden modules loaded: " + ", ".join(bad))
        return 4
    info = result.pop("_log")
    env.log(f"window: {json.dumps(info['window'])}; reference "
            f"{info['reference_s']:.3f} s; memory peak "
            f"{result['device']['memory_peak_bytes']} bytes")
    env.log(f"numbers: {json.dumps(info['numbers'])}")
    for name, row in result["checks"].items():
        env.log(f"check {name}: {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
