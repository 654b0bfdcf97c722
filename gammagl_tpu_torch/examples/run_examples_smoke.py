"""Smoke-run the twin of every example dir and report a pass/fail table.

Counterpart of the JAX repo's `scripts/run_examples_smoke.py`: every dir
of the repo's ``examples/`` maps to its twin in this package (the file of
the dir's trainer, by the JAX script's choice of trainer, or the name
`TWINS` gives it), and each twin runs in its own process on ``--device``
(the card by default) with a tiny epoch count where its flags have one:

    python -m gammagl_tpu_torch.examples.run_examples_smoke            # all
    python -m gammagl_tpu_torch.examples.run_examples_smoke gcn gat    # some
    python -m gammagl_tpu_torch.examples.run_examples_smoke \\
        --device cpu --jobs 2                   # parallel (the CPU only)

A dir without a twin is an error, not a skip, unless `NO_TWIN` lists it
with the reason. Success is exit code 0 within ``--timeout``; the run
exits 1 on any failure.
"""

import argparse
import concurrent.futures as cf
import importlib
import json
import os
import os.path as osp
import subprocess
import sys
import time

PKG = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(osp.dirname(PKG))
EX = osp.join(ROOT, "examples")

# twins that need flags to stay small (the JAX script's)
EXTRA_ARGS = {
    "papers100m": ["--scale", "0.0002", "--epochs", "2"],
}
EPOCH_FLAGS = ("--n_epoch", "--epochs", "--n_epochs")
# dirs whose twin is not named after the dir's trainer file
TWINS = {"database": "database_trainer.py"}
# dirs with no twin, with the reason (none)
NO_TWIN = {}


def jax_dirs():
    """The example dirs of the repo, sorted (the JAX script's list)."""
    if not osp.isdir(EX):
        raise FileNotFoundError(f"no examples dir at {EX}: the sweep maps "
                                "the repo's example dirs to their twins")
    return sorted(d for d in os.listdir(EX)
                  if osp.isdir(osp.join(EX, d)) and not d.startswith("_"))


def find_trainer(d):
    """The JAX script's trainer of dir ``d``: its first ``*_trainer.py``,
    else its first ``.py`` (None without one)."""
    path = osp.join(EX, d)
    cands = sorted(f for f in os.listdir(path) if f.endswith("_trainer.py"))
    if not cands:
        cands = sorted(f for f in os.listdir(path) if f.endswith(".py"))
    return cands[0] if cands else None


def find_twin(d):
    """The twin's file in this package for example dir ``d``, or None."""
    name = TWINS.get(d) or find_trainer(d)
    if name is None or not osp.exists(osp.join(PKG, name)):
        return None
    return osp.join(PKG, name)


def _module(path):
    return "gammagl_tpu_torch.examples." + osp.basename(path)[:-3]


def epoch_args(flags, source):
    """The JAX script's epoch-flag search: the first of `EPOCH_FLAGS`
    among the twin's flags (its parser's, else its source's), at 2."""
    for flag in EPOCH_FLAGS:
        if flag in flags or f'"{flag}"' in source or f"'{flag}'" in source:
            return [flag, "2"]
    return []


def twin_argv(module, device, extra=None):
    """The twin's arguments: ``--device`` where it has the flag, then
    ``extra`` (`EXTRA_ARGS`), else the tiny epoch count."""
    mod = importlib.import_module(module)
    parser = getattr(mod, "parser", None)
    flags = set(parser()._option_string_actions) if parser else set()
    with open(mod.__file__, encoding="utf-8") as f:
        source = f.read()
    argv = ["--device", device] if "--device" in flags else []
    return argv + (list(extra) if extra else epoch_args(flags, source))


def _child():
    """Run a twin as ``python -m`` would, with `twin_argv`'s arguments
    (argv: module, device, then `EXTRA_ARGS`' entry)."""
    import runpy
    module, device, extra = sys.argv[1], sys.argv[2], sys.argv[3:]
    argv = twin_argv(module, device, extra)
    print("argv:", " ".join(argv), flush=True)
    sys.argv = [module] + argv
    sys.modules.pop(module)  # it runs afresh as __main__
    runpy.run_module(module, run_name="__main__", alter_sys=True)


def run_one(d, timeout, device):
    """(dir, status, seconds) of the twin of ``d``."""
    if d in NO_TWIN:
        return d, f"SKIP ({NO_TWIN[d]})", 0.0
    twin = find_twin(d)
    if twin is None:
        return d, "FAIL no twin", 0.0
    env = dict(os.environ)
    # never let a resolver stall a twin: every loader stays offline
    env.setdefault("GGL_TPU_OFFLINE", "1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    code = ("from gammagl_tpu_torch.examples.run_examples_smoke import "
            "_child; _child()")
    args = [sys.executable, "-c", code, _module(twin), device,
            *EXTRA_ARGS.get(d, [])]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(args, capture_output=True, text=True,
                           timeout=timeout, env=env, cwd=ROOT)
        dt = time.perf_counter() - t0
        if r.returncode == 0:
            return d, "OK", dt
        tail = (r.stderr or r.stdout).strip().splitlines()[-1:]
        return d, f"FAIL rc={r.returncode}: {' '.join(tail)[:150]}", dt
    except subprocess.TimeoutExpired:
        return d, f"TIMEOUT >{timeout}s", time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*", help="example dirs (default all)")
    ap.add_argument("--timeout", type=int, default=420)
    ap.add_argument("--jobs", type=int, default=1,
                    help=">1 requires --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    ap.add_argument("--json", default=None,
                    help="write per-example {status, seconds} to this "
                         "JSON file")
    args = ap.parse_args(argv)
    if args.jobs > 1 and args.device != "cpu":
        ap.error("--jobs > 1 requires --device cpu")
    dirs = args.dirs or jax_dirs()
    results = []

    def report(res):
        d, status, dt = res
        print(f"{d:24s} {status:40s} {dt:6.1f}s", flush=True)
        results.append(res)

    if args.jobs > 1:
        with cf.ThreadPoolExecutor(args.jobs) as pool:
            futs = [pool.submit(run_one, d, args.timeout, args.device)
                    for d in dirs]
            for f in cf.as_completed(futs):
                report(f.result())
    else:
        for d in dirs:
            report(run_one(d, args.timeout, args.device))
    bad = [r for r in results if not r[1].startswith(("OK", "SKIP"))]
    print(f"\n{len(results) - len(bad)}/{len(results)} passed")
    if args.json:
        payload = {
            "device": args.device, "timeout_s": args.timeout,
            "passed": len(results) - len(bad), "total": len(results),
            "examples": {d: {"status": s, "seconds": round(t, 1)}
                         for d, s, t in sorted(results)},
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")
    if bad:
        print("failures:", ", ".join(d for d, *_ in bad))
        sys.exit(1)


if __name__ == "__main__":
    main()
