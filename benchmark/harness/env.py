"""The run's surroundings: cache directories, the card, set-up phases and
the modules that may not be loaded.

`prepare_environment` runs before torch is imported: it points every
kernel cache at a fixed directory inside the checkout, so that only a
cell's first run in a checkout builds, and keeps libraries from loading
JAX by themselves.
"""

import os
import subprocess
import sys
import time

# top-level module names that no process of the benchmark may hold: JAX
# and the JAX package that the port was made from (compared whole, so
# the port's own name, which starts with the JAX package's, passes)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gammagl_tpu")

# cache directories, relative to the checkout's root
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
    "TRITON_CACHE_DIR": ".bench_cache/triton",
    "CUDA_CACHE_PATH": ".bench_cache/nv",
}


def prepare_environment(root):
    for var, rel in CACHE_DIRS.items():
        path = os.path.join(root, rel)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """The loaded modules whose top-level name is forbidden."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN_MODULES})


def sync(device):
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Phases:
    """Set-up phases on the host clock, from the process's start."""

    def __init__(self, t_start):
        self.t_start = t_start
        self.t_last = t_start
        self.rows = []

    def mark(self, name):
        now = time.perf_counter()
        self.rows.append((name, now - self.t_last))
        log(f"setup: {name} {now - self.t_last:.3f} s")
        self.t_last = now

    def since_start(self):
        return time.perf_counter() - self.t_start


def card_facts():
    """The card's name and power limit as nvidia-smi reads them (None
    where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else None
