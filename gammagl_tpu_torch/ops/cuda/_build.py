"""Build the CUDA sources of the package with nvcc and load them by ctypes.

The sources under ``gammagl_tpu_torch/csrc/`` have a plain C interface.
At first use each ``.cu`` is compiled for Hopper (``sm_90a``) by its own
nvcc process, all started together, and the objects are linked into one
shared library under ``gammagl_tpu_torch/_build/``, named by a hash of
the sources and flags, so an edit to a source rebuilds it and an
unchanged tree reuses it. There is no fallback: without nvcc, or when it
fails, this raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS"]

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _find_nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").is_file():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # torch's own search
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $PATH and torch's CUDA_HOME): "
        "the CUDA kernels of gammagl_tpu_torch are built from source at "
        "first use and need the CUDA toolkit")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _digest(files):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds, log):
    """Run the commands in parallel, append their output to ``log``, and
    raise on the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    with log.open("a") as f:
        for cmd, out in zip(cmds, outs):
            f.write(" ".join(cmd) + "\n" + out)
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode} (full log in "
                f"{log}):\n{' '.join(cmd)}\n{out[-4000:]}")


def _compile(units, lib_path):
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    log = lib_path.with_suffix(".log")
    log.write_text("")
    objs = [BUILD_DIR / f"{tag}.{u.stem}.o" for u in units]
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(u)]
              for u, o in zip(units, objs)], log)
        _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *map(str, objs)]], log)
        os.replace(tmp, lib_path)  # atomic: a concurrent build sees all/none
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)


@functools.lru_cache(maxsize=None)
def load_library():
    """Return the package's kernel library as a ``ctypes.CDLL``, compiling
    it first when no build of the current sources exists. The compiler's
    output (register and shared-memory use from ``-Xptxas -v``) is kept
    beside the library, with the suffix ``.log``."""
    units, headers = _sources()
    if not units:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    lib_path = BUILD_DIR / f"libgammagl_kernels_{_digest(units + headers)}.so"
    if not lib_path.is_file():
        _compile(units, lib_path)
    return ctypes.CDLL(str(lib_path))
