"""The port's public surface against the JAX package's: what is still
missing, frozen here, so the lists always say exactly what is left.

Both packages' ``__all__`` lists are read from their source by AST (no
import), module by module: `gammagl_tpu/<path>` against
`gammagl_tpu_torch/<path>`, and the TPU kernels' package `ops/pallas/`
against the port's `ops/cuda/`. Two frozen lists:

* MISSING_NAMES: for each JAX module that has a counterpart file, the
  names of its ``__all__`` the counterpart's ``__all__`` lacks;
* MISSING_MODULES: the JAX modules with no counterpart file (`ops/pallas/`
  excluded: its kernels have hand-written counterparts under `ops/cuda/`
  and `csrc/`, PERF.md section 6).

Each list may only shrink: the tests fail when the port lacks a name or
a module the lists do not hold, and when a listed name or module appears
in the port and is not removed from the list. TPU-only names are not
missing: COVERED names what covers each one in the port, and
COVERED_OPTIONS the TPU-only parameters and switches that ported
functions leave out, with the reason.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(ROOT, "gammagl_tpu")
PORT_ROOT = os.path.join(ROOT, "gammagl_tpu_torch")

# JAX module -> {TPU-only name: (port module, the name in its __all__ that
# covers it, why)}
_SPMM = "ops/cuda/segment_matmul.py"
_MESH = ("parallel/mesh.py", "part_world",
         "one process a part over torch.distributed: no device mesh, no "
         "sharding specs")
_TPU_KERNELS = {
    "BlockedCSRPlan": (_SPMM, "CSRPlan",
                       "build_csr_plan_blocked gives one CSRPlan: a CSR "
                       "read by the card needs no source blocks"),
    "pack_halves": (_SPMM, "spmm_csr",
                    "the kernels read bf16 rows 16 bytes at a time: no "
                    "packed table of halves"),
    "unpack_halves": (_SPMM, "spmm_csr",
                      "the kernels read bf16 rows 16 bytes at a time: no "
                      "packed table of halves"),
}
_V5E = ("parallel/scaling.py", "HwModel",
        "a TPU's figures; the port's model is HwModel(), the H100's")
COVERED = {
    "ops/pallas/__init__.py": _TPU_KERNELS,
    "ops/pallas/segment_matmul.py": {
        **_TPU_KERNELS,
        "segment_matmul_dyn": (_SPMM, "spmm_csr",
                               "TPU row 1's kernel (PERF.md section 6)"),
        "segment_matmul_dyn_vjp": (_SPMM, "spmm_csr_acc",
                                   "its traced-layout SpMM: spmm_csr and "
                                   "spmm_csr_acc on the plan's arrays"),
    },
    "parallel/__init__.py": {
        **{name: _MESH for name in ("make_mesh", "replicate", "shard",
                                    "PartitionSpec", "NamedSharding")},
        "V5E": _V5E},
    "parallel/mesh.py": {name: _MESH for name in (
        "make_mesh", "replicate", "shard", "PartitionSpec",
        "NamedSharding")},
    "parallel/scaling.py": {"V5E": _V5E},
}

# TPU-only options of ported functions (a parameter, or a module-level
# switch): JAX module -> {option: (port module, why the port has none)}
_JIT = ("the jit boundary: the port's tiers run eagerly, their plans "
        "placed on the card once, never embedded in a program")
_INTERPRET = ("Pallas interpret mode; a CPU tensor takes the kernels' "
              "plain versions")
_PACKED = ("the packed bf16 gather of the halo tiers: the CSR kernels "
           "read bf16 rows 16 bytes at a time, in every width")
_GROUP = ("one process a part over torch.distributed: a process `group` "
          "(None: the default group) in place of a device mesh and its "
          "named axis")
_SPEC = ("a process's view of a global array is its own block: no "
         "sharding spec to place it by")
COVERED_OPTIONS = {
    "parallel/spmm.py": {
        "mesh": ("parallel/spmm.py", _GROUP),
        "axis": ("parallel/spmm.py", _GROUP),
    },
    "parallel/strategies.py": {
        "mesh": ("parallel/strategies.py", _GROUP),
        "axis": ("parallel/strategies.py", _GROUP),
    },
    "loader/multihost.py": {
        "mesh": ("loader/multihost.py", _GROUP),
        "axis": ("loader/multihost.py", _GROUP),
        "spec": ("loader/multihost.py", _SPEC),
    },
    "loader/feature_cache.py": {
        "mesh": ("loader/feature_cache.py", _GROUP),
        "axis": ("loader/feature_cache.py", _GROUP),
    },
    "serve.py": {
        "mesh": ("serve.py", _GROUP),
        "param_spec": ("serve.py", "each process holds the whole model: "
                       "parameters are replicated, never cut"),
        "platforms": ("serve.py", "an artifact is traced for one device "
                      "(export_forward, C53)"),
    },
    "parallel/halo_plan.py": {
        "as_args": ("parallel/halo_plan.py", _JIT),
        "interpret": ("parallel/halo_plan.py", _INTERPRET),
        "_PACKED_HALO": ("parallel/halo_plan.py", _PACKED),
    },
    "parallel/full_graph.py": {
        "as_args": ("parallel/full_graph.py", _JIT),
    },
    "parallel/halo_attention.py": {
        "interpret": ("parallel/halo_attention.py", _INTERPRET),
    },
}

MISSING_NAMES = {}

MISSING_MODULES = []


def _modules(root):
    """Every .py file under ``root``, by its path relative to it."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root)] = path
    return out


def _all(path):
    """The module's literal ``__all__``, or None when it has none."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return None


def _counterpart(path):
    if path.startswith("ops/pallas/"):
        return "ops/cuda/" + path[len("ops/pallas/"):]
    return path


JAX_MODULES, PORT_MODULES = _modules(JAX_ROOT), _modules(PORT_ROOT)


def _missing_names():
    out = {}
    for path in sorted(JAX_MODULES):
        port = PORT_MODULES.get(_counterpart(path))
        names = _all(JAX_MODULES[path])
        if port is None or names is None:
            continue
        have = set(_all(port) or ())
        lacking = [n for n in names
                   if n not in have and n not in COVERED.get(path, {})]
        if lacking:
            out[path] = lacking
    return out


def test_missing_names_are_exactly_the_frozen_list():
    got = _missing_names()
    for path in sorted(set(got) | set(MISSING_NAMES)):
        now, frozen = got.get(path, []), MISSING_NAMES.get(path, [])
        ported = sorted(set(frozen) - set(now))
        assert not ported, (f"{path}: {ported} are in the port now; remove "
                            "them from MISSING_NAMES")
        lost = sorted(set(now) - set(frozen))
        assert not lost, f"{path}: the port lacks {lost}, not in the list"
        assert len(now) == len(frozen), f"{path}: a name listed twice"


def test_missing_modules_are_exactly_the_frozen_list():
    now = sorted(p for p in JAX_MODULES if not p.startswith("ops/pallas/")
                 and p not in PORT_MODULES)
    ported = sorted(set(MISSING_MODULES) - set(now))
    assert not ported, (f"{ported} have counterparts now; remove them from "
                        "MISSING_MODULES")
    assert sorted(MISSING_MODULES) == now


@pytest.mark.parametrize("path", sorted(COVERED))
def test_covered_names_name_what_covers_them(path):
    """Each covered name is in the JAX module's ``__all__`` and not in
    its counterpart's (else it is ported), and what covers it is in the
    ``__all__`` of the port module named."""
    jax_names = _all(JAX_MODULES[path])
    port_names = set(_all(PORT_MODULES[_counterpart(path)]) or ())
    for name, (module, cover, why) in COVERED[path].items():
        assert name in jax_names and name not in port_names, name
        assert cover in (_all(PORT_MODULES[module]) or ()), (name, cover)
        assert why


def _options(path):
    """Every function parameter and module-level name bound in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            names.update(x.arg for x in a.posonlyargs + a.args
                         + a.kwonlyargs)
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return names


@pytest.mark.parametrize("path", sorted(COVERED_OPTIONS))
def test_covered_options_are_jax_only(path):
    """Each TPU-only option is a parameter or module-level switch of the
    JAX module and of no function or module level of the port's."""
    jax_opts = _options(JAX_MODULES[path])
    for option, (module, why) in COVERED_OPTIONS[path].items():
        assert option in jax_opts, option
        assert option not in _options(PORT_MODULES[module]), option
        assert why
