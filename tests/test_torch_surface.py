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
missing: COVERED names what covers each one in the port.
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
    "parallel/__init__.py": {name: _MESH for name in (
        "make_mesh", "replicate", "shard", "PartitionSpec",
        "NamedSharding")},
    "parallel/mesh.py": {name: _MESH for name in (
        "make_mesh", "replicate", "shard", "PartitionSpec",
        "NamedSharding")},
}

MISSING_NAMES = {
    "layers/conv/__init__.py": [
        "FusedGATConv", "MAGCLConv", "MGNNI_m_iter",
        "ConstCurveLinear", "ConstCurveAgg", "EuclideanEncoder",
        "ManifoldEncoder", "VectorQuantizeE", "VectorQuantizeR",
    ],
    "models/__init__.py": [
        "GraphSAGE_Full_Model", "GraphSAGE_Sample_Model",
        "RGCN", "CompGCN", "HAN", "GRADE",
        "Graphormer",
        "DeepWalkModel", "Node2vecModel",
        "DGCNN",
        "AGNNModel", "FILMModel", "GMMModel", "DNAModel", "HCHA",
        "LogReg", "SkipGramModel", "HERec", "TADWModel", "MGNNI_m_att",
        "DFADModel", "DFADGenerator", "Generator", "Discriminator",
        "EigenMLP", "Encoder", "SpaSpeNode", "ReModel",
        "EdgePromptNodeClassifier", "FusedGATModel", "GNN",
        "amp_elbo_regression_loss",
        "DeepWalk",
        "Node2Vec", "MetaPath2Vec",
        "GraphormerModel", "SGFormerModel", "GNNLFHFModel",
        "CAGCNModel",
        "MERITModel", "GRADEModel", "tadw",
        "GraphGAN", "herec", "distill_loss",
        "GLNNStudent", "DeFoGModel",
        "XEyTransformerLayer", "timestep_embedding",
        "flow_interpolate", "euler_sample_step", "GraphTextCLIP",
        "GraphLlamaAdapter", "GraphLlamaLM", "TinyCausalLM",
        "LLaGAProjector", "build_stage2_batch", "llaga_hop_field",
        "llaga_neighborhood_detail", "LLaGAEncoder",
        "splice_graph_embeddings",
        "drnl_node_labeling", "SEALModel", "CoGSLModel",
        "RGTModel", "rgt_loss", "rgt_cl_loss",
    ],
    "loader/__init__.py": [
        "ExtractNodeLoader", "ExtractLinkLoader", "build_structure_batch",
        "ShardedFeatureStore", "MultiHostNodeLoader", "shard_seeds",
        "make_global_batch", "pad_sampled_graph",
    ],
    "loader/feature_cache.py": [
        "ShardedFeatureStore",
    ],
    "models/wave3_models.py": [
        "SGFormerModel", "GNNLFHFModel", "CAGCNModel", "MERITModel",
        "GRADEModel", "tadw",
    ],
    "parallel/__init__.py": [
        "EdgePartition", "partition_edges_by_dst",
        "partition_edges_uniform", "sharded_spmm", "make_sharded_spmm",
        "HierHaloPartition", "build_hier_halo_partition",
        "make_hier_halo_spmm", "traffic_report",
        "PlannedHierHaloPartition",
        "build_hier_halo_partition_planned",
        "make_hier_halo_spmm_planned", "AttnHaloPartition",
        "build_halo_partition_attn", "make_partitioned_gat_layer",
        "pipeline_apply", "make_feature_sharded_spmm",
        "relation_expert_spmm", "make_relation_expert_spmm",
        "shard_expert_weights", "make_pipeline_apply",
        "shard_pipeline_params", "make_partitioned_gat_train",
        "HwModel", "V5E", "halo_scaling_estimate",
    ],
    "parallel/full_graph.py": [
        "make_partitioned_gat_train",
    ],
    "parallel/halo_plan.py": [
        "PlannedHierHaloPartition",
        "build_hier_halo_partition_planned",
        "make_hier_halo_spmm_planned",
    ],
    "parallel/partition.py": [
        "EdgePartition", "partition_edges_by_dst",
        "partition_edges_uniform",
    ],
    "serve.py": [
        "export_forward", "save_exported", "load_exported",
        "ShardedInferenceSession",
    ],
    "train/__init__.py": [
        "save_checkpoint_sharded", "load_checkpoint_sharded",
    ],
    "train/state.py": [
        "save_checkpoint_sharded", "load_checkpoint_sharded",
    ],
    "utils/__init__.py": [
        "chain_time", "trace", "device_timer", "calc_A_norm_hat",
        "edge_index_to_adj_matrix", "get_few_shot_split",
        "node_subgraph", "set_device", "shortest_path_distance",
        "batched_shortest_path_distance",
        "segment_softmax", "shortest_path", "from_smiles",
        "manifold_math", "gfm_utils",
        "Conversation", "conv_templates", "get_conv_template",
        "find_all_simple_paths", "read_embeddings", "save_embeddings",
        "Inspector",
    ],
}

MISSING_MODULES = [
    "layers/attention/__init__.py",
    "layers/attention/graphormer.py", "layers/attention/rgt.py",
    "layers/conv/compat_convs.py",
    "layers/conv/rgt_layers.py", "layers/conv/rgt_vq.py",
    "loader/multihost.py",
    "loader/rgt_loader.py", "models/compat.py",
    "models/defog.py", "models/embedding.py", "models/gan_distill.py",
    "models/graph_llm.py", "models/graphormer.py",
    "models/rgt.py", "models/seal_cogsl.py",
    "parallel/halo_attention.py",
    "parallel/hier_halo.py", "parallel/scaling.py", "parallel/spmm.py",
    "parallel/strategies.py", "typing.py",
    "utils/compat_utils.py", "utils/conversation.py", "utils/gfm_utils.py",
    "utils/manifold_math.py",
    "utils/paths_io.py",
    "utils/profiling.py", "utils/shortest_path.py",
    "utils/smiles.py",
]


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
