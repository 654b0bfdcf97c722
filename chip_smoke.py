#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gammagl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure ends the run with a non-zero exit:

1. Build the CUDA kernels from gammagl_tpu_torch/csrc/ with nvcc (sm_90a),
   one nvcc per source started together, and print the build time and the
   compiler's register report.
2. Hold the CSR SpMM kernel against its plain PyTorch version on the card:
   bf16 and f32, F in {7, 40, 256}, a graph with empty rows and
   N_src != N_dst, a graph with no edges, a misaligned x, a graph with
   hub rows (a star of 1,200,000 edges into one row and one of 5,000 into
   another, cut into work items whose partials the fold adds; F in {7, 40,
   64, 128, 256}, one launch and one fold a call, repeats bitwise equal;
   the work items printed), and the slice's own graph at F = 256 and
   F = 40, whose rows are not cut; then its backward (dx through the
   kernel on the transpose plan, dw through the SDDMM kernel) on the slice
   graph at F = 256 and 40, bf16 and f32.
3. Hold the flash attention kernels (forward and backward) against their
   plain versions: f32 and bf16, (H, F) in {(8, 8), (1, 40), (1, 64),
   (2, 640)}, with and without a keep mask (in CSR and in the caller's
   order), per-edge and gathered inputs, empty rows with N_src != N_dst,
   no edges, and the slice graph at both GAT layers' shapes, each case run
   twice with every output bitwise equal; time both kernels against the
   plain versions there. Then the forward on the hub graph of phase 2
   (its rows cut into work items) at (8, 8) and (1, 40) bf16, gathered,
   keep in the caller's order: one launch and one `flash_fwd_fold` a
   call, held against the plain version, a repeat bitwise equal, timed
   beside `spmm_csr` at F = H*F on the same graph (and the fold alone);
   and forward and backward on that graph without its star (the
   5,000-edge row cut into 3 items) against the plain versions.
4. Hold the edge-endpoint kernels against their plain versions: the
   destination expand (unscaled: bitwise equal; scaled per edge and head),
   the per-edge segment sum (unit, (E,) and (E, H) weights) and the SDDMM
   (gathered and per-edge rows), f32 and bf16, C in {7, 40, 64}, empty
   rows with N_src != N_dst, no edges, bitwise-equal repeats; the segment
   sum on the hub graph (C in {7, 40, 64}, unit, (E,) and (E, H)
   weights, one launch and one fold a call); the SDDMM on the hub graph,
   its rows cut into work items at `EDGE_SPLIT` (gathered and per edge,
   f32 and bf16, (H, F) in {(1, 256), (8, 8), (2, 640)}, 1e-5, one launch
   and no fold a call), each bf16 form timed beside `spmm_csr` /
   `segment_sum_csr` at the same width there, and the expand there (on
   the same work items: one launch a call, bitwise equal to the plain
   version, timed over 10 calls); on the slice graph
   the expand and segment sum at GATv2's widths, and the SDDMM at
   bench.py's shape (F = 256 bf16, gathered; beside `spmm_csr` at that F
   and the gathered rows' floor) and per edge (H = 8, F = 8), forward and
   backward; time each; registers and spill bytes of every SDDMM and
   expand instantiation (none may spill).
5. Serve full-width GCN (ogbn-arxiv shape: 169,343 nodes, 2,315,598 edges
   plus self-loops, 128 -> 256 -> 256 -> 40, bf16) through
   `InferenceSession` with `Graph.csr_plan()`: 8 requests, each held
   against the plain COO path; exactly 3 SpMM launches a request.
6. Serve GAT on the same graph (128 -> 8 heads x 8 -> 40, bf16): 8
   requests, each held against the plain COO path within 3e-2 of max
   |logit|; exactly 2 flash forward launches a request and nothing else.
7. Train that GAT for 5 full-batch steps (drop rate 0.6, Adam lr 0.005)
   with the fusedgat twin's step, and the same model through the plain COO
   path with the same masks, generator state and parameters: step-0
   gradients of every parameter and the 5 losses held within stated
   tolerances, the loss finite and falling, and per step exactly 2 flash
   forward, 2 flash backward and 4 SpMM launches (each gathered backward
   sends the score's and the features' per-edge gradients to their
   sources by `spmm_csr` on the edge-scatter plan, ROADMAP C39).
8. Serve GATv2 (GATV2Model: 8 heads x 8 concatenated, ELU, 1 head x 40;
   bf16 compute through the process default) through an `InferenceSession`
   on its default device, the card: 8 requests against the plain COO
   path; exactly 2 expand and 2 flash forward launches a request. Then
   trace 3 more with torch.profiler: device time by kernel, device busy
   time and idle share (chrome traces under gammagl_tpu_torch/_build/).
9. Train that GATv2 for 5 full-batch steps (dropout 0.6, Adam lr 0.01 with
   decayed weights 5e-4) with the gatv2 twin's step, against the plain COO
   path under one generator state; per step exactly 2 expand, 2 flash
   forward, 2 flash backward, 2 per-edge segment sums and 2 SpMM launches;
   step-0 gradients held in float32 compute. Then trace 3 more steps.
10. Drive the `sddmm_csr` entry point at bench.py's shape (F = 256 bf16,
   x_src = x_dst) and `sddmm_csr_mh` on per-edge rows (H = 8, F = 8),
   forward and backward: per call pair 2 SDDMM, 2 SpMM, 1 scaled expand
   and 1 per-edge segment sum launches; then trace 3 more pairs (host ms,
   device busy time).
11. Hold the segment max and min kernels (forward, gathered and per edge,
   and the backward) against their plain versions, bitwise: f32 and bf16,
   F in {7, 40, 128, 256}, with and without weights, ties, empty rows with
   N_src != N_dst, no edges; the hub graph of phase 2 (its rows cut into
   work items): the same forms, widths and weights, the backward with and
   without dw, a star whose first item holds only -inf in a column and
   whose two tied winners of another column lie in two items, each call
   exactly one launch and one of each pass over cut rows (the forward's
   fold; the backward's tie count and count fold), repeats bitwise equal.
   On the slice graph at GraphSAGE's widths (F = 256 and 128 bf16) time
   the gathered forward beside the port's `spmm_csr` on the same rows, the
   per-edge form beside `torch.segment_reduce`, and the backward at both
   widths; on the hub graph the forward beside `spmm_csr`, the backward,
   and the fold alone.
12. Hold the HGT attention kernels (forward and backward) against their
   plain versions: f32 and bf16, (H, D) in {(2, 64), (4, 64), (8, 32)},
   empty rows, no edges, and bench.py:185's relation (200,000 -> 100,000
   nodes, 2,000,000 edges, H = 4, D = 64, bf16), where both are timed;
   print the registers and spill bytes of every instantiation of the HGT
   forward and backward, the flash forward and the segment max kernels;
   there also hold the flash kernels
   at HGT's train shape (the decomposed route's per-edge rows, keep in CSR
   order, (H, F) = (4, 64)) and time them.
13. Serve GraphSAGE (GraphSAGEModel, pool aggregator, 128 -> 256 -> 256 ->
   40, bf16) through `InferenceSession` with the slice graph's plan: 8
   requests against the plain COO path; exactly 3 segment-max launches a
   request and nothing else.
14. Train that GraphSAGE for 5 steps (dropout 0.5, Adam lr 0.003) against
   the plain COO path under one generator state; per step exactly 3
   segment-max, 3 segment-max backward and 3 SpMM launches; step-0
   gradients held in float32 compute.
15. Serve HGT (HGTModel, 4 heads, hidden 256, 2 layers, 349 classes, bf16)
   on a typed graph (100,000 papers, 200,000 authors, bench.py:185's
   2,000,000 writes, their reverse, 1,000,000 citations) through the hgt
   twin's eval forward with `HeteroGraph.csr_plans()`: 8 forwards against
   the plain COO route; exactly 6 HGT forward launches each and nothing
   else; then trace 3 more.
16. Train that HGT for 5 steps with the hgt twin's step (attention dropout
   0.2, Adam lr 0.005: the decomposed route) against the COO route under
   one generator state; per step exactly 6 expand, 6 flash forward, 5
   flash backward, 5 segment sum and 5 SpMM launches; step-0 gradients
   held in float32 compute; then trace 3 more steps.
17. Drive `hgt_flash_packed` as bench.py:185 does (the gradient of
   sum(out^2) in kv and q, bf16): per call 1 HGT forward, 1 HGT backward
   and 1 SpMM launch; the gradients held against the plain versions.
18. Build the banded graph (the arxiv shape: dst + U[-128, 128] with ids
   scrambled), order it with `Graph.reorder_rcm()` and fail unless
   `Graph.auto_plan()` gives a `BlockPairPlan` of fill >= 0.8. Hold the
   block-pair forward and dw kernels against their plain versions: f32 and
   bf16, F in {7, 40, 256}, weighted and unweighted, R = S = 8 with ET = 16
   and the 256 defaults, N_src != N_dst with empty destination blocks, no
   edges, a `reorder=True` plan, dx on the transpose plan, and the block
   pairs of the clustered graph's `HybridPlan` (F = 40 and 256), every
   forward, dx and dw repeated bitwise equal; on the banded graph time the
   forward at F = 256 and 40 beside
   its plain version, `torch.sparse.mm` and the port's `spmm_csr` on the
   same graph, and the dw kernel at F = 256.
19. Serve GCN (the phase 5 model) on the banded graph through
   `InferenceSession` with that plan: 8 requests against the plain COO
   path, exactly 3 block-pair launches a request and nothing else; a
   trace of 3 more; then the same 8 requests with the graph's
   `csr_plan()` (3 SpMM launches each), the other side of the choice.
20. Train that GCN for 5 steps with the gcn twin's step (Adam lr 0.01,
   decay 5e-4, dropout 0.5) against the plain COO path under one
   generator state: a forward launches the block-pair kernel 3 times and
   its backward 3 more (dx on the transpose plan), 6 a step; both paths'
   dropout masks equal; step-0 gradients held in float32 compute; a
   trace of 3 more steps.
21. Serve that GCN on the clustered graph (75% of the edges inside runs of
   256 ids, 25% uniform; built before phase 18), where `auto_plan()` must
   give a `HybridPlan`: 8 requests, exactly 3 block-pair and 3 `spmm_csr`
   launches each.
22. Drive `spmm_block_pair` as the JAX package's test does (the gradient
   of sum(out^2) in x and w, bf16, F = 256, the banded graph): per call 1
   forward, 1 dx and 1 dw launch; the gradients held against the plain
   version's.
23. Hold the accumulating CSR SpMM (`spmm_csr_acc`, out = prev + A x)
   against its plain version: f32 and bf16, F in {7, 40, 128, 256}, prev
   None, a separate tensor and out itself (in place), rows without edges
   (prev bitwise), N_src != N_dst, E = 0 (out == prev bitwise), a row-slice
   x, repeats bitwise equal; the hub graph at F in {7, 40, 128, 256},
   prev separate and in place (one launch and one fold a call, rows
   without edges prev bitwise).
24. Build the papers twin's synthetic shard at 1% of papers100M
   (1,110,599 nodes, 16,156,858 edges plus self-loops, 128 features, 172
   classes) and its planned halo partition of one part with
   `auto_src_blocks` source blocks (fail unless there are at least 2, with
   as many interior plans); print the host seconds. Hold the tier's
   forward and transpose against the port's single-plan `spmm_csr` on the
   same graph (bf16, F = 256, 3e-2 of max |out|), with the exact launches
   the block counts give (a fold for each plan with cut rows); time both
   directions beside one plan's, the one-plan transpose beside
   `torch.sparse.mm` and with its rows cut at other K, the fold alone on
   it; time `spmm_csr_acc` on forward interior block 1 and on the
   transpose interior block that holds the hub at F = 256 and 128 beside
   its plain version, its bound and `torch.addmm`.
25. Train scripts/papers100m_single_chip.py's GCN (128 -> 256 -> 256 ->
   172, bf16, AdamW lr 0.01) on that shard for 5 steps with the twin's
   staged step, against the plain path (the port's COO `spmm` over the
   whole graph, autograd, the same parameters and AdamW): float32 step-0
   gradients, the 5 losses, the fall of the loss, eval logits at init, and
   per step exactly 5 `spmm_csr` and 5 x (blocks - 1) `spmm_csr_acc`
   launches and a fold for each of those plans with cut rows; then a trace
   of 3 more steps.
26. Flatten the typed graph of phases 15-16 into one node set as the
   simplehgn twin does (300,000 nodes, papers first; 5,000,000 edges in 3
   edge types); hold `spmm_csr` at SimpleHGN's shape (F = 64 f32, one
   head's weights) and `segment_sum_csr` at RGCN's (C = 64 f32 per-edge
   rows, and at RGCN's class width C = 349 f32) there against their plain
   versions and time them beside cuSPARSE's SpMM and
   `torch.segment_reduce`; hold the expand at C = 349 f32 (the backward of
   RGCN's layer-2 segment sum: rows of 1396 bytes, no multiple of 16)
   bitwise against its plain version and time it beside
   `torch.repeat_interleave` and `index_select`. Serve RGCN (RGCNModel,
   128 -> 64 -> 349, a full map a relation, float32) through the eval
   forward with the graph's `CSRPlan`: 8 requests against the plain COO
   path, exactly 2 `segment_sum_csr` launches each and nothing else; a
   trace of 3 more; float32 step-0 gradients; 5 steps (Adam lr 0.01)
   against the plain path, per step exactly 2 segment sums and 2 expands
   (their VJP); a trace of 3 more steps.
27. HAN (HANModel: 8 heads x 8, attention dropout 0.6, 40 classes, bf16):
   first HANConv on the small movie/director graph with every relation's
   plan on the card (two relations between node types, ROADMAP C14)
   against its plain route, one flash forward a relation; then two
   metapath relations over the arxiv-shape node set (2,315,598 edges
   each): 8 requests against the plain COO path, exactly 2 flash forward
   launches each; a trace; float32 step-0 gradients; 5 steps (Adam lr
   0.005) against the plain path under one generator state, per step
   exactly 2 flash forward, 2 flash backward and 4 SpMM launches; a trace.
28. SimpleHGN (SimpleHGNModel: 8 heads x 64, edge embeddings of 32, 2
   layers, beta 0.05, residual, attention dropout 0.5, float32) on the
   flattened typed graph: 8 requests against the plain COO path, exactly
   16 `spmm_csr`, 6 expand, 2 segment max and 2 segment sum launches each
   (per layer: the destination scores' expand, the CSR-order softmax's
   segment max, 2 expands and segment sum, one SpMM a head); a trace;
   float32 step-0 gradients; 5 steps (Adam lr 0.005) against the plain
   path under one generator state, per step exactly 34 SpMM, 16 SDDMM
   (dalpha), 8 expand, 6 segment sum and 2 segment max launches; a trace.
29. The data core's paths, on files written from the seed in a temporary
   directory (GGL_TPU_OFFLINE=1, nothing fetched): (a) Planetoid's eight
   raw files at pubmed's shape (19,717 nodes, 500 features, 3 classes,
   the 60 / 500 / 1,000 split, 44,324 undirected edges) through
   `load_node_dataset`, `Planetoid` and the gcn twin's `main` (hidden 16,
   dropout 0.5, lr 0.01, decay 5e-4) for 5 epochs on the card, the loaded
   arrays equal to the written ones, exactly 6 `spmm_csr` launches an
   epoch, the losses against the plain COO path of the same loop, and a
   second construction that reads only the processed cache; (b) phase
   24's shard staged in OGB's npy layout, `load_ogb_root` giving it back
   bitwise, the papers twin with `--data-root` (no warning about
   read-only memory; step-0 loss and gradients bitwise those of the twin
   on the arrays handed in; 2 staged steps with phase 25's launches a
   step and a validation forward after the first and last); (c) a TU set
   at ENZYMES' statistics (600 graphs) through `TUDataset`, a
   `BatchGraph` of 128 graphs through 3 GCNConvs of width 64 (float32)
   on its `csr_plan()`, exactly 3 `spmm_csr` launches, each graph's rows
   against that graph alone and `to_data_list` round-tripping, then
   `pad_graph(..., bucket=True)` through the COO route on the card, its
   real rows against the unpadded result; (d) IMDB's processed files at
   its published statistics (4,278 movies, 2,081 directors, 5,257
   actors, 3,066 features, 4,278 movie-director and 12,828 movie-actor
   edges each way, 3 genres) through `IMDB`, every array as written,
   and the han twin on them for 2 steps on the card (its plans: actor ->
   movie has more source rows than destinations, ROADMAP C14): step-0
   loss and gradients bitwise those of the same `HeteroGraph` handed in
   (in PyTorch's deterministic mode: the cross-type relations' clipped
   destination rows go back through an indexed gather, whose backward
   adds atomically), exactly 20 flash forward, 4 flash backward and 8
   `spmm_csr` launches, the plan route within 3e-2 of max |logit| of the
   COO route in bf16. The host seconds of each load are printed with the
   card's name and power limit.
30. The propagation zoo on the arxiv-shape graph of phases 5-9 (labels
   planted in its smoothed features, class directions added to the
   features, float32), each model at its JAX defaults: SGC (K 2), APPNP
   (64, K 10, alpha 0.1), GCNII (64 layers of 64, alpha 0.1, lambda
   0.5), JKNet (4 x 16, max), ChebNet (32, K 3), MixHop (60, powers
   0-2), GPR-GNN (64, K 10), FAGCN (16, 2 layers) and the agnn twin's
   network with the plan handed to its convs, with the twins' Adam lr
   and decay: 8 requests each against the plain COO path (logits within
   1e-4 of max |logit|), exactly 2 / 10 / 64 / 4 / 4 / 2 / 10 / 2 / 2
   `spmm_csr` launches a request; float32 step-0 gradients against the
   plain path (1e-4 of each parameter's max |grad|); 5 Adam steps against
   the plain path under one generator state, exactly 4 / 20 / 128 / 8 /
   6 / 2 / 20 / 4 / 4 `spmm_csr` launches a step, 2 `sddmm_csr` for
   FAGCN and AGNN (their weights' gradient), no fold; a trace of GCNII's
   step.
31. GINModel (5 layers of 64, sum readout, float32, COO as in JAX) on a
   TU set at ENZYMES' statistics in `BatchGraph`s of 128: logits within
   1e-5 of max |logit| of the same module in float64 on the card, each
   graph's row against that graph alone, every global pool and
   `global_sort_pool` (k 35) against float64; no kernel launched.
32. The rest of hetero, COO as in JAX, each against the same module in
   float64 on the card (1e-5 of max |out|; ieHGCN 1e-4: its softmax
   over scores of |s| ~ 80-340 scales float32 rounding), 4 requests and
   3 Adam steps whose loss must fall, no kernel launched: HPN and
   RoheHAN (8 heads) at the twins' width 16 on phase 27's two metapath
   relations, ieHGCN (16) on phase 15's typed graph, HiD-Net (10 layers
   of 64) on the arxiv-shape graph, HeCo at ACM's shape in the HeCo
   paper (4,019 papers, 7,167 authors, 60 subjects, 1,902 features; PAP
   and PSP).
33. The wave-2 zoo, COO as in JAX, each against the same module in
   float64 on the card (1e-5 of max |out|), 8 requests and 5 Adam steps
   whose loss must fall, no kernel launched: PNA (64, the 13 x 128
   concatenation; lr 1e-3), GaAN (4 heads x 16) and the film, gmm, dna
   and hcha twins' nets (16) on the arxiv-shape graph (phase 30's planted
   labels, features at a tenth), CompGCN (64) on phase 26's flattened
   typed graph with its 3 relations as edge types, DGCNN (32, k 30) on a
   TU batch of 128 graphs.
34. The sampled path, from files, on a graph of Reddit's published
   statistics (232,965 nodes, 114,615,892 directed edges written, 602
   features, 41 classes, split 153,431 / 23,831 / 55,703), its raw layout
   written from the seed and read by `Reddit` (every array as written;
   host seconds of each step printed): (b) the serving twin (batches of
   128, fanouts 10 and 5, hidden 64, bf16 inputs, every row in the
   feature cache) serves 50 requests, each within 3e-2 of max |logit| of
   the float32 forward of its blocks on the CPU, then 48 single-node
   requests from 8 threads through `MicroBatcher`, every future finite
   logits of shape (41,); (c) the sage_sample twin from the staged files
   (batches of 512, fanouts 25 and 10, hidden 64, dropout 0.5, Adam 3e-3,
   4 batches a sampler call) trains 20 steps, its loss falling by 5%, and
   scores the test set; float32 step-0 gradients within 1e-4 of each
   parameter's max |grad| of the CPU on the same blocks; an `EpochCache`
   replay of 20 batches bitwise the cached ones; the sampler's ms a batch;
   (d) the gpu_sage twin 10 steps with half the rows cached (hits and
   misses as counted on the host, every gathered row bitwise x[n_id]) and
   `PrefetchLoader` batches bitwise the same batches moved at once. No
   kernel launches (the sampled blocks take no plan, as in JAX).
35. The rest of the datasets and the self-supervised family, COO as in
   JAX (no kernel launches; ``GGL_TPU_OFFLINE=1``, files in a temporary
   directory): (a) WikiCS (11,701 nodes, 300 features, 216,123 edges, 10
   classes) and Flickr (89,250 nodes, 500 features, 899,756 edges, 7
   classes) written from the seed in their raw layouts, read by their
   classes at those shapes and moved to the card; the other twelve
   classes at fixture size (ModelNet40 only where h5py is installed);
   (b) DGI and GGD at 512 on the arxiv shape, DGI on Flickr's; (c) at
   the trainers' widths on a graph of Cora's statistics (2,708 nodes,
   10,556 edges, 81% inside a class, 1,433 features, 7 classes): MVGRL
   128, GRACE 128, VGAE 32 / 16, Specformer 32 (two filters, a full
   `eigh` on the host), MGNNI 32 (scales 1, 2; 8 iterations); (d)
   InfoGraph 32 x 2 on phase 31's TU batch. Each model: the loss of one
   set of CPU-made draws on the card against the CPU (rtol 1e-4), 5 Adam
   steps with card draws (3 on Flickr) after which that loss must have
   fallen, eval requests held against the CPU at 1e-4 of max |out|; DGI
   and GGD at 512 traced (the COO gather's backward's share printed);
   then each twin's loop end to end on the card (5 epochs, its probe or
   score) from the Cora-shape arrays.
36. The wave 5-8 models at their twins' defaults against their
   copies on the CPU, and their twins' loops on the card (COO).
37. The rest of wave 3, Graphormer and RGT against the CPU, and their
   twins (its FusedGATConv path runs `FusedGATModel` in phase 39 (b)).
38. (a) ROADMAP C39: phase 7's GAT step run twice from one state (the
   same parameters, keep masks, labels and generator state): the loss
   and every step-0 gradient bitwise equal, exactly 2 flash forward, 2
   flash backward and 4 `spmm_csr` launches a step (the gathered
   backward sends the score's and the features' gradients to their
   sources by `spmm_csr`), then 5 timed steps and a trace; (b)
   `gammagl_tpu_torch.utils.profiling` on the main path: `chain_time` of
   `spmm_csr` at F = 40 bf16 (K = 8) beside its CUDA-event time, `trace`
   around one step of phase 20's GCN on the CSR plan (its kernel events
   must name `spmm_csr` as often as the wrappers count: 6), and
   `device_timer` around another; (c) DeepWalk, Node2Vec, MetaPath2Vec,
   GraphGAN, GLNN, SEAL, CoGSL and DeFoG at their twins' defaults (a
   graph of Cora's statistics; MetaPath2Vec on the synthetic typed
   graph) against their copies on the CPU (`pair_check`), COO: no kernel.
39. (a) Phase 5's GCN through `serve.export_forward` on its CSR plan (the
   graph must call `gammagl.spmm_csr` once a layer), `save_exported`, and
   `load_exported` in a fresh process that imports only
   `gammagl_tpu_torch.serve` (and neither JAX nor the models): 8 requests
   there, each exactly 3 `spmm_csr` launches and logits bitwise the live
   `InferenceSession`'s (sha256 of the bytes); the artifact's bytes, the
   load time, both request medians (host clock) and both on CUDA events;
   the live request through the op and through the direct launch, in
   turns (op, direct, direct, op), bitwise equal; (b) `FusedGATModel`
   (phases 6-7's shape and parameters, bf16): it raises without its plan,
   8 requests (2 flash forward each) bitwise GATModel's on the plan and
   within 3e-2 of the plain COO path, phase 7's 5 steps (2 flash
   forward, 2 flash backward, 4 `spmm_csr` each) against GATModel on COO
   without attention dropout, traces; (c) the graph-LLM twins at their
   defaults (graphgpt stages 1 and 2, llaga nd and ho; the llmrec,
   nlgraph and walklm splices) on the card and on the CPU from one
   host-drawn init: every step's loss at rtol 1e-4, the forwards at 1e-4
   of max |out|, the losses falling by 5%, each step's time; (d) the 18
   thin models of `models/compat.py` and its ELBO loss at Cora's shape,
   card vs CPU at 1e-4 of max |out|; (c)-(d) COO: no kernel.
40. (a) The planned two-level halo tier (`build_hier_halo_partition_
   planned`) on phase 24's papers shard over a (2, 2) slice x dp grid of
   4 processes on the one card (`chip_smoke.py --hier-worker DIR RANK`,
   gloo, a file store; each process loads its share of the partition
   built here): forward and transpose, bf16 F = 256, each row within
   3e-2 of its max |out| under phase 24's single `spmm_csr` plan, and in
   f32 within 1e-3 of it under the plain version; each rank's launches
   exact (1 `spmm_csr` and one `spmm_csr_acc` a class with edges, a fold
   a plan with cut rows); both directions timed (the slowest rank's wall
   clock) beside phase 24's one-part tier; 2 of phase 25's staged GCN
   steps on it, launches exact, the loss the same on every rank and its
   first within 5e-3 of phase 25's; the partitioned GAT layer at 4 parts
   on a random graph, forward and backward twice, bitwise equal on every
   rank, within 1e-4 of max |ref| of the layer at one part. (b) `make_partitioned_gat_train` at one
   part on the arxiv shape with phases 6-7's widths (bf16, phase 30's
   planted labels): step-0 gradients within 3e-2 of each parameter's max
   |grad| of the same recipe on the CPU, two `loss_and_grads` from one
   state bitwise equal, 20 AdamW steps (4 flash forward with remat, 2
   flash backward, 4 `spmm_csr` each, exact) with the loss falling 5%, 3
   eval forwards (2 flash forward each). Then `parallel.scaling`'s card
   figures: a 1 GiB copy's rate and phase 24's tier forward in edges a
   second.
41. (a) `parallel.make_sharded_spmm` at one part on the arxiv shape's
   `partition_edges_uniform` (GCN weights, F = 128 f32), forward and dx,
   bitwise equal to `spmm_csr` on the graph's plan, timed beside it;
   `make_relation_expert_spmm` at one part on phase 26's flattened typed
   graph at RGCN's widths (128 -> 64 -> 349 f32, 3 relations), each layer
   forward and backward against the per-edge COO plain version within
   1e-5 of max |out| and of each max |grad|, timed beside it; the
   hetero_rgcn twin's `--ep 1` for 5 steps (4 `spmm_csr` a step, 2 an
   accuracy forward). (b) 4 processes on the one card
   (`chip_smoke.py --parallel-worker DIR RANK`, gloo): the sharded SpMM
   by destination (bitwise one plan) and uniform (1e-5), forward and dx;
   the feature-sharded SpMM on a quarter of the columns; the expert SpMM
   with 7 random relations on the arxiv shape (a padding block on rank
   3); the pipeline at 4 stages against the sequential composition;
   `ShardedInferenceSession` on phase 5's GCN (the graph padded to a
   multiple of 4 rows) bitwise `InferenceSession`'s logits, 3 `spmm_csr`
   a request; `ShardedFeatureStore` gathers bitwise (clipped ids among
   them); a `MultiHostNodeLoader` epoch, the seeds disjoint across
   ranks; the hetero_rgcn twin's `--ep 4` for 5 steps with a sharded
   checkpoint after step 3 and a resume repeating steps 4-5 bitwise, its
   losses within 1e-4 of (a)'s; every launch count exact.
42. Every kernel of rows 5-15 as a `torch.library` op. (a) GAT,
   FusedGATModel, GATv2, GraphSAGE with aggr="max", HAN, HGT, SimpleHGN
   and GCN on the block-pair and the hybrid plan, each at its earlier
   phase's widths on the same graph, served live (`InferenceSession`,
   the launches a request exact), exported on the card with
   `serve.export_forward` and saved; one fresh process that imports only
   `gammagl_tpu_torch.serve` loads every artifact and runs the same
   requests: logits bitwise the live session's, the launches a request
   the live path's; its load time split into the imports,
   `torch.export.load`, `.module()`, `load_exported`, the inputs' copy
   and the first call. (b) `torch.library.opcheck` of each op at one
   small hub-row case on the card. (c) The GAT request and step, the
   GraphSAGE-max step and the HGT step through the ops and through their
   CUDA implementations called directly, in turns, 20 calls each on
   CUDA events; one `spmm_max_csr` call's host cost on a 64-node graph
   through both routes (2,000 calls each, host clock).
43. Print the card's name and power limit, one JSON line on the kernels
   (time, plain time, one PyTorch library call's time where one computes
   the same function, the bound and launches by path; the passes over cut
   rows under their kernel's entry: the CSR fold under spmm_csr's, the
   segment max's fold under spmm_max_csr's, its tie count and count fold
   under segment_max_bwd's, the flash forward's fold under
   flash_forward's; the typed-graph shapes of phase 26 under
   `by_shape`) and the paths (the wave-2 zoo under "wave2", phase 34
   under "sampled", phase 35 under "ssl"), and as the last line
   {"ok": true, "device": {...}}.

It needs a CUDA card and the repository beside it; it imports no JAX.
"""

import contextlib
import copy
import hashlib
import inspect
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

N_NODES, N_EDGES, N_FEAT = 169_343, 2_315_598, 128
HIDDEN, N_CLASS, N_LAYERS = 256, 40, 3
GAT_HIDDEN, GAT_HEADS, GAT_DROP, GAT_LR = 8, 8, 0.6, 0.005
GATV2_LR, GATV2_L2 = 0.01, 5e-4  # the gatv2 trainer's Adam and decay
SDDMM_F, N_SDDMM_CALLS = 256, 3
# GraphSAGE: the OGB ogbn-arxiv GraphSAGE baseline's widths with Hamilton
# et al. 2017's pooling aggregator; Adam lr of the repo's GraphSAGE trainer
SAGE_AGGR, SAGE_DROP, SAGE_LR = "pool", 0.5, 0.003
# HGT: bench.py:185's relation (200,000 authors -> 100,000 papers,
# 2,000,000 edges, H = 4, D = 64), its reverse, 1,000,000 citations;
# ogbn-mag's 349 venues; Hu et al. 2020's hidden width 256; the hgt
# trainer's Adam lr; attention dropout 0.2 inside HGTConv
HGT_PAPERS, HGT_AUTHORS, HGT_FEAT, HGT_CLASSES = 100_000, 200_000, 128, 349
HGT_WRITES, HGT_CITES = 2_000_000, 1_000_000
HGT_HIDDEN, HGT_HEADS, HGT_LAYERS, HGT_LR = 256, 4, 2, 0.005
N_HGT_CALLS = 3
# the block-pair slice: the arxiv-shape graph with banded edges (dst + U[-128,
# 128], clipped; ids scrambled, then recovered by reorder_rcm) and with
# clustered edges (75% inside 256 consecutive ids, 25% uniform); the gcn
# twin's Adam lr and decay, GCNModel's dropout
BAND, CLUSTER, CLUSTER_SHARE = 128, 256, 0.75
GCN_LR, GCN_L2, GCN_DROP = 0.01, 5e-4, 0.5
N_BP_CALLS = 3
# the papers100M slice: scripts/papers100m_single_chip.py's GCN (hidden
# 256, 3 layers, 172 classes, AdamW lr 0.01, no decay) on the papers
# twin's synthetic shard at 1% of papers100M, one part
PAPERS_SCALE, PAPERS_LAYERS, PAPERS_LR = 0.01, 3, 1e-2
# phase 40 (a): the planned two-level tier on that shard over a HIER_GRID
# (slices x dp) grid of processes, all on the one card (gloo moves the
# CUDA tensors of the collectives through host memory), and HIER_STEPS of
# phase 25's staged GCN steps on it; (b) the partitioned GAT at one part
# on the arxiv shape with phases 6-7's widths (bf16, AdamW at phase 7's
# lr, no dropout) on phase 30's planted labels: PGAT_STEPS steps (5 fell
# by 2% in a CPU rehearsal at 20,000 nodes, 20 by 10%) and PGAT_REQUESTS
# eval forwards
HIER_GRID, HIER_STEPS = (2, 2), 2
# (a) also holds the tier per row: each row's max error within a share of
# that row's own max |ref| (bf16 against one `spmm_csr` plan at 3e-2; an
# f32 run against the plain version at 1e-3, since a hub row's f32 sum of
# 1.4M edges moves with the order by ~5e-5 of its spread; a floor of 1e-7
# of the global max), so that ordinary rows fail, not only the hubs that
# set the global max; and runs the partitioned GAT layer on a random
# graph of HIER_GAT_SHAPE (nodes, edges, heads, width a head; f32) over
# the grid's processes twice from one input, bitwise equal, against the
# layer at one part at 1e-4 of max |ref|
HIER_ROW_TOL = {"bf16": 3e-2, "f32": 1e-3}
HIER_ROW_FLOOR = 1e-7
HIER_GAT_SHAPE = (20_000, 320_000, 8, 8)
PGAT_STEPS, PGAT_REQUESTS = 20, 3
# the typed-edge paths, on the typed graph of phases 15-16 flattened to
# one node set (papers first, each relation an edge type) as the simplehgn
# twin flattens: RGCN at OGB's ogbn-mag R-GCN baseline width (hidden 64)
# with a full map a relation (no bases), the rgcn trainer's Adam lr; HGB's
# Simple-HGN (Lv et al. 2021: 8 heads x 64, edge embeddings of 32, 2
# layers, beta 0.05, residual) with SimpleHGNModel's attention dropout
# 0.5, the simplehgn trainer's Adam lr
RGCN_HIDDEN, RGCN_LR = 64, 0.01
SHGN_HEADS, SHGN_HIDDEN, SHGN_DROP, SHGN_LR = 8, 64, 0.5, 0.005
# HAN: Wang et al. 2019's 8 heads x 8 and attention dropout 0.6 (HANModel's
# defaults) on two metapath relations over the arxiv-shape node set, each
# bench.py's generator with its own seed; 40 classes, the han trainer's
# Adam lr
HAN_RELATIONS, HAN_HEADS, HAN_HIDDEN = ("pap", "psp"), 8, 8
HAN_DROP, HAN_LR = 0.6, 0.005
N_REQUESTS, N_STEPS = 8, 5
SEED = 0
# K of the work items, measured on the papers transpose beside ROW_SPLIT
SPLIT_SWEEP = (512, 1024, 4096, 8192)
# step-0 gradients, each parameter: max |kernel - plain| <= GRAD_TOL *
# max |plain|; losses: |kernel - plain| <= LOSS_TOL * |plain|. Both paths
# compute in bf16 and round at different points (the plain path rounds
# alpha and the messages to bf16 per edge, the kernels sum in f32).
GRAD_TOL, LOSS_TOL = 3e-2, 5e-3
# the kernel path's loss must fall by this share over the N_STEPS steps:
# far past LOSS_TOL, so a path that did not train cannot read as the plain
MIN_FALL = 10 * LOSS_TOL
# float32 step-0 gradients of each parameter (GATv2): the paths sum in
# other orders, nothing else differs
F32_GRAD_TOL = 1e-4
# float32 step-0 gradients of the papers GCN's layers behind a ReLU: a
# ReLU input within f32 rounding of 0 takes opposite signs on the two
# paths' sum orders and moves the gradient by its row's share (the plain
# versions alone on the CPU: w0 2.5e-5 of max |grad| at 222,111 nodes,
# 1.1e-3 at 22,211; the last layer's within 2.1e-7 at both)
F32_RELU_GRAD_TOL = 1e-3
# the bound of a kernel: the larger of its bytes (each input read once,
# each output written once) over HBM's rate and its arithmetic over the
# f32 rate outside the tensor cores (every kernel here sums in f32 on
# the CUDA cores); the published H100 SXM peaks at 700 W
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12
SPMM_SOURCE = "gammagl_tpu_torch/csrc/spmm_csr.cu"
FLASH_SOURCE = "gammagl_tpu_torch/csrc/flash_attention.cu"
EDGE_SOURCE = "gammagl_tpu_torch/csrc/sddmm_csr.cu"
MAX_SOURCE = "gammagl_tpu_torch/csrc/segment_max.cu"
HGT_SOURCE = "gammagl_tpu_torch/csrc/hetero_flash.cu"
BP_SOURCE = "gammagl_tpu_torch/csrc/block_pair.cu"
PALLAS = "gammagl_tpu/ops/pallas/"
# name -> (source, the TPU kernel it replaces, other TPU kernels it covers)
KERNELS = {
    "spmm_csr": (SPMM_SOURCE, PALLAS + "segment_matmul.py:243",
                 [PALLAS + "segment_matmul.py:774",
                  PALLAS + "segment_matmul.py:686"]),
    "segment_sum_csr": (SPMM_SOURCE, PALLAS + "segment_matmul.py:849", []),
    "flash_forward": (FLASH_SOURCE, PALLAS + "flash_attention.py:566", []),
    "flash_backward": (FLASH_SOURCE, PALLAS + "flash_attention.py:704", []),
    "expand_dst_csr": (EDGE_SOURCE, PALLAS + "sddmm_csr.py:386",
                       [PALLAS + "sddmm_csr.py:134"]),
    "sddmm_csr": (EDGE_SOURCE, PALLAS + "sddmm_csr.py:222",
                  [PALLAS + "sddmm_csr.py:92"]),
    "spmm_max_csr": (MAX_SOURCE, PALLAS + "segment_max.py:85", []),
    "segment_max_bwd": (MAX_SOURCE, PALLAS + "segment_max.py:195", []),
    "hgt_forward": (HGT_SOURCE, PALLAS + "hetero_flash.py:206", []),
    "hgt_backward": (HGT_SOURCE, PALLAS + "hetero_flash.py:257", []),
    "spmm_block_pair": (BP_SOURCE, PALLAS + "block_pair.py:198", []),
    "block_pair_dw": (BP_SOURCE, PALLAS + "block_pair.py:264", []),
    "spmm_csr_acc": (SPMM_SOURCE, PALLAS + "segment_matmul.py:897", []),
}
# the kernels whose launches each path counts: every kernel of the kernels
# line, and the passes over cut rows, none a TPU kernel of its own: the
# fold under spmm_csr's entry (the second pass of the CSR kernel's three
# forms), the segment max's fold under spmm_max_csr's, its backward's tie
# count and count fold under segment_max_bwd's, and the flash forward's
# fold under flash_forward's
COUNTED = (*KERNELS, "csr_fold", "segment_max_fold", "segment_max_count",
           "segment_max_count_fold", "flash_fwd_fold")
# the passes over cut rows: kernel entry -> {key in its entry: counter}
CUT_PASSES = {"spmm_csr": {"fold": "csr_fold"},
              "spmm_max_csr": {"fold": "segment_max_fold"},
              "segment_max_bwd": {"count": "segment_max_count",
                                  "fold": "segment_max_count_fold"},
              "flash_forward": {"fold": "flash_fwd_fold"}}
NOTES = {"block_pair_dw": "the JAX VJP _bwd (block_pair.py:264) is XLA, not "
                          "a Pallas kernel: it gathers both endpoint rows"}


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


_PHASES = []  # (title, host clock at its start)


def phase_start(title):
    """Print a phase's title and note when it began (a breakdown of the
    run's time is printed at its end)."""
    _PHASES.append((title.split(":")[0], time.perf_counter()))
    print(title)


def check_close(label, got, want, rtol, atol=1e-5, scale=None):
    """|got - want| <= rtol*|want| + atol*scale, elementwise, with scale
    max|want| unless given. The second term covers the different f32
    summation orders. Returns the max abs error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite values")
    err = (got - want).abs()
    if scale is None:
        scale = float(want.abs().max()) if want.numel() else 0.0
    bound = rtol * want.abs() + atol * scale
    max_err = float(err.max()) if err.numel() else 0.0
    worst = float((err / bound.clamp_min(1e-30)).max()) if err.numel() else 0.
    print(f"  {label}: max_abs_err {max_err:.3e}, worst err/tol {worst:.3f} "
          f"(rtol {rtol:g} + {atol:g}*max|ref|, max|ref| {scale:.3e})")
    if not bool((err <= bound).all()):
        fail(f"{label}: kernel disagrees with the plain version")
    return max_err


def check_rows(label, got, want, rtol, floor=HIER_ROW_FLOOR):
    """Row by row: max |got - want| of each row <= rtol * that row's max
    |want| + floor * the global max |want|. Returns the max abs error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite values")
    err = (got - want).abs().amax(1)
    row = want.abs().amax(1)
    bound = rtol * row + floor * float(row.max())
    worst = float((err / bound.clamp_min(1e-30)).max())
    print(f"  {label}: max_abs_err {float(err.max()):.3e}, worst row "
          f"err/tol {worst:.3f} (rtol {rtol:g} of the row's max |ref| + "
          f"{floor:g}*max|ref|, max|ref| {float(row.max()):.3e}, median row "
          f"max {float(row.median()):.3e})")
    if not bool((err <= bound).all()):
        fail(f"{label}: {int((err > bound).sum())} rows disagree with the "
             "reference")
    return float(err.max())


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms over `iters` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def paired_ms(kernel, plain, plain_iters=5):
    """plain, kernel, kernel, plain; returns the mean of each pair and the
    four runs."""
    p0 = cuda_ms(plain, iters=plain_iters)
    k0, k1 = cuda_ms(kernel), cuda_ms(kernel)
    p1 = cuda_ms(plain, iters=plain_iters)
    return (k0 + k1) / 2, (p0 + p1) / 2, (p0, k0, k1, p1)


def bound(nbytes, flops):
    """The least time the card could take (ms), and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "flops": int(flops)}


def library_ms(label, fn):
    """Time of one PyTorch library call computing the same function (a
    yardstick the port never calls), or None where it refuses these
    inputs."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        print(f"  {label}: no library time ({type(e).__name__}: "
              f"{str(e).splitlines()[0][:120]})")
        return None
    return cuda_ms(fn)


def timing(label, kernel, plain, nbytes, flops, library=None,
           plain_iters=5):
    """Kernel and plain times (plain, kernel, kernel, plain), the library
    call's time and the bound; prints one line and returns a dict."""
    k_ms, p_ms, runs = paired_ms(kernel, plain, plain_iters)
    lib = library_ms(label, library) if library is not None else None
    row = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib,
           **bound(nbytes, flops)}
    row["share_of_bound"] = row["bound_ms"] / k_ms
    lib_txt = "none" if lib is None else f"{lib:.4f} ms"
    print(f"  {label}: kernel {k_ms:.4f} ms ({runs[1]:.4f}, {runs[2]:.4f}), "
          f"plain {p_ms:.4f} ms ({runs[0]:.4f}, {runs[3]:.4f}), library "
          f"{lib_txt}; bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP), "
          f"{row['share_of_bound']:.3f} of it")
    return row


# chrome traces of the phases (gitignored)
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "gammagl_tpu_torch", "_build", "traces")


def profile(label, fn, n=3):
    """Trace n calls of fn with torch.profiler; print the device time by
    kernel (chrome trace events of category kernel, memcpy and memset),
    the device busy time and the idle share of the host-clock span, all
    per call."""
    from gammagl_tpu_torch.utils.profiling import trace
    fn()
    sync()
    with trace(TRACE_DIR) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        span_us = (time.perf_counter() - t0) * 1e6 / n
    path = os.path.join(TRACE_DIR, f"trace_{label}.json")
    os.replace(prof.trace_path, path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev["dur"]
    busy = sum(by_name.values()) / n
    print(f"  profile {label}: device busy {busy:.1f} us a call, span "
          f"{span_us:.1f} us, idle {1 - busy / span_us:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:30]
    for name, dur in top:
        print(f"    {dur / n:9.1f} us {dur / n / busy:6.3f}  {name[:150]}")
    return {"busy_us": busy, "span_us": span_us,
            "by_kernel_us": {name[:150]: dur / n for name, dur in top[:10]}}


def arxiv_edges(rng, n_nodes=N_NODES, n_edges=N_EDGES):
    """bench.py's generator: dst = N * u^1.5, src uniform."""
    dst = (n_nodes * (rng.random(n_edges) ** 1.5)).astype(np.int64)
    src = rng.integers(0, n_nodes, n_edges)
    return np.stack([src, dst])


def arxiv_graph(Graph, n_nodes=N_NODES, n_edges=N_EDGES):
    """bench.py's generator (seed 0) plus self-loops, and 128 features."""
    rng = np.random.default_rng(SEED)
    ei = arxiv_edges(rng, n_nodes, n_edges)
    x = rng.normal(size=(n_nodes, N_FEAT)).astype(np.float32)
    return Graph(x=x, edge_index=ei).add_self_loop()


def random_params():
    """A flax-shaped GCNModel tree from numpy: glorot kernels, small bias."""
    rng = np.random.default_rng(SEED + 1)
    dims = [N_FEAT] + [HIDDEN] * (N_LAYERS - 1) + [N_CLASS]
    tree = {}
    for i in range(N_LAYERS):
        lim = np.sqrt(6.0 / (dims[i] + dims[i + 1]))
        tree[f"GCNConv_{i}"] = {
            "Dense_0": {"kernel": rng.uniform(
                -lim, lim, (dims[i], dims[i + 1])).astype(np.float32)},
            "bias": rng.uniform(-0.1, 0.1, dims[i + 1]).astype(np.float32)}
    return {"params": tree}


def gat_params():
    """A flax-shaped GATModel tree from numpy: glorot-scale ``w``,
    attention vectors large enough that the softmax is not uniform."""
    rng = np.random.default_rng(SEED + 3)
    tree = {}
    for i, (fan_in, H, F, width) in enumerate((
            (N_FEAT, GAT_HEADS, GAT_HIDDEN, GAT_HEADS * GAT_HIDDEN),
            (GAT_HEADS * GAT_HIDDEN, 1, N_CLASS, N_CLASS))):
        std = np.sqrt(2.0 / (fan_in + H * F))
        tree[f"GATConv_{i}"] = {
            "w": (rng.normal(size=(fan_in, H * F)) * std).astype(np.float32),
            "att": (rng.normal(size=(1, H, 2 * F)) * 0.3).astype(np.float32),
            "bias": rng.uniform(-0.1, 0.1, width).astype(np.float32)}
    return {"params": tree}


def gatv2_params():
    """A flax-shaped GATV2Model tree from numpy: glorot kernels, attention
    vectors large enough that the softmax is not uniform."""
    rng = np.random.default_rng(SEED + 7)
    tree = {}
    for i, (fan_in, H, F, width) in enumerate((
            (N_FEAT, GAT_HEADS, GAT_HIDDEN, GAT_HEADS * GAT_HIDDEN),
            (GAT_HEADS * GAT_HIDDEN, 1, N_CLASS, N_CLASS))):
        lim = np.sqrt(6.0 / (fan_in + H * F))
        tree[f"GATV2Conv_{i}"] = {
            **{f"Dense_{j}": {"kernel": rng.uniform(
                -lim, lim, (fan_in, H * F)).astype(np.float32)}
               for j in (0, 1)},
            "att": (rng.normal(size=(1, H, F)) * 0.3).astype(np.float32),
            "bias": rng.uniform(-0.1, 0.1, width).astype(np.float32)}
    return {"params": tree}


def counters(k):
    """Each kernel's wrappers, which count its launches (the segment-max
    forward kernel has four: max and min, gathered and per edge)."""
    return {"spmm_csr": [k.spmm_csr], "segment_sum_csr": [k.segment_sum_csr],
            "flash_forward": [k.flash_forward],
            "flash_backward": [k.flash_backward],
            "expand_dst_csr": [k.expand_dst_csr], "sddmm_csr": [k.sddmm_csr],
            "spmm_max_csr": [k.spmm_max_csr, k.spmm_min_csr,
                             k.segment_max_csr, k.segment_min_csr],
            "segment_max_bwd": [k.segment_max_bwd],
            "hgt_forward": [k.hgt_forward], "hgt_backward": [k.hgt_backward],
            "spmm_block_pair": [k.spmm_block_pair],
            "block_pair_dw": [k.block_pair_dw],
            "spmm_csr_acc": [k.spmm_csr_acc], "csr_fold": [k.csr_fold],
            "segment_max_fold": [k.segment_max_fold],
            "segment_max_count": [k.segment_max_count],
            "segment_max_count_fold": [k.segment_max_count_fold],
            "flash_fwd_fold": [k.flash_fwd_fold]}


def reset_counts(k):
    for fns in counters(k).values():
        for fn in fns:
            fn.launches = 0


def read_counts(k):
    return {name: sum(fn.launches for fn in fns)
            for name, fns in counters(k).items()}


def every_kernel(per_call, n=1):
    """{kernel: launches} over every counted kernel (the fold of cut rows
    too), n calls of per_call."""
    return {name: per_call.get(name, 0) * n for name in COUNTED}


# a graph with hub rows (phases 2, 4 and 23): a star of HUB_EDGES edges
# into row 0 (the papers shard's transpose has a row of 1,401,814), one of
# HUB2_EDGES into row 2, HUB_RANDOM random edges into even rows below
# 2,000 of HUB_ROWS (odd rows and the top third: no edges), HUB_SRC sources
HUB_EDGES, HUB2_EDGES, HUB_RANDOM = 1_200_000, 5_000, 60_000
HUB_ROWS, HUB_SRC = 3_000, 4_500


def exact(gen, *shape, weights=False):
    """Values whose every f32 partial sum over the hub graph is exact:
    integers in [-4, 4], or weights that are multiples of 1/8 in [0, 1]
    (a row's partial sums stay far below 2^21). Any summation order then
    gives the same bits, so a 1.2M-edge row is held bitwise to the plain
    version, whose GPU `index_add_` adds in no fixed order."""
    if weights:
        return torch.randint(0, 9, shape, generator=gen).float() / 8
    return torch.randint(-4, 5, shape, generator=gen).float()


def hub_plan(k, seed, star=HUB_EDGES):
    """The hub graph's plan (``star`` edges into row 0: 0 for the graph
    without its star); prints its work items (`CSRPlan.row_split`)."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(star, np.int64),
                          np.full(HUB2_EDGES, 2, np.int64),
                          2 * rng.integers(0, 1000, HUB_RANDOM)])
    src = rng.integers(0, HUB_SRC, dst.shape[0])
    plan = k.build_csr_plan(src, dst, HUB_ROWS, num_src=HUB_SRC)
    split = plan.row_split()
    print(f"  hub graph: {plan.num_nodes} rows, {plan.num_src} sources, "
          f"{plan.num_edges} edges, largest row "
          f"{int(np.diff(plan.rowptr).max())}; work items (ROW_SPLIT "
          f"{k.ROW_SPLIT}): {split.item_row.shape[0]} items, "
          f"{split.cut_row.shape[0]} cut rows, {int(split.cut_ptr[-1])} "
          "scratch slots")
    if split.cut_row.shape[0] != (2 if star else 1):
        fail("the hub graph's hubs are not all cut")
    return plan


def hub_check(k, label, counter, run, want, rtol, same=None):
    """One kernel call on the hub graph: exactly one launch of ``counter``
    and one fold, the result bitwise equal to the plain version (the
    inputs are `exact`), and a repeat bitwise equal (``same`` checks more
    bits). Returns the max abs error."""
    c0, f0 = counter.launches, k.csr_fold.launches
    got = run()
    sync()
    if (counter.launches - c0, k.csr_fold.launches - f0) != (1, 1):
        fail(f"hub {label}: launches {counter.launches - c0}, folds "
             f"{k.csr_fold.launches - f0} (want 1 and 1)")
    err = check_close(f"hub {label}", got, want, rtol)
    if not torch.equal(got, want):
        fail(f"hub {label}: not bitwise equal to the plain version")
    if not torch.equal(got, run()):
        fail(f"hub {label}: repeated launches differ")
    if same is not None:
        same(got)
    return err


def phase_spmm_checks(k, slice_plan, slice_w):
    phase_start("phase 2: CSR SpMM kernel vs plain version on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    # empty rows (odd rows and the tail get no edges), N_src != N_dst
    n_dst, n_src, e = 1000, 1500, 6000
    dst = 2 * rng.integers(0, 450, e)
    src = rng.integers(0, n_src, e)
    sparse = k.build_csr_plan(src, dst, n_dst, num_src=n_src)
    empty = k.build_csr_plan(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             50, num_src=30)
    cases = []
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for F in (7, 40, 256):
            w = torch.rand(e, generator=g).to(dev)
            x = torch.randn(n_src, F, generator=g).to(dev, dtype)
            cases.append((f"{dtype} F={F} empty rows", x, w, sparse, rtol))
            cases.append((f"{dtype} F={F} empty rows, unit w", x, None,
                          sparse, rtol))
            cases.append((f"{dtype} F={F} E=0",
                          torch.randn(30, F, generator=g).to(dev, dtype),
                          torch.zeros(0, device=dev), empty, rtol))
        flat = torch.randn(n_src * 256 + 1, generator=g).to(dev, dtype)
        cases.append((f"{dtype} F=256 misaligned x",
                      flat[1:].view(n_src, 256), w, sparse, rtol))
    for label, x, w, plan, rtol in cases:
        got = k.spmm_csr(x, w, plan)
        torch.cuda.synchronize()
        check_close(label, got, k.spmm_csr_reference(x, w, plan), rtol)

    # hub rows: cut into work items, their partials folded
    hub = hub_plan(k, SEED + 2)
    main_err = 0.0
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for F in (7, 40, 64, 128, 256):
            x = exact(g, hub.num_src, F).to(dev, dtype)
            w = exact(g, hub.num_edges, weights=True).to(dev)
            main_err = max(main_err, hub_check(
                k, f"spmm_csr {dtype} F={F}", k.spmm_csr,
                lambda: k.spmm_csr(x, w, hub, weights_padded=True),
                k.spmm_csr_reference(x, w, hub, weights_padded=True), rtol))

    timings = {}
    for F in (HIDDEN, N_CLASS):
        x = torch.randn(slice_plan.num_src, F, generator=g).to(
            dev, torch.bfloat16)
        got = k.spmm_csr(x, slice_w, slice_plan, weights_padded=True)
        torch.cuda.synchronize()
        want = k.spmm_csr_reference(x, slice_w, slice_plan,
                                    weights_padded=True)
        err = check_close(f"slice graph bf16 F={F}", got, want, 1e-2)
        main_err = max(main_err, err)
        if slice_plan.row_split().cut_row.shape[0]:
            fail("the slice graph has rows cut into work items")
        N, E = slice_plan.num_nodes, slice_plan.num_edges
        rowptr, col, _ = slice_plan.arrays(dev)
        # cuSPARSE's SpMM over the same CSR and weights
        A = torch.sparse_csr_tensor(rowptr, col.long(), slice_w.to(x.dtype),
                                    size=(N, slice_plan.num_src))
        timings[F] = {"F": F, "max_abs_err": err, **timing(
            f"spmm_csr F={F} bf16",
            lambda: k.spmm_csr(x, slice_w, slice_plan, weights_padded=True),
            lambda: k.spmm_csr_reference(x, slice_w, slice_plan,
                                         weights_padded=True),
            # x, col, rowptr and w in, out
            nbytes=(slice_plan.num_src * F * 2 + E * 4 + (N + 1) * 8 + E * 4
                    + N * F * 2),
            flops=2 * E * F, library=lambda: A @ x)}

    # the backward: dx is the kernel on the transpose plan, dw the SDDMM
    # kernel; the plain dx is the plain SpMM on the same transpose plan
    tp = slice_plan.transpose()
    w_t = slice_w[tp.arrays(dev)[2]]
    rowptr, col, _ = slice_plan.arrays(dev)
    rows = torch.repeat_interleave(
        torch.arange(slice_plan.num_nodes, device=dev), rowptr.diff(),
        output_size=slice_plan.num_edges)
    for F in (HIDDEN, N_CLASS):
        for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            x = torch.randn(slice_plan.num_src, F, generator=g).to(
                dev, dtype).requires_grad_()
            w = slice_w.clone().requires_grad_()
            gy = torch.randn(slice_plan.num_nodes, F, generator=g).to(
                dev, dtype)
            k.spmm_csr(x, w, slice_plan, weights_padded=True).backward(gy)
            torch.cuda.synchronize()
            want_dx = k.spmm_csr_reference(gy, w_t, tp, weights_padded=True)
            want_dw = (x.detach()[col.long()].float()
                       * gy[rows].float()).sum(1)
            main_err = max(main_err, check_close(
                f"backward dx {dtype} F={F}", x.grad, want_dx, rtol))
            check_close(f"backward dw {dtype} F={F}", w.grad, want_dw, 1e-5)
    return main_err, timings


def _flash_inputs(gen, plan, H, F, dtype, gather, keep, dev):
    rows = plan.num_src if gather else plan.num_edges
    s = torch.randn(rows, H, generator=gen).to(dev)
    a = torch.randn(plan.num_nodes, H, generator=gen).to(dev)
    msg = torch.randn(rows, H * F, generator=gen).to(dev, dtype)
    kp = None
    if keep:
        kp = ((torch.rand(plan.num_edges, H, generator=gen) < 1 - GAT_DROP)
              .float() / (1 - GAT_DROP)).to(dev)
    return s, a, msg, kp


def flash_check(k, label, plan, H, F, dtype, gather, keep, gen, dev):
    """Forward and backward kernels against the plain versions, and a
    second run of each bitwise equal to the first; returns the max abs
    error of each: {"flash_forward": over out and l, "flash_backward":
    over ds, dmsg and da}. With ``gather`` keep is in the caller's edge
    order, read through the plan's perm."""
    s, a, msg, kp = _flash_inputs(gen, plan, H, F, dtype, gather, keep, dev)
    out, m, l = k.flash_forward(s, a, msg, kp, plan, 0.2, gather)
    g = torch.randn(out.shape, generator=gen).to(dev, dtype)
    ds, dmsg, da = k.flash_backward(s, a, msg, kp, m, l, out, g, plan, 0.2,
                                    gather)
    torch.cuda.synchronize()
    r_out, r_m, r_l = k.flash_forward_reference(s, a, msg, kp, plan, 0.2,
                                                gather)
    r_ds, r_dmsg, r_da = k.flash_backward_reference(
        s, a, msg, kp, r_m, r_l, out, g, plan, 0.2, gather)
    rt = 1e-2 if dtype == torch.bfloat16 else 1e-5
    if not torch.equal(m, r_m):  # the same f32 scores, the same max
        fail(f"{label} m: row maxima differ")
    err = {"flash_forward": 0.0, "flash_backward": 0.0}
    for kname, name, got, want, rtol in (
            ("flash_forward", "out", out, r_out, rt),
            ("flash_forward", "l", l, r_l, 1e-5),
            ("flash_backward", "ds", ds, r_ds, 1e-5),
            ("flash_backward", "dmsg", dmsg, r_dmsg, rt),
            ("flash_backward", "da", da, r_da, 1e-5)):
        err[kname] = max(err[kname],
                         check_close(f"{label} {name}", got, want, rtol))
    # no atomics, a fixed order (the backward's groups add their partial
    # da in group order): a second run gives the same bits
    again = (*k.flash_forward(s, a, msg, kp, plan, 0.2, gather),
             *k.flash_backward(s, a, msg, kp, m, l, out, g, plan, 0.2,
                               gather))
    if not all(torch.equal(x, y) for x, y in zip((out, m, l, ds, dmsg, da),
                                                 again)):
        fail(f"{label}: repeated launches differ")
    return err


def flash_hub_checks(k, gen, dev):
    """The flash forward on the hub graph, its rows cut into work items, as
    GATConv calls it (node rows, keep in the caller's order, bf16) at
    (8, 8) and (1, 40): one launch and one `flash_fwd_fold` a call, held
    against the plain version, a repeat bitwise equal, timed beside
    `spmm_csr` at F = H*F on the same graph. The star's destination score
    a_dst[0] = 1e8 rounds every star edge's score to 1e8, so its weights
    are 1 and, with integer messages, every partial sum of its 1,200,000
    edges is exact in any order (the plain version's `index_add_` adds in
    none); the other rows take random scores (clamped to [-3, 3]). Then forward and backward on
    the graph without its star (the 5,000-edge row cut into 3 items)
    against the plain versions. Returns ({kernel: max abs error}, the
    forward's timing rows, the fold's timing alone)."""
    from gammagl_tpu_torch.ops.cuda.segment_matmul import _slots
    bf16 = torch.bfloat16
    hub = hub_plan(k, SEED + 4)
    err = {"flash_forward": 0.0, "flash_backward": 0.0}
    rows = []
    N, Ns, E = hub.num_nodes, hub.num_src, hub.num_edges
    for H, F in ((GAT_HEADS, GAT_HIDDEN), (1, N_CLASS)):
        s, a, _, kp = _flash_inputs(gen, hub, H, F, bf16, True, True, dev)
        msg = exact(gen, Ns, H * F).to(dev, bf16)
        s.clamp_(-3, 3)  # s + 1e8 rounds to 1e8 (its ulp is 8)
        a[0] = 1e8
        args = (s, a, msg, kp, hub, 0.2, True)
        before = (k.flash_forward.launches, k.flash_fwd_fold.launches)
        out, m, l = k.flash_forward(*args)
        sync()
        launched = (k.flash_forward.launches - before[0],
                    k.flash_fwd_fold.launches - before[1])
        if launched != (1, 1):
            fail(f"hub flash_forward H={H} F={F}: launches {launched[0]}, "
                 f"folds {launched[1]} (want 1 and 1)")
        r_out, r_m, r_l = k.flash_forward_reference(*args)
        if not torch.equal(m, r_m):
            fail(f"hub flash_forward H={H} F={F} m: row maxima differ")
        for name, got, want, rtol in (("out", out, r_out, 1e-2),
                                      ("l", l, r_l, 1e-5)):
            err["flash_forward"] = max(err["flash_forward"], check_close(
                f"hub flash_forward H={H} F={F} {name}", got, want, rtol))
        if not all(torch.equal(x, y) for x, y in zip(
                (out, m, l), k.flash_forward(*args))):
            fail(f"hub flash_forward H={H} F={F}: repeated launches differ")
        x = torch.randn(Ns, H * F, generator=gen).to(dev, bf16)
        spmm = cuda_ms(lambda: k.spmm_csr(x, None, hub), iters=5)
        # in: node rows and scores, a_dst, keep and its perm row, col and
        # the items' offsets and rows; out: out, m and l
        split = hub.row_split()
        nbytes = (Ns * H * F * 2 + Ns * H * 4 + N * H * 4 + E * H * 4
                  + E * 8 + E * 4 + split.item_ptr.nbytes
                  + 2 * split.item_row.nbytes + N * H * F * 2 + 2 * N * H * 4)
        row = {"H": H, "F": F, "graph": "hub", "spmm_csr_ms": spmm,
               **timing(f"flash_forward hub H={H} F={F}",
                        lambda: k.flash_forward(*args),
                        lambda: k.flash_forward_reference(*args), nbytes,
                        2 * E * H * F + 6 * E * H, plain_iters=3)}
        print(f"  spmm_csr on the hub graph F={H * F} bf16: {spmm:.4f} ms; "
              f"the flash forward {row['ms'] / spmm:.3f}x it")
        rows.append(row)
    # the fold alone, on the hub graph's slots at (8, 8)
    H, F = GAT_HEADS, GAT_HIDDEN
    _, _, cut_row, cut_ptr, n_slots = hub.split_arrays(dev)
    part = _slots(hub, H * F + 2 * H, dev)  # per slot: sums, m and l
    part.copy_(torch.randn(part.shape, generator=gen))
    out = torch.empty(N, H * F, dtype=bf16, device=dev)
    m, l = torch.empty(N, H, device=dev), torch.empty(N, H, device=dev)
    fold = {"ms": cuda_ms(lambda: k.flash_fwd_fold(part, hub, out, m, l)),
            **bound(n_slots * (H * F + 2 * H) * 4
                    + cut_row.shape[0] * (H * F * 2 + 2 * H * 4 + 12),
                    n_slots * (2 * H * F + 4 * H)),
            "cut_rows": int(cut_row.shape[0]), "slots": n_slots}
    print(f"  flash_fwd_fold on the hub graph ({fold['cut_rows']} cut rows, "
          f"{n_slots} slots, H={H} F={F} bf16): {fold['ms']:.4f} ms, bound "
          f"{fold['bound_ms']:.4f} ms")
    # forward and backward where the 5,000-edge row is the only cut row
    no_star = hub_plan(k, SEED + 4, star=0)
    for H, F in ((GAT_HEADS, GAT_HIDDEN), (1, N_CLASS)):
        before = k.flash_fwd_fold.launches
        e = flash_check(k, f"hub without the star bf16 H={H} F={F}",
                        no_star, H, F, bf16, True, True, gen, dev)
        if k.flash_fwd_fold.launches - before != 2:  # the check and a repeat
            fail(f"hub without the star H={H} F={F}: folds "
                 f"{k.flash_fwd_fold.launches - before} (want 2)")
        for name in err:
            err[name] = max(err[name], e[name])
    return err, rows, fold


def phase_flash_checks(k, slice_plan):
    phase_start("phase 3: flash attention kernels vs plain versions on the "
                "card")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    n_dst, n_src, e = 700, 900, 5000
    dst = 2 * rng.integers(0, 300, e)  # odd rows and the tail: empty
    plan = k.build_csr_plan(rng.integers(0, n_src, e), dst, n_dst,
                            num_src=n_src)
    none = np.zeros(0, np.int64)
    empty = k.build_csr_plan(none, none, 50, num_src=30)
    for dtype in (torch.float32, torch.bfloat16):
        for H, F in ((8, 8), (1, 40), (1, 64), (2, 640)):
            # (keep, gather): no keep; keep in CSR order with per-edge
            # inputs; keep in the caller's order with node rows
            for keep, gather in ((False, True), (True, False), (True, True)):
                flash_check(k, f"{dtype} H={H} F={F} keep={keep} "
                            f"gather={gather}", plan, H, F, dtype, gather,
                            keep, gen, dev)
            flash_check(k, f"{dtype} H={H} F={F} E=0", empty, H, F, dtype,
                        True, True, gen, dev)
    main_err = {"flash_forward": 0.0, "flash_backward": 0.0}
    timings = {"flash_forward": [], "flash_backward": []}
    for H, F in ((GAT_HEADS, GAT_HIDDEN), (1, N_CLASS)):
        label = f"slice graph bf16 H={H} F={F}"
        err = flash_check(k, label, slice_plan, H, F, torch.bfloat16, True,
                          True, gen, dev)
        for name in main_err:
            main_err[name] = max(main_err[name], err[name])
        s, a, msg, kp = _flash_inputs(gen, slice_plan, H, F, torch.bfloat16,
                                      True, True, dev)
        # as GATConv calls them: node rows, keep in the caller's order
        args = (s, a, msg, kp)
        out, m, l = k.flash_forward(*args, slice_plan, 0.2, True)
        g = torch.randn(out.shape, generator=gen).to(dev, torch.bfloat16)
        bwd_args = (*args, m, l, out, g, slice_plan, 0.2, True)
        for name, kern, plain in (
                ("flash_forward",
                 lambda: k.flash_forward(*args, slice_plan, 0.2, True),
                 lambda: k.flash_forward_reference(*args, slice_plan, 0.2,
                                                   True)),
                ("flash_backward",
                 lambda: k.flash_backward(*bwd_args),
                 lambda: k.flash_backward_reference(*bwd_args))):
            N, Ns, E = (slice_plan.num_nodes, slice_plan.num_src,
                        slice_plan.num_edges)
            # in: the node rows, per-node scores, a_dst, keep and its
            # perm row, col and rowptr; forward out: out, m and l;
            # backward also in: m, l, out and the cotangent, out: ds,
            # dmsg and da
            nbytes = (Ns * H * F * 2 + Ns * H * 4 + N * H * 4 + E * H * 4
                      + E * 8 + E * 4 + (N + 1) * 8)
            if name == "flash_forward":
                nbytes += N * H * F * 2 + 2 * N * H * 4
                flops = 2 * E * H * F + 6 * E * H
            else:
                nbytes += (2 * N * H * 4 + 2 * N * H * F * 2 + E * H * 4
                           + E * H * F * 2 + N * H * 4)
                flops = 4 * E * H * F + 8 * E * H
            timings[name].append({"H": H, "F": F, **timing(
                f"{name} H={H} F={F}", kern, plain, nbytes, flops,
                plain_iters=3)})
    hub_err, hub_rows, fold = flash_hub_checks(k, gen, dev)
    for name in main_err:
        main_err[name] = max(main_err[name], hub_err[name])
    timings["flash_forward"].extend(hub_rows)
    return main_err, timings, fold


def phase_edge_checks(k, slice_plan):
    """The expand, per-edge segment sum and SDDMM kernels against their
    plain versions; returns (max abs error by kernel, timings)."""
    phase_start("phase 4: expand, per-edge segment sum and SDDMM kernels vs "
                "plain versions on the card")
    from gammagl_tpu_torch.ops.cuda.sddmm_csr import _expand, _sddmm
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 8)
    rng = np.random.default_rng(SEED + 8)
    n_dst, n_src, e = 700, 900, 5000
    dst = 2 * rng.integers(0, 300, e)  # odd rows and the tail: empty
    sparse = k.build_csr_plan(rng.integers(0, n_src, e), dst, n_dst,
                              num_src=n_src)
    none = np.zeros(0, np.int64)
    empty = k.build_csr_plan(none, none, 50, num_src=30)
    err = {"expand_dst_csr": 0.0, "segment_sum_csr": 0.0, "sddmm_csr": 0.0}

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for C, H in ((7, 7), (40, 1), (64, 8)):
            for pname, p in (("empty rows", sparse), ("E=0", empty)):
                E, tag = p.num_edges, f"{dtype} C={C} H={H} {pname}"
                x = rand(p.num_nodes, C, dtype=dtype)
                got = k.expand_dst_csr(x, p)
                if not torch.equal(got, k.expand_dst_csr_reference(x, p)):
                    fail(f"expand {tag}: not bitwise equal to x[row]")
                scale = rand(E, H)
                got = _expand(x, p, scale)
                err["expand_dst_csr"] = max(err["expand_dst_csr"], check_close(
                    f"scaled expand {tag}", got,
                    k.expand_dst_csr_reference(x, p, scale), rtol))
                v = rand(E, C, dtype=dtype)
                for wname, w in (("unit", None), ("(E,)", rand(E).abs()),
                                 ("(E, H)", rand(E, H).abs())):
                    got = k.segment_sum_csr(v, p, w)
                    err["segment_sum_csr"] = max(
                        err["segment_sum_csr"], check_close(
                            f"segment sum {wname} {tag}", got,
                            k.segment_sum_csr_reference(v, p, w), rtol))
                xd = rand(p.num_nodes, C, dtype=dtype)
                for gather, a in ((True, rand(p.num_src, C, dtype=dtype)),
                                  (False, v)):
                    got = _sddmm(a, xd, p, H, gather)
                    err["sddmm_csr"] = max(err["sddmm_csr"], check_close(
                        f"sddmm gather={gather} {tag}", got,
                        k.sddmm_csr_reference(a, xd, p, H, gather), 1e-5))
                if p is sparse:  # no atomics: repeats give the same bits
                    w = rand(E, H).abs()
                    if not (torch.equal(_expand(x, p, scale),
                                        _expand(x, p, scale))
                            and torch.equal(k.segment_sum_csr(v, p, w),
                                            k.segment_sum_csr(v, p, w))
                            and torch.equal(_sddmm(v, xd, p, H, False),
                                            _sddmm(v, xd, p, H, False))):
                        fail(f"{tag}: repeated launches differ")

    # hub rows: the per-edge form's rows cut into work items and folded
    hub = hub_plan(k, SEED + 8)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for C, H in ((7, 7), (40, 1), (64, 8)):
            v = exact(gen, hub.num_edges, C).to(dev, dtype)
            for wname, w in (
                    ("unit", None),
                    ("(E,)", exact(gen, hub.num_edges, weights=True)),
                    ("(E, H)", exact(gen, hub.num_edges, H, weights=True))):
                w = None if w is None else w.to(dev)
                err["segment_sum_csr"] = max(err["segment_sum_csr"], hub_check(
                    k, f"segment sum {wname} {dtype} C={C} H={H}",
                    k.segment_sum_csr, lambda: k.segment_sum_csr(v, hub, w),
                    k.segment_sum_csr_reference(v, hub, w), rtol))
    del v
    hub_rows, hub_expand = sddmm_hub_checks(k, hub, err)

    plan, bf16 = slice_plan, torch.bfloat16
    N, Ns, E = plan.num_nodes, plan.num_src, plan.num_edges
    rowptr, col, _ = plan.arrays(dev)
    counts = rowptr.diff()
    timings = {"expand_dst_csr": [], "segment_sum_csr": [], "sddmm_csr": []}
    for C in (GAT_HEADS * GAT_HIDDEN, N_CLASS):  # GATv2's layer widths
        x = rand(N, C, dtype=bf16)
        if not torch.equal(k.expand_dst_csr(x, plan),
                           k.expand_dst_csr_reference(x, plan)):
            fail(f"slice graph expand C={C}: not bitwise equal to x[row]")
        timings["expand_dst_csr"].append({"C": C, "scaled": False, **timing(
            f"expand C={C} bf16", lambda: k.expand_dst_csr(x, plan),
            lambda: k.expand_dst_csr_reference(x, plan),
            nbytes=N * C * 2 + (N + 1) * 8 + E * C * 2, flops=0,
            library=lambda: torch.repeat_interleave(x, counts, dim=0,
                                                    output_size=E))})
        v = rand(E, C, dtype=bf16)
        err["segment_sum_csr"] = max(err["segment_sum_csr"], check_close(
            f"slice graph segment sum C={C} bf16", k.segment_sum_csr(v, plan),
            k.segment_sum_csr_reference(v, plan), 1e-2))
        timings["segment_sum_csr"].append({"C": C, **timing(
            f"segment sum C={C} bf16", lambda: k.segment_sum_csr(v, plan),
            lambda: k.segment_sum_csr_reference(v, plan),
            nbytes=E * C * 2 + (N + 1) * 8 + N * C * 2, flops=E * C,
            library=lambda: torch.segment_reduce(v, "sum", offsets=rowptr))})

    # the SDDMM at bench.py's shape: gathered rows, x_src = x_dst = x
    x = rand(Ns, SDDMM_F, dtype=bf16)
    err["sddmm_csr"] = max(err["sddmm_csr"], check_close(
        f"slice graph sddmm F={SDDMM_F} bf16", _sddmm(x, x, plan, 1, True),
        k.sddmm_csr_reference(x, x, plan, 1, True), 1e-5))
    mask = torch.sparse_csr_tensor(rowptr, col.long(),
                                   torch.ones(E, device=dev, dtype=bf16),
                                   size=(N, Ns))
    timings["sddmm_csr"].append({"H": 1, "F": SDDMM_F, "gather": True,
                                 **timing(
        f"sddmm F={SDDMM_F} bf16 gathered", lambda: _sddmm(x, x, plan, 1, True),
        lambda: k.sddmm_csr_reference(x, x, plan, 1, True),
        nbytes=Ns * SDDMM_F * 2 + E * 4 + (N + 1) * 8 + E * 4,
        flops=2 * E * SDDMM_F,
        library=lambda: torch.sparse.sampled_addmm(mask, x, x.t(), beta=0.0))})
    # the gathered rows alone (E x row bytes from HBM), which the bound
    # (the table read once) does not count, and the CSR kernel reading
    # the same rows
    row = timings["sddmm_csr"][-1]
    row["floor_ms"] = E * SDDMM_F * 2 / HBM_BYTES_PER_S * 1e3
    row["spmm_csr_ms"] = cuda_ms(lambda: k.spmm_csr(x, None, plan))
    print(f"  sddmm F={SDDMM_F} gathered: gathered-row floor "
          f"{row['floor_ms']:.4f} ms ({row['floor_ms'] / row['ms']:.3f} of "
          f"the kernel's time); spmm_csr at F={SDDMM_F} {row['spmm_csr_ms']:.4f}"
          f" ms, the SDDMM {row['ms'] / row['spmm_csr_ms']:.3f}x it")
    # its backward: two SpMMs weighted by the cotangent
    xs, xd = x.clone().requires_grad_(), x.clone().requires_grad_()
    g = rand(E)
    k.sddmm_csr(xs, xd, plan).backward(g)
    tp = plan.transpose()
    check_close(f"sddmm F={SDDMM_F} backward dx_dst", xd.grad,
                k.spmm_csr_reference(x, g, plan, weights_padded=True), 1e-2)
    check_close(f"sddmm F={SDDMM_F} backward dx_src", xs.grad,
                k.spmm_csr_reference(x, g[tp.arrays(dev)[2]], tp,
                                     weights_padded=True), 1e-2)
    # per-edge rows (H=8, F=8), and the backward: the scaled expand and
    # the per-head weighted segment sum
    H, F = GAT_HEADS, GAT_HIDDEN
    msg, xd = rand(E, H * F, dtype=bf16), rand(N, H * F, dtype=bf16)
    err["sddmm_csr"] = max(err["sddmm_csr"], check_close(
        f"slice graph sddmm H={H} F={F} per edge",
        _sddmm(msg, xd, plan, H, False),
        k.sddmm_csr_reference(msg, xd, plan, H, False), 1e-5))
    timings["sddmm_csr"].append({"H": H, "F": F, "gather": False, **timing(
        f"sddmm H={H} F={F} bf16 per edge", lambda: _sddmm(msg, xd, plan, H,
                                                          False),
        lambda: k.sddmm_csr_reference(msg, xd, plan, H, False),
        nbytes=E * H * F * 2 + N * H * F * 2 + (N + 1) * 8 + E * H * 4,
        flops=2 * E * H * F)})
    m3 = msg.view(E, H, F).clone().requires_grad_()
    x3 = xd.view(N, H, F).clone().requires_grad_()
    g = rand(E, H)
    k.sddmm_csr_mh(None, x3, plan, msg=m3).backward(g)
    err["expand_dst_csr"] = max(err["expand_dst_csr"], check_close(
        f"sddmm H={H} F={F} backward dmsg (scaled expand)",
        m3.grad.view(E, H * F), k.expand_dst_csr_reference(xd, plan, g),
        1e-2))
    err["segment_sum_csr"] = max(err["segment_sum_csr"], check_close(
        f"sddmm H={H} F={F} backward dx_dst ((E, H) segment sum)",
        x3.grad.view(N, H * F), k.segment_sum_csr_reference(msg, plan, g),
        1e-2))
    timings["expand_dst_csr"].append({"C": H * F, "scaled": True, **timing(
        f"scaled expand C={H * F} H={H} bf16", lambda: _expand(xd, plan, g),
        lambda: k.expand_dst_csr_reference(xd, plan, g),
        nbytes=N * H * F * 2 + E * H * 4 + (N + 1) * 8 + E * H * F * 2,
        flops=E * H * F)})
    spills = kernel_resources(("sddmm_kernel", "sddmm_wide_kernel",
                               "expand_kernel"))
    if any(spills.values()):
        fail(f"an SDDMM or expand instantiation spills: {spills}")
    for row in timings["sddmm_csr"]:
        row["spill_bytes"] = max(spills["sddmm_kernel"],
                                 spills["sddmm_wide_kernel"])
    for row in timings["expand_dst_csr"]:
        row["spill_bytes"] = spills["expand_kernel"]
    timings["sddmm_csr"] += hub_rows
    timings["expand_dst_csr"].append(hub_expand)
    return err, timings


def sddmm_hub_checks(k, hub, err):
    """The SDDMM on the hub graph, its rows cut into work items at
    `EDGE_SPLIT` (the star into thousands of items): both forms, f32 and
    bf16, at 1e-5 against the plain version (both sum in f32), each call
    exactly one launch and no fold; each bf16 form timed beside
    `spmm_csr` (gathered) or `segment_sum_csr` (per edge) at the same
    width on that graph; then the expand there, on the same work items:
    one launch a call, bitwise equal to the plain version, timed over 10
    calls. Returns the SDDMM's timing rows and the expand's."""
    from gammagl_tpu_torch.ops.cuda.sddmm_csr import EDGE_SPLIT, _sddmm
    split = hub.row_split(EDGE_SPLIT)
    print(f"  hub graph, work items (EDGE_SPLIT {EDGE_SPLIT}): "
          f"{split.item_row.shape[0]} items, {split.cut_row.shape[0]} cut "
          "rows, no scratch")
    N, Ns, E = hub.num_nodes, hub.num_src, hub.num_edges
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def rand(*shape, dtype):  # drawn on the card: up to 1.6G values
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for H, F in ((1, SDDMM_F), (GAT_HEADS, GAT_HIDDEN), (2, 640)):
            C = H * F
            xd = rand(N, C, dtype=dtype)
            for gather in (True, False):
                a = rand(Ns if gather else E, C, dtype=dtype)
                tag = (f"hub sddmm {dtype} H={H} F={F} "
                       f"{'gathered' if gather else 'per edge'}")
                c0, f0 = k.sddmm_csr.launches, k.csr_fold.launches
                got = _sddmm(a, xd, hub, H, gather)
                sync()
                launched = (k.sddmm_csr.launches - c0,
                            k.csr_fold.launches - f0)
                if launched != (1, 0):
                    fail(f"{tag}: launches {launched[0]}, folds "
                         f"{launched[1]} (want 1 and 0)")
                err["sddmm_csr"] = max(err["sddmm_csr"], check_close(
                    tag, got, k.sddmm_csr_reference(a, xd, hub, H, gather),
                    1e-5))
                del got
                if dtype != torch.bfloat16:
                    continue
                ms = cuda_ms(lambda: _sddmm(a, xd, hub, H, gather), iters=10)
                if gather:
                    name, ref = "spmm_csr", cuda_ms(
                        lambda: k.spmm_csr(a, None, hub), iters=10)
                else:
                    name, ref = "segment_sum_csr", cuda_ms(
                        lambda: k.segment_sum_csr(a, hub), iters=10)
                print(f"  {tag}: {ms:.4f} ms, {name} at {C} columns there "
                      f"{ref:.4f} ms, the SDDMM {ms / ref:.3f}x it")
                rows.append({"H": H, "F": F, "gather": gather,
                             "graph": "hub", "ms": ms, f"{name}_ms": ref})
            del a, xd
    C = GAT_HEADS * GAT_HIDDEN
    x = rand(N, C, dtype=torch.bfloat16)
    c0 = k.expand_dst_csr.launches
    got = k.expand_dst_csr(x, hub)
    sync()
    if k.expand_dst_csr.launches - c0 != 1:
        fail(f"hub expand: {k.expand_dst_csr.launches - c0} launches, want 1")
    if not torch.equal(got, k.expand_dst_csr_reference(x, hub)):
        fail("hub expand: not bitwise equal to x[row]")
    del got
    ms = cuda_ms(lambda: k.expand_dst_csr(x, hub), iters=10)
    row = {"C": C, "scaled": False, "graph": "hub", "ms": ms,
           **bound(N * C * 2 + (N + 1) * 8 + E * C * 2, 0)}
    print(f"  hub expand C={C} bf16 ({split.item_row.shape[0]} items at "
          f"EDGE_SPLIT {EDGE_SPLIT}): {ms:.4f} ms, bitwise x[row]; "
          f"bound {row['bound_ms']:.4f} ms, {row['bound_ms'] / ms:.3f} of it")
    return rows, row


def phase_gcn_serve(k, GCNModel, InferenceSession, load_jax_params, plan, x,
                    ei):
    phase_start("phase 5: serve GCN through InferenceSession")
    sess = InferenceSession(gcn_model(GCNModel, load_jax_params), (x, ei),
                            device="cuda", compute_dtype=torch.bfloat16,
                            plan=plan)
    return serve(k, sess, x, ei, {"spmm_csr": N_LAYERS}, "GCN")


def serve(k, sess, x, ei, per_request, name):
    """Drive N_REQUESTS requests through ``sess`` and hold each against
    the session's model on the plain COO path (see `serve_requests`)."""
    def plain(xr):
        with torch.inference_mode():
            return sess.model(xr.to(torch.bfloat16), ei)
    return serve_requests(k, [x + r * 1e-3 for r in range(N_REQUESTS)],
                          lambda xr: sess(xr, ei), plain, per_request, name,
                          (x.shape[0], N_CLASS))


def serve_requests(k, requests, run, plain, per_request, name, shape,
                   tol=3e-2):
    """Run each request with counts reset just before the first and read
    just after the last; hold each output (of ``shape``) against
    ``plain(request)`` within ``tol`` of max |logit|. Returns (counts,
    latencies in ms)."""
    sync()
    reset_counts(k)
    outputs, lat_ms = [], []
    for xr in requests:
        t0 = time.perf_counter()
        out = run(xr)
        sync()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        outputs.append(out)
    counts = read_counts(k)
    want = every_kernel(per_request, len(requests))
    print(f"  {len(requests)} {name} requests, launches {counts}")
    if counts != want:
        fail(f"{name} serve: expected launches {want}, counted {counts}")
    for r, (xr, out) in enumerate(zip(requests, outputs)):
        if out.shape != shape:
            fail(f"{name} request {r}: logits shape {tuple(out.shape)}")
        ref = plain(xr)
        err = float((out.float() - ref.float()).abs().max())
        limit = tol * float(ref.float().abs().max())
        print(f"  request {r}: {lat_ms[r]:.3f} ms, max |logit - plain| "
              f"{err:.3e} (tol {limit:.3e})")
        if not (bool(torch.isfinite(out).all()) and err <= limit):
            fail(f"{name} request {r}: logits disagree with the plain path")
    lat = np.asarray(lat_ms)
    print(f"  {name} request latency: p50 {np.median(lat):.3f} ms, "
          f"max {lat.max():.3f} ms")
    return counts, lat


def gat_model(GATModel, load_jax_params):
    model = GATModel(hidden_dim=GAT_HIDDEN, num_class=N_CLASS,
                     heads=GAT_HEADS, drop_rate=GAT_DROP,
                     dtype=torch.bfloat16, in_channels=N_FEAT)
    return load_jax_params(model, gat_params())


def gatv2_model(GATV2Model, load_jax_params):
    model = GATV2Model(hidden_dim=GAT_HIDDEN, num_class=N_CLASS,
                       heads=GAT_HEADS, drop_rate=GAT_DROP,
                       in_channels=N_FEAT)
    return load_jax_params(model, gatv2_params())


def phase_gat_serve(k, GATModel, InferenceSession, load_jax_params, plan, x,
                    ei):
    phase_start("phase 6: serve GAT through InferenceSession")
    sess = InferenceSession(gat_model(GATModel, load_jax_params), (x, ei),
                            device=x.device, compute_dtype=torch.bfloat16,
                            plan=plan)
    return serve(k, sess, x, ei, {"flash_forward": 2}, "GAT")


def phase_gatv2_serve(k, GATV2Model, InferenceSession, load_jax_params, plan,
                      x, ei):
    """GATV2Model has no dtype: bf16 compute is the process default, set
    by the caller. The session runs on its default device, the card."""
    phase_start("phase 8: serve GATv2 through InferenceSession")
    sess = InferenceSession(gatv2_model(GATV2Model, load_jax_params),
                            (x, ei), compute_dtype=torch.bfloat16, plan=plan)
    if sess.device.type != "cuda":
        fail(f"InferenceSession's default device is {sess.device}")
    counts, lat = serve(k, sess, x, ei,
                        {"expand_dst_csr": 2, "flash_forward": 2}, "GATv2")
    return counts, lat, profile("gatv2_serve", lambda: sess(x, ei))


def train_labels(x):
    """Random labels and a train mask over a random 54% of the nodes
    (ogbn-arxiv's train split is 53.7%)."""
    rng = np.random.default_rng(SEED + 5)
    n, dev = x.shape[0], x.device
    return (torch.from_numpy(rng.integers(0, N_CLASS, n)).to(dev),
            torch.from_numpy(rng.random(n) < 0.54).to(dev))


def dropout_rng(model, seed):
    """The same dropout masks on both paths of a train phase: a generator
    for a model whose forward takes one (its layers draw from it), else
    the default generators seeded (`nn.Dropout` draws from them). Returns
    the forward's keyword arguments."""
    if "generator" in inspect.signature(model.forward).parameters:
        return {"generator": torch.Generator(device="cuda").manual_seed(seed)}
    torch.manual_seed(seed)
    return {}


def train_phase(k, label, make_model, twin, per_step, lr, l2, plan, x, ei,
                keeps_for=None, check_step0=True, labels=None,
                plan_key="plan", fkw=None, make_plain=None):
    """N_STEPS steps of ``twin``'s step through the kernels and through
    the plain COO path, with the same keep masks (``keeps_for(step)``, or
    drawn by the layers), input-dropout generator state and parameters:
    step-0 gradients (unless ``check_step0`` is False), losses, launches a
    step. ``labels``: (y, mask), else `train_labels`; the plan goes to the
    model as ``plan_key``, ``fkw`` to every forward; ``make_plain``
    builds the plain path's model where it is not ``make_model``'s (a
    layer that requires its plan). Returns (launches,
    losses, step times in ms, max step-0 gradient error, (the kernel
    path's state, its labels and mask, both paths' step-0 gradients))."""
    from gammagl_tpu_torch.train import TrainState
    y, mask = labels if labels is not None else train_labels(x)
    dev = y.device
    makers = {"kernel": make_model, "plain": make_plain or make_model}
    states = {path: TrainState(makers[path]().to(dev), lr, l2)
              for path in ("kernel", "plain")}
    want_step = every_kernel(per_step)
    losses = {"kernel": [], "plain": []}
    step_ms = {"kernel": [], "plain": []}
    launches = every_kernel({})
    grad_err, step0_grads = 0.0, {}
    for step in range(N_STEPS):
        keeps = keeps_for(step) if keeps_for is not None else None
        for path in ("kernel", "plain"):
            state = states[path]
            kw = {plan_key: plan if path == "kernel" else None,
                  **dropout_rng(state.model, SEED + 100 + step),
                  **(fkw or {})}
            if keeps is not None:
                kw["keeps"] = keeps
            sync()
            reset_counts(k)
            t0 = time.perf_counter()
            if step == 0:  # read the gradients before the update
                state.model.train()
                loss = twin.loss_and_grad(state.model, x, ei, y, mask, **kw)
                grads = {name: (torch.zeros_like(p) if p.grad is None
                                else p.grad.clone())
                         for name, p in state.model.named_parameters()}
                step0_grads[path] = grads
                state.apply_gradients()
            else:
                loss = twin.train_step(state, x, ei, y, mask, **kw)
            loss = float(loss)
            sync()
            step_ms[path].append((time.perf_counter() - t0) * 1e3)
            counts = read_counts(k)
            if path == "kernel":
                if counts != want_step:
                    fail(f"{label} step {step}: expected launches "
                         f"{want_step}, counted {counts}")
                for kname in launches:
                    launches[kname] += counts[kname]
                if step == 0:
                    kernel_grads = grads
            elif any(counts.values()):
                fail(f"the plain path launched kernels: {counts}")
            losses[path].append(loss)
        if step == 0 and check_step0:
            for name, want in grads.items():
                grad_err = max(grad_err, check_close(
                    f"step-0 grad {name}", kernel_grads[name], want, 0.0,
                    atol=GRAD_TOL))
        lk, lp = losses["kernel"][-1], losses["plain"][-1]
        print(f"  step {step}: loss kernel {lk:.5f}, plain {lp:.5f}; "
              f"{step_ms['kernel'][-1]:.2f} ms kernel path, "
              f"{step_ms['plain'][-1]:.2f} ms plain path")
        if not np.isfinite(lk) or abs(lk - lp) > LOSS_TOL * abs(lp):
            fail(f"{label} step {step}: loss {lk} vs plain {lp}")
    if not losses["kernel"][-1] < (1 - MIN_FALL) * losses["kernel"][0]:
        fail(f"{label}: loss did not fall by {MIN_FALL:.0%}: "
             f"{losses['kernel']}")
    ms = np.asarray(step_ms["kernel"][1:])
    print(f"  {label} train step (steps 1-{N_STEPS - 1}): median "
          f"{np.median(ms):.2f} ms kernel path, "
          f"{np.median(step_ms['plain'][1:]):.2f} ms plain path; launches "
          f"{launches}")
    return (launches, losses, step_ms, grad_err,
            (states["kernel"], y, mask, step0_grads))


def gat_keeps(k, x, ei):
    """``keeps_for(step)``: GAT's attention keep masks, drawn here, in the
    caller's edge order, and handed to both paths of a train phase."""
    dev, E = x.device, ei.shape[1]
    keep_gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def keeps_for(step):
        return [k.attention_keep_mask(keep_gen, GAT_DROP, (E, h), dev)
                for h in (GAT_HEADS, 1)]
    return keeps_for


# a step: 2 flash forwards, 2 gathered flash backwards, each followed by
# 2 SpMM on the edge-scatter plan (the score's and the features'
# gradients to their sources, ROADMAP C39)
GAT_STEP_LAUNCHES = {"spmm_csr": 4, "flash_forward": 2, "flash_backward": 2}


def phase_gat_train(k, twin, GATModel, load_jax_params, plan, x, ei):
    phase_start("phase 7: train GAT (the fusedgat twin's step) against the "
                "plain path")
    return train_phase(
        k, "GAT", lambda: gat_model(GATModel, load_jax_params), twin,
        GAT_STEP_LAUNCHES, GAT_LR, 0.0, plan, x, ei,
        gat_keeps(k, x, ei))[:4]


def phase_gatv2_train(k, common, GATV2Model, load_jax_params,
                      compute_dtype, plan, x, ei):
    """The layers draw their attention masks from the generator, in CSR
    order on both paths; bf16 compute is the process default.

    Step-0 gradients are held in float32 compute, where only the order of
    the sums differs between the paths. In bf16 the second layer's
    ``Dense_1`` gradient is a sum that cancels, and any two orders of
    GATv2's bf16 arithmetic land far apart in it: this phase prints how
    far each bf16 path's step-0 gradients lie from the float32 ones (the
    same masks: step 0 of the bf16 run draws from the same generator
    state). The 5 training steps run in bf16 and hold the losses."""
    phase_start("phase 9: train GATv2 (the gatv2 twin's step) against the "
                "plain path")
    per_step = {"expand_dst_csr": 2, "flash_forward": 2, "flash_backward": 2,
                "segment_sum_csr": 2, "spmm_csr": 2}
    with compute_dtype(None):
        grad_err, f32 = f32_step0_grads(
            k, "GATv2", lambda: gatv2_model(GATV2Model, load_jax_params),
            common, per_step, plan, x, ei, train_labels(x))
    launches, losses, step_ms, _, (state, y, mask, bf16) = train_phase(
        k, "GATv2", lambda: gatv2_model(GATV2Model, load_jax_params), common,
        per_step, GATV2_LR, GATV2_L2, plan, x, ei, check_step0=False)
    bf16_err = {}
    for path in ("kernel", "plain"):  # each bf16 path against float32
        rel = {name: float((g.float() - f32[name]).abs().max())
               / float(f32[name].abs().max())
               for name, g in bf16[path].items()}
        worst = max(rel, key=rel.get)
        bf16_err[path] = rel[worst]
        print(f"  bf16 step-0 gradients of the {path} path against float32: "
              f"worst {rel[worst]:.4f} of max |grad| ({worst}); "
              + ", ".join(f"{n} {r:.4f}" for n, r in rel.items()))
    gen = torch.Generator(device=x.device).manual_seed(SEED + 200)
    prof = profile("gatv2_train", lambda: common.train_step(
        state, x, ei, y, mask, plan=plan, generator=gen))
    return launches, losses, step_ms, grad_err, bf16_err, prof


def phase_sddmm_path(k, plan):
    """The sddmm_csr entry point as bench.py drives it (F = 256 bf16, one
    tensor on both sides), and sddmm_csr_mh on per-edge rows, forward and
    backward."""
    phase_start("phase 10: the sddmm_csr and sddmm_csr_mh entry points, "
                "forward and backward")
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(SEED + 9)
    N, E, H, F = plan.num_nodes, plan.num_edges, GAT_HEADS, GAT_HIDDEN
    x = torch.randn(N, SDDMM_F, generator=gen).to(dev, torch.bfloat16)
    msg = torch.randn(E, H, F, generator=gen).to(dev, torch.bfloat16)
    xd = torch.randn(N, H, F, generator=gen).to(dev, torch.bfloat16)
    x, msg, xd = (t.requires_grad_() for t in (x, msg, xd))

    def pair():
        s = k.sddmm_csr(x, x, plan)
        s.sum().backward()
        s_mh = k.sddmm_csr_mh(None, xd, plan, msg=msg)
        s_mh.sum().backward()
        return s, s_mh

    sync()
    reset_counts(k)
    for _ in range(N_SDDMM_CALLS):
        s, s_mh = pair()
    sync()
    counts = read_counts(k)
    want = every_kernel({"sddmm_csr": 2, "spmm_csr": 2, "expand_dst_csr": 1,
                         "segment_sum_csr": 1}, N_SDDMM_CALLS)
    print(f"  {N_SDDMM_CALLS} calls of each, launches {counts}")
    if counts != want:
        fail(f"sddmm path: expected launches {want}, counted {counts}")
    for name, t in (("scores", s), ("per-edge scores", s_mh),
                    ("dx", x.grad), ("dmsg", msg.grad), ("dx_dst", xd.grad)):
        if not bool(torch.isfinite(t).all()):
            fail(f"sddmm path: non-finite {name}")
    if s.shape != (E,) or s_mh.shape != (E, H):
        fail(f"sddmm path: shapes {tuple(s.shape)}, {tuple(s_mh.shape)}")
    prof = profile("sddmm_pair", pair)
    print(f"  sddmm pair call: host {prof['span_us'] / 1e3:.3f} ms, device "
          f"busy {prof['busy_us'] / 1e3:.3f} ms")
    return counts, prof


def max_hub_call(k, label, counters, run, want):
    """One segment-max call on the hub graph: exactly one launch of each of
    ``counters`` (the kernel and its passes over cut rows), the result
    bitwise equal to the plain version's ``want`` (dw, the third item of a
    backward's, within 1e-5), a repeat bitwise equal. Returns the result
    and the max abs error of dw (0 without)."""
    before = [fn.launches for fn in counters]
    got = run()
    sync()
    launched = [fn.launches - b for fn, b in zip(counters, before)]
    if launched != [1] * len(counters):
        fail(f"hub {label}: launches {launched} of "
             f"{[fn.__name__ for fn in counters]} (want one each)")
    got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,),
                                                                (want,))
    if not torch.equal(got_t[0], want_t[0]):
        fail(f"hub {label}: not bitwise equal to the plain version")
    again = run()
    if not torch.equal((again if isinstance(again, tuple) else (again,))[0],
                       got_t[0]):
        fail(f"hub {label}: repeated launches differ")
    err = 0.0
    if len(got_t) > 1 and got_t[1] is not None:
        err = check_close(f"hub {label} dw", got_t[1], want_t[1], 1e-5)
    return got, err


def max_hub_checks(k, gen, dev):
    """The segment max on the hub graph (a 1,200,000-edge star and a
    5,000-edge hub cut into work items): forward gathered and per edge,
    max and min, backward with and without dw; f32 and bf16, F in {7, 40,
    128, 256}, with and without weights. Integer features and weights in
    eighths tie across items; in the per-edge rows the star's first item
    holds only -inf in column 0, and in column 2 the star's winners are
    two edges in two items. Returns the max abs error of dw."""
    plan = hub_plan(k, SEED + 11)
    E, star = plan.num_edges, int(plan.rowptr[1])
    col = plan.arrays(dev)[1].long()
    fwd = (k.spmm_max_csr, k.segment_max_fold)
    bwd = (k.segment_max_bwd, k.segment_max_count, k.segment_max_count_fold)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for F in (7, 40, 128, 256):
            x = exact(gen, plan.num_src, F).to(dev, dtype)
            for weighted in (False, True):
                tag = f"{dtype} F={F} weighted={weighted}"
                w = ((torch.randint(1, 9, (E,), generator=gen) / 8).to(dev)
                     if weighted else None)
                for fn, ref in ((k.spmm_max_csr, k.spmm_max_csr_reference),
                                (k.spmm_min_csr, k.spmm_min_csr_reference)):
                    max_hub_call(k, f"{fn.__name__} {tag}",
                                 (fn, k.segment_max_fold),
                                 lambda: fn(x, w, plan), ref(x, w, plan))
                wp = None if w is None else k.pad_edge_weights(plan, w)
                out, _ = max_hub_call(
                    k, f"spmm_max_csr padded {tag}", fwd,
                    lambda: k.spmm_max_csr(x, wp, plan, weights_padded=True),
                    k.spmm_max_csr_reference(x, wp, plan,
                                             weights_padded=True))
                g = torch.randn(out.shape, generator=gen).to(dev, dtype)
                for want_dw in ((False, True) if weighted else (False,)):
                    _, e = max_hub_call(
                        k, f"segment_max_bwd {tag} dw={want_dw}", bwd,
                        lambda: k.segment_max_bwd(x, wp, out, g, plan, False,
                                                  want_dw),
                        k.segment_max_bwd_reference(x, wp, out, g, plan,
                                                    False, want_dw))
                    err = max(err, e)
            msg = x[col]
            msg[:k.ROW_SPLIT, 0] = -np.inf
            if F > 2:  # two winners, in the star's first two items
                msg[:star, 2] = msg[:star, 2].clamp_max(3)
                msg[[5, k.ROW_SPLIT + 5], 2] = 4
            for fn, ref in ((k.segment_max_csr, k.segment_max_csr_reference),
                            (k.segment_min_csr,
                             k.segment_min_csr_reference)):
                max_hub_call(k, f"{fn.__name__} {dtype} F={F}",
                             (fn, k.segment_max_fold),
                             lambda: fn(msg, plan), ref(msg, plan))
            out = k.segment_max_csr(msg, plan)
            g = torch.randn(out.shape, generator=gen).to(dev, dtype)
            (dmsg, _), _ = max_hub_call(
                k, f"segment_max_bwd per edge {dtype} F={F}", bwd,
                lambda: k.segment_max_bwd(msg, None, out, g, plan, True,
                                          False),
                k.segment_max_bwd_reference(msg, None, out, g, plan, True,
                                            False))
            if F > 2 and int((dmsg[:star, 2] != 0).sum()) != 2:
                fail(f"hub per edge {dtype} F={F}: the two tied winners in "
                     "two items did not take the cotangent")
    print("  hub graph: forward (max, min; gathered with and without "
          "weights, padded weights, per edge) and backward (with and "
          "without dw, per edge) bitwise equal to the plain versions, one "
          "launch of the kernel and of each pass over cut rows a call, "
          "repeats bitwise (f32, bf16; F 7, 40, 128, 256)")
    return err, plan


def phase_max_checks(k, slice_plan):
    """The segment-max kernels (forward, both forms, max and min; the
    backward) against their plain versions; returns (max abs error by
    kernel, timings)."""
    phase_start("phase 11: segment max and min kernels vs plain versions on "
                "the card")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 12)
    rng = np.random.default_rng(SEED + 12)
    n_dst, n_src, e = 700, 900, 5000
    dst = 2 * rng.integers(0, 300, e)  # odd rows and the tail: empty
    sparse = k.build_csr_plan(rng.integers(0, n_src, e), dst, n_dst,
                              num_src=n_src)
    none = np.zeros(0, np.int64)
    empty = k.build_csr_plan(none, none, 50, num_src=30)
    err = {"spmm_max_csr": 0.0, "segment_max_bwd": 0.0}

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    forms = ((k.spmm_max_csr, k.spmm_max_csr_reference),
             (k.spmm_min_csr, k.spmm_min_csr_reference))
    for dtype in (torch.float32, torch.bfloat16):
        for F in (7, 40, 128, 256):
            for pname, p in (("empty rows", sparse), ("E=0", empty)):
                x = rand(p.num_src, F, dtype=dtype)
                x[1::5] = x[0]  # ties
                for weighted in (False, True):
                    tag = f"{dtype} F={F} {pname} weighted={weighted}"
                    w = rand(p.num_edges) if weighted else None
                    for fn, ref in forms:
                        if not torch.equal(fn(x, w, p), ref(x, w, p)):
                            fail(f"{fn.__name__} {tag}: not bitwise equal "
                                 "to the plain version")
                    wp = None if w is None else k.pad_edge_weights(p, w)
                    out = k.spmm_max_csr(x, wp, p, weights_padded=True)
                    g = rand(out.shape, dtype=dtype)
                    dmsg, dw = k.segment_max_bwd(x, wp, out, g, p, False,
                                                 True)
                    r_dmsg, r_dw = k.segment_max_bwd_reference(
                        x, wp, out, g, p, False, weighted)
                    if not torch.equal(dmsg, r_dmsg):
                        fail(f"segment_max_bwd {tag}: per-edge cotangents "
                             "not bitwise equal to the plain version")
                    if weighted and p.num_edges:
                        err["segment_max_bwd"] = max(
                            err["segment_max_bwd"], check_close(
                                f"segment_max_bwd dw {tag}", dw, r_dw, 1e-5))
                msg = x[p.arrays(dev)[1].long()]
                for fn, ref in ((k.segment_max_csr,
                                 k.segment_max_csr_reference),
                                (k.segment_min_csr,
                                 k.segment_min_csr_reference)):
                    if not torch.equal(fn(msg, p), ref(msg, p)):
                        fail(f"{fn.__name__} {dtype} F={F} {pname}: not "
                             "bitwise equal to the plain version")
                out = k.segment_max_csr(msg, p)
                g = rand(out.shape, dtype=dtype)
                if not torch.equal(
                        k.segment_max_bwd(msg, None, out, g, p, True,
                                          False)[0],
                        k.segment_max_bwd_reference(msg, None, out, g, p,
                                                    True, False)[0]):
                    fail(f"segment_max_bwd per edge {dtype} F={F} {pname}: "
                         "not bitwise equal")
    print("  forward bitwise equal in every case (f32, bf16; F 7, 40, 128, "
          "256; max, min; gathered with and without weights, per edge; "
          "ties, empty rows, E=0); backward per-edge cotangents bitwise")
    # a winner of -inf (+inf for the min) gives 0, as in the JAX package,
    # and takes no cotangent
    for dtype in (torch.float32, torch.bfloat16):
        x = rand(sparse.num_src, 40, dtype=dtype)
        x[:, 0], x[:, 1] = -np.inf, np.inf
        for fn, ref, c in ((k.spmm_max_csr, k.spmm_max_csr_reference, 0),
                           (k.spmm_min_csr, k.spmm_min_csr_reference, 1)):
            got = fn(x, None, sparse)
            if not (torch.equal(got, ref(x, None, sparse))
                    and bool((got[:, c] == 0).all())):
                fail(f"{fn.__name__} {dtype}: an infinite winner did not "
                     "give 0 as the plain version does")
        out = k.spmm_max_csr(x, None, sparse)
        dmsg = k.segment_max_bwd(x, None, out, rand(out.shape, dtype=dtype),
                                 sparse, False, False)[0]
        if bool((dmsg[:, 0] != 0).any()):
            fail(f"segment_max_bwd {dtype}: a -inf winner took a cotangent")
    print("  infinite winners: 0, bitwise equal to the plain version, no "
          "cotangent (f32, bf16)")
    err["segment_max_bwd"] = max(err["segment_max_bwd"],
                                 max_hub_checks(k, gen, dev)[0])
    hub = hub_plan(k, SEED + 11)

    plan, bf16 = slice_plan, torch.bfloat16
    N, Ns, E = plan.num_nodes, plan.num_src, plan.num_edges
    rowptr, col, _ = plan.arrays(dev)
    timings = {"spmm_max_csr": [], "segment_max_bwd": []}
    for F in (HIDDEN, N_FEAT):  # the widths GraphSAGE's pool layers max
        x = rand(Ns, F, dtype=bf16)
        if not torch.equal(k.spmm_max_csr(x, None, plan),
                           k.spmm_max_csr_reference(x, None, plan)):
            fail(f"slice graph spmm_max_csr F={F}: not bitwise equal")
        row = {"F": F, "form": "gathered", **timing(
            f"spmm_max_csr F={F} bf16 gathered",
            lambda: k.spmm_max_csr(x, None, plan),
            lambda: k.spmm_max_csr_reference(x, None, plan),
            # x, col and rowptr in, out
            nbytes=Ns * F * 2 + E * 4 + (N + 1) * 8 + N * F * 2,
            flops=E * F)}
        # the same gather with an fma in place of the compare
        row["spmm_csr_ms"] = cuda_ms(lambda: k.spmm_csr(x, None, plan))
        print(f"  spmm_csr F={F} bf16 on the same graph: "
              f"{row['spmm_csr_ms']:.4f} ms; the max takes "
              f"{row['ms'] / row['spmm_csr_ms']:.3f} of it")
        timings["spmm_max_csr"].append(row)
    F = HIDDEN
    msg = rand(E, F, dtype=bf16)
    if not torch.equal(k.segment_max_csr(msg, plan),
                       k.segment_max_csr_reference(msg, plan)):
        fail("slice graph segment_max_csr: not bitwise equal")
    timings["spmm_max_csr"].append({"F": F, "form": "per edge", **timing(
        f"segment_max_csr F={F} bf16 per edge",
        lambda: k.segment_max_csr(msg, plan),
        lambda: k.segment_max_csr_reference(msg, plan),
        nbytes=E * F * 2 + (N + 1) * 8 + N * F * 2, flops=E * F,
        # one PyTorch call over rows already in CSR order (empty rows give
        # its identity, not 0: a yardstick of time only)
        library=lambda: torch.segment_reduce(msg, "max", offsets=rowptr))})
    for F in (HIDDEN, N_FEAT):  # the widths GraphSAGE's step takes back
        x = rand(Ns, F, dtype=bf16)
        out = k.spmm_max_csr(x, None, plan)
        g = rand(N, F, dtype=bf16)
        if not torch.equal(
                k.segment_max_bwd(x, None, out, g, plan, False, False)[0],
                k.segment_max_bwd_reference(x, None, out, g, plan, False,
                                            False)[0]):
            fail(f"slice graph segment_max_bwd F={F}: not bitwise equal")
        timings["segment_max_bwd"].append({"F": F, **timing(
            f"segment_max_bwd F={F} bf16",
            lambda: k.segment_max_bwd(x, None, out, g, plan, False, False),
            lambda: k.segment_max_bwd_reference(x, None, out, g, plan,
                                                False, False),
            # x, col, rowptr, out and g in, dmsg out; two compares and a
            # division an element
            nbytes=(Ns * F * 2 + E * 4 + (N + 1) * 8 + 2 * N * F * 2
                    + E * F * 2),
            flops=3 * E * F, plain_iters=3)})
    # the hub graph: one launch and a fold, beside the port's spmm_csr
    # (one launch and csr_fold) on the same graph
    F, N, Ns, E = HIDDEN, hub.num_nodes, hub.num_src, hub.num_edges
    x = rand(Ns, F, dtype=bf16)
    row = {"F": F, "form": "gathered", "graph": "hub", **timing(
        f"spmm_max_csr F={F} bf16 gathered, hub graph",
        lambda: k.spmm_max_csr(x, None, hub),
        lambda: k.spmm_max_csr_reference(x, None, hub),
        nbytes=Ns * F * 2 + E * 4 + (N + 1) * 8 + N * F * 2, flops=E * F)}
    row["spmm_csr_ms"] = cuda_ms(lambda: k.spmm_csr(x, None, hub))
    print(f"  spmm_csr F={F} bf16 on the hub graph: "
          f"{row['spmm_csr_ms']:.4f} ms")
    timings["spmm_max_csr"].append(row)
    out = k.spmm_max_csr(x, None, hub)
    g = rand(N, F, dtype=bf16)
    timings["segment_max_bwd"].append({"F": F, "graph": "hub", **timing(
        f"segment_max_bwd F={F} bf16, hub graph (count, count fold, "
        "backward)",
        lambda: k.segment_max_bwd(x, None, out, g, hub, False, False),
        lambda: k.segment_max_bwd_reference(x, None, out, g, hub, False,
                                            False),
        nbytes=(Ns * F * 2 + E * 4 + (N + 1) * 8 + 2 * N * F * 2
                + E * F * 2),
        flops=3 * E * F, plain_iters=3)})
    # the fold alone, on the hub graph's slots
    _, _, cut_row, cut_ptr, n_slots = hub.split_arrays(dev)
    part = torch.randn(n_slots, F, generator=gen).to(dev)
    folded = torch.empty(N, F, dtype=bf16, device=dev)
    fold = {"ms": cuda_ms(lambda: k.segment_max_fold(part, hub, folded,
                                                     False)),
            **bound(n_slots * F * 4 + cut_row.shape[0] * (F * 2 + 12),
                    n_slots * F),
            "cut_rows": int(cut_row.shape[0]), "slots": n_slots}
    print(f"  segment_max_fold on the hub graph ({fold['cut_rows']} cut "
          f"rows, {n_slots} slots, F={F} bf16): {fold['ms']:.4f} ms, bound "
          f"{fold['bound_ms']:.4f} ms")
    return err, timings, fold


def kernel_resources(families):
    """Print the registers and spills (the build's -Xptxas -v report) of
    every compiled instantiation of each kernel family (a substring of
    its entry's name); returns {family: the most spill bytes, stores plus
    loads, of any of its instantiations}."""
    from gammagl_tpu_torch.ops.cuda._build import load_library
    log = os.path.splitext(load_library()._name)[0] + ".log"
    worst = {f: 0 for f in families}
    family = name = None
    for line in open(log).read().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            family = next((f for f in families if f in name), None)
            continue
        if family is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            worst[family] = max(worst[family], int(m[1]) + int(m[2]))
        if m or "registers" in line:
            print(f"  {name[:96]}: {line.split(':', 1)[-1].strip()}")
    print("  most spill bytes of an instantiation: " + ", ".join(
        f"{f} {b}" for f, b in worst.items()))
    return worst


def hgt_relation():
    """bench.py:185's HGT relation (seed 3): 200,000 sources, 100,000
    destinations, 2,000,000 edges with dst = N_dst * u^1.3."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, HGT_AUTHORS, HGT_WRITES)
    dst = (HGT_PAPERS * (rng.random(HGT_WRITES) ** 1.3)).astype(np.int64)
    return src, dst


def _hgt_inputs(gen, plan, H, D, dtype, dev):
    kv = torch.randn(plan.num_src, 2 * H * D, generator=gen).to(dev, dtype)
    q = (torch.randn(plan.num_nodes, H, D, generator=gen) / D ** 0.5).to(
        dev, dtype)
    g = torch.randn(plan.num_nodes, H * D, generator=gen).to(dev, dtype)
    return kv, q, g


def hgt_check(k, label, plan, H, D, dtype, gen, dev):
    """Forward and backward kernels against the plain versions (the plain
    backward from the kernel's out, m and l); returns the max abs error
    of each."""
    kv, q, g = _hgt_inputs(gen, plan, H, D, dtype, dev)
    out, m, l = k.hgt_forward(kv, q, plan)
    dq, dkv = k.hgt_backward(kv, q, out, g, m, l, plan)
    torch.cuda.synchronize()
    r_out, r_m, r_l = k.hgt_forward_reference(kv, q, plan)
    r_dq, r_dkv = k.hgt_backward_reference(kv, q, out, g, m, l, plan)
    rt = 1e-2 if dtype == torch.bfloat16 else 1e-5
    err = {"hgt_forward": 0.0, "hgt_backward": 0.0}
    for kname, name, got, want, rtol in (
            ("hgt_forward", "out", out, r_out, rt),
            ("hgt_forward", "m", m, r_m, 1e-5),
            ("hgt_forward", "l", l, r_l, 1e-5),
            ("hgt_backward", "dq", dq, r_dq, rt),
            ("hgt_backward", "dk|dv", dkv, r_dkv, rt)):
        err[kname] = max(err[kname],
                         check_close(f"{label} {name}", got, want, rtol))
    return err, (kv, q, g, out, m, l)


def phase_hgt_checks(k):
    phase_start("phase 12: HGT attention kernels vs plain versions on the "
                "card")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 13)
    rng = np.random.default_rng(SEED + 13)
    n_dst, n_src, e = 700, 900, 5000
    dst = 2 * rng.integers(0, 300, e)  # odd rows and the tail: empty
    sparse = k.build_csr_plan(rng.integers(0, n_src, e), dst, n_dst,
                              num_src=n_src)
    none = np.zeros(0, np.int64)
    empty = k.build_csr_plan(none, none, 50, num_src=30)
    for dtype in (torch.float32, torch.bfloat16):
        for H, D in ((2, 64), (4, 64), (8, 32)):
            for pname, p in (("empty rows", sparse), ("E=0", empty)):
                hgt_check(k, f"{dtype} H={H} D={D} {pname}", p, H, D, dtype,
                          gen, dev)
    spills = kernel_resources(("hgt_fwd_kernel", "hgt_bwd_kernel",
                               "flash_fwd_kernel", "segment_max"))
    src, dst = hgt_relation()
    plan = k.build_csr_plan(src, dst, HGT_PAPERS, num_src=HGT_AUTHORS)
    H, D = HGT_HEADS, HIDDEN // HGT_HEADS
    err, (kv, q, g, out, m, l) = hgt_check(
        k, f"bench.py:185 shape bf16 H={H} D={D}", plan, H, D,
        torch.bfloat16, gen, dev)
    N, Ns, E, HD = plan.num_nodes, plan.num_src, plan.num_edges, H * D
    graph_bytes = E * 4 + (N + 1) * 8  # col and rowptr
    timings = {"hgt_forward": [{"H": H, "D": D, **timing(
        f"hgt_forward H={H} D={D} bf16",
        lambda: k.hgt_forward(kv, q, plan),
        lambda: k.hgt_forward_reference(kv, q, plan),
        # kv and q in, out, m and l out; a dot and an axpy an edge and head
        nbytes=Ns * 2 * HD * 2 + N * HD * 2 + graph_bytes + N * HD * 2
        + 2 * N * H * 4,
        flops=4 * E * HD, plain_iters=3)}],
        "hgt_backward": [{"H": H, "D": D, **timing(
            f"hgt_backward H={H} D={D} bf16",
            lambda: k.hgt_backward(kv, q, out, g, m, l, plan),
            lambda: k.hgt_backward_reference(kv, q, out, g, m, l, plan),
            # kv, q, out, g, m and l in; dq and the per-edge dk|dv out;
            # two dots and three axpys an edge and head
            nbytes=Ns * 2 * HD * 2 + 3 * N * HD * 2 + 2 * N * H * 4
            + graph_bytes + N * HD * 2 + E * 2 * HD * 2,
            flops=10 * E * HD, plain_iters=3)}]}
    timings["hgt_forward"][0]["spill_bytes"] = spills["hgt_fwd_kernel"]
    timings["hgt_backward"][0]["spill_bytes"] = spills["hgt_bwd_kernel"]
    return (err, timings, plan, flash_at_hgt_shape(k, plan, gen, dev),
            spills)


def flash_at_hgt_shape(k, plan, gen, dev):
    """The flash kernels as HGT's decomposed train route calls them
    (`flash_softmax_spmm_mh`: per-edge scores and messages in CSR order, no
    a_dst, slope 1, keep in CSR order; H = 4, D = 64, bf16) on the 2M-edge
    relation: held against the plain versions, then timed. Returns
    ({kernel: max abs error}, {kernel: timing row})."""
    H, D = HGT_HEADS, HIDDEN // HGT_HEADS
    err = flash_check(k, f"HGT train shape bf16 H={H} F={D}", plan, H, D,
                      torch.bfloat16, False, True, gen, dev)
    s, _, msg, kp = _flash_inputs(gen, plan, H, D, torch.bfloat16, False,
                                  True, dev)
    args = (s, None, msg, kp)
    out, m, l = k.flash_forward(*args, plan, 1.0, False)
    g = torch.randn(out.shape, generator=gen).to(dev, torch.bfloat16)
    bwd_args = (*args, m, l, out, g, plan, 1.0, False)
    N, E, HD = plan.num_nodes, plan.num_edges, H * D
    # in: the per-edge messages, scores and keep, rowptr; forward out: out,
    # m and l; backward also in: m, l, out and the cotangent, out: ds, dmsg
    # and da
    nbytes = E * HD * 2 + 2 * E * H * 4 + (N + 1) * 8
    timings = {}
    for name, kern, plain, extra, flops in (
            ("flash_forward", lambda: k.flash_forward(*args, plan, 1.0, False),
             lambda: k.flash_forward_reference(*args, plan, 1.0, False),
             N * HD * 2 + 2 * N * H * 4, 2 * E * HD + 6 * E * H),
            ("flash_backward", lambda: k.flash_backward(*bwd_args),
             lambda: k.flash_backward_reference(*bwd_args),
             2 * N * H * 4 + 2 * N * HD * 2 + E * H * 4 + E * HD * 2
             + N * H * 4, 4 * E * HD + 8 * E * H)):
        timings[name] = {"H": H, "F": D, "graph": "hgt relation", **timing(
            f"{name} H={H} F={D} (HGT train shape)", kern, plain,
            nbytes + extra, flops, plain_iters=3)}
    return err, timings


def sage_params():
    """A flax-shaped GraphSAGEModel tree (pool aggregator) from numpy:
    he-normal-scale kernels, small bias."""
    rng = np.random.default_rng(SEED + 14)
    dims = [N_FEAT] + [HIDDEN] * (N_LAYERS - 1) + [N_CLASS]
    tree = {}
    for i in range(N_LAYERS):
        fan_in, out = dims[i], dims[i + 1]
        tree[f"SAGEConv_{i}"] = {
            **{f"Dense_{j}": {"kernel": (rng.normal(size=s) * np.sqrt(
                2.0 / fan_in)).astype(np.float32)} for j, s in enumerate(
                ((fan_in, out), (fan_in, fan_in), (fan_in, out)))},
            "bias": rng.uniform(-0.1, 0.1, out).astype(np.float32)}
    return {"params": tree}


def sage_model(GraphSAGEModel, load_jax_params, dtype=torch.bfloat16):
    model = GraphSAGEModel(hidden_dim=HIDDEN, num_class=N_CLASS,
                           num_layers=N_LAYERS, aggr=SAGE_AGGR,
                           drop_rate=SAGE_DROP, dtype=dtype,
                           in_channels=N_FEAT)
    return load_jax_params(model, sage_params())


def phase_sage_serve(k, GraphSAGEModel, InferenceSession, load_jax_params,
                     plan, x, ei):
    """Every layer's max runs the segment-max kernel: 3 launches a request
    and no other kernel. The plain COO path takes the same max (exact),
    so the logits should agree to 0."""
    phase_start("phase 13: serve GraphSAGE (pool) through InferenceSession")
    sess = InferenceSession(sage_model(GraphSAGEModel, load_jax_params),
                            (x, ei), compute_dtype=torch.bfloat16, plan=plan)
    return serve(k, sess, x, ei, {"spmm_max_csr": N_LAYERS}, "GraphSAGE")


def phase_sage_train(k, common, GraphSAGEModel, load_jax_params, plan, x,
                     ei):
    """Per step: the forward's 3 segment-max launches, and the backward's
    3 segment-max backward launches with 3 SpMMs on the edge-scatter
    plan (every layer's pool map takes a gradient, so every max does).
    Step-0 gradients are held in float32 compute (bf16 orders differ,
    phase 9); the 5 steps run in bf16, dropout 0.5 between layers drawn
    from one generator state on both paths."""
    phase_start("phase 14: train GraphSAGE (pool) against the plain path")
    per_step = {"spmm_max_csr": N_LAYERS, "segment_max_bwd": N_LAYERS,
                "spmm_csr": N_LAYERS}
    grad_err, _ = f32_step0_grads(
        k, "GraphSAGE", lambda: sage_model(GraphSAGEModel, load_jax_params,
                                           None),
        common, per_step, plan, x, ei, train_labels(x))
    launches, losses, step_ms, _, _ = train_phase(
        k, "GraphSAGE", lambda: sage_model(GraphSAGEModel, load_jax_params),
        common, per_step, SAGE_LR, 0.0, plan, x, ei, check_step0=False)
    return launches, losses, step_ms, grad_err


def f32_step0_grads(k, label, make_model, common, per_step, plan, x, ei,
                    labels, plan_key="plan", floor_share=0.0, fkw=None):
    """Step-0 gradients of both paths in float32 compute (the model's or
    the process default), one generator state, launches checked: each
    parameter within F32_GRAD_TOL of its own max |grad|, or of
    ``floor_share`` of the model's largest where its own is below that.
    ``fkw`` goes to both forwards. Returns (the max error, the plain
    path's gradients)."""
    y, mask = labels
    grads = {}
    for path in ("kernel", "plain"):
        model = make_model().to(y.device)
        kw = dropout_rng(model, SEED + 100)
        sync()
        reset_counts(k)
        common.loss_and_grad(model.train(), x, ei, y, mask, **kw,
                             **{plan_key: plan if path == "kernel" else None},
                             **(fkw or {}))
        sync()
        counts = read_counts(k)
        want = every_kernel(per_step if path == "kernel" else {})
        if counts != want:
            fail(f"{label} f32 gradients, {path} path: expected launches "
                 f"{want}, counted {counts}")
        grads[path] = {name: torch.zeros_like(p) if p.grad is None
                       else p.grad for name, p in model.named_parameters()}
    floor = floor_share * max(float(g.abs().max())
                              for g in grads["plain"].values())
    grad_err = 0.0
    for name, want in grads["plain"].items():
        grad_err = max(grad_err, check_close(
            f"f32 step-0 grad {name}", grads["kernel"][name], want, 0.0,
            atol=F32_GRAD_TOL, scale=max(float(want.abs().max()), floor)))
    return grad_err, grads["plain"]


def hgt_graph(HeteroGraph):
    """The typed graph of phases 15-16: papers and authors with 128
    random features, bench.py:185's author -> paper relation and its
    reverse, and paper -> paper citations with dst = N * u^1.5; random
    venue labels, each adding twice its own random normal direction to
    the paper's features so that phase 16's loss falls by MIN_FALL; 85% of
    papers for training (ogbn-mag's train split)."""
    rng = np.random.default_rng(SEED + 15)
    hg = HeteroGraph()
    y = rng.integers(0, HGT_CLASSES, HGT_PAPERS)
    venue = rng.normal(size=(HGT_CLASSES, HGT_FEAT))
    hg["paper"].x = (rng.normal(size=(HGT_PAPERS, HGT_FEAT))
                     + 2 * venue[y]).astype(np.float32)
    hg["author"].x = rng.normal(size=(HGT_AUTHORS, HGT_FEAT)).astype(
        np.float32)
    src, dst = hgt_relation()
    hg[("author", "writes", "paper")].edge_index = np.stack([src, dst])
    hg[("paper", "rev_writes", "author")].edge_index = np.stack([dst, src])
    c_dst = (HGT_PAPERS * rng.random(HGT_CITES) ** 1.5).astype(np.int64)
    hg[("paper", "cites", "paper")].edge_index = np.stack(
        [rng.integers(0, HGT_PAPERS, HGT_CITES), c_dst])
    hg["paper"].y = y
    hg["paper"].train_mask = rng.random(HGT_PAPERS) < 0.855
    hg["paper"].test_mask = ~hg["paper"].train_mask
    return hg


def hgt_model(HGTModel, hg, dtype=torch.bfloat16):
    """HGTModel at bench.py:185's heads with Hu et al.'s hidden width,
    its own init from the seed (the same weights in any dtype)."""
    torch.manual_seed(SEED + 16)
    return HGTModel(hg.metadata(), HGT_HIDDEN, HGT_CLASSES, "paper",
                    heads=HGT_HEADS, num_layers=HGT_LAYERS, dtype=dtype,
                    in_channels=HGT_FEAT)


def phase_hgt_serve(k, common, model, x_dict, ei_dict, plans):
    """The hgt twin's eval forward (`common.predict`), bf16, on window
    plans: every relation takes the fused kernel, 6 hgt_forward launches
    a forward (2 layers x 3 relations) and no other kernel; each held
    against the plain COO route within 3e-2 of max |logit|."""
    phase_start("phase 15: serve HGT (the hgt twin's eval forward) on a "
                "typed graph")
    model = model.to(x_dict["paper"].device)
    common.predict(model, x_dict, ei_dict, plan_dict=plans)  # warm-up
    requests = [{**x_dict, "paper": x_dict["paper"] + r * 1e-3}
                for r in range(N_REQUESTS)]
    counts, lat = serve_requests(
        k, requests,
        lambda xr: common.predict(model, xr, ei_dict, plan_dict=plans),
        lambda xr: common.predict(model, xr, ei_dict),
        {"hgt_forward": 2 * 3}, "HGT", (HGT_PAPERS, HGT_CLASSES))
    prof = profile("hgt_serve", lambda: common.predict(
        model, x_dict, ei_dict, plan_dict=plans))
    return counts, lat, prof


def phase_hgt_train(k, common, HGTModel, hg, x_dict, ei_dict, plans):
    """The hgt twin's step (`common.train_step`, Adam lr 0.005), bf16, with
    HGTConv's attention dropout 0.2 in force: every relation takes the
    decomposed route. Per step: 6 expand and 6 flash forward launches (2
    layers x 3 relations), and 5 each of flash backward, per-edge segment
    sum (the expand's VJP) and SpMM on the edge-scatter plan (the source
    gather's VJP): the last layer's paper -> author relation feeds no
    loss, so nothing flows back through it. The plain path is the COO
    route with the same generator state (the masks are drawn in CSR order
    on both). Step-0 gradients are held in float32 compute."""
    phase_start("phase 16: train HGT (the hgt twin's step) against the plain "
                "path")
    per_step = {"expand_dst_csr": 6, "flash_forward": 6, "flash_backward": 5,
                "segment_sum_csr": 5, "spmm_csr": 5}
    dev = x_dict["paper"].device
    store = hg["paper"]
    labels = (torch.from_numpy(store.y).to(dev),
              torch.from_numpy(store.train_mask).to(dev))
    # HGT's key biases get no gradient but rounding (a softmax ignores a
    # per-row constant): hold small gradients at 0.05 of the largest
    grad_err, _ = f32_step0_grads(
        k, "HGT", lambda: hgt_model(HGTModel, hg, None), common, per_step,
        plans, x_dict, ei_dict, labels, plan_key="plan_dict",
        floor_share=0.05)
    launches, losses, step_ms, _, (state, y, mask, _) = train_phase(
        k, "HGT", lambda: hgt_model(HGTModel, hg), common, per_step, HGT_LR,
        0.0, plans, x_dict, ei_dict, check_step0=False, labels=labels,
        plan_key="plan_dict")
    gen = torch.Generator(device=dev).manual_seed(SEED + 200)
    prof = profile("hgt_train", lambda: common.train_step(
        state, x_dict, ei_dict, y, mask, plan_dict=plans, generator=gen))
    return launches, losses, step_ms, grad_err, prof


def phase_hgt_entry(k, plan):
    """`hgt_flash_packed` as bench.py:185 drives it: the gradient of
    sum(out^2) in kv and q_scaled, bf16. Per call 1 hgt_forward, 1
    hgt_backward and 1 SpMM (dk|dv summed into the source rows). The last
    call's gradients are held against the plain versions within 1e-2 of
    each value plus 1e-2 of the largest (bf16 rounds each edge's dk|dv
    once before the sum on both)."""
    phase_start("phase 17: the hgt_flash_packed entry point, forward and "
                "backward")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 17)
    H, D = HGT_HEADS, HIDDEN // HGT_HEADS
    kv0, q0, _ = _hgt_inputs(gen, plan, H, D, torch.bfloat16, dev)
    sync()
    reset_counts(k)
    for r in range(N_HGT_CALLS):
        kv = (kv0 + r * 1e-3).requires_grad_()
        q = q0.clone().requires_grad_()
        out = k.hgt_flash_packed(kv, q, plan)
        (out.float() ** 2).sum().backward()
    sync()
    counts = read_counts(k)
    want = every_kernel({"hgt_forward": 1, "hgt_backward": 1, "spmm_csr": 1},
                        N_HGT_CALLS)
    print(f"  {N_HGT_CALLS} calls, launches {counts}")
    if counts != want:
        fail(f"hgt entry point: expected launches {want}, counted {counts}")
    kvd, qd, outd = kv.detach(), q.detach(), out.detach()
    _, m, l = k.hgt_forward_reference(kvd, qd, plan)
    r_dq, r_dkv = k.hgt_backward_reference(kvd, qd, outd, 2 * outd.float(),
                                           m, l, plan)
    r_dkv = k.spmm_csr_reference(r_dkv, None, plan.edge_scatter_plan())
    err = max(check_close("entry point dk|dv", kv.grad, r_dkv, 1e-2,
                          atol=1e-2),
              check_close("entry point dq", q.grad.view(r_dq.shape), r_dq,
                          1e-2, atol=1e-2))
    return counts, err


def banded_graph(Graph):
    """The arxiv-shape graph with banded edges: dst uniform, src = dst +
    U[-BAND, BAND] clipped, 128 features; 40 classes in contiguous runs of
    ids (neighbours share a class), each adding twice its own random
    direction to its nodes' features, so GCN training has a signal to
    follow. Node ids are scrambled: `reorder_rcm()` must find the band.
    Returns the scrambled graph with self-loops."""
    rng = np.random.default_rng(SEED + 20)
    dst = rng.integers(0, N_NODES, N_EDGES)
    src = np.clip(dst + rng.integers(-BAND, BAND + 1, N_EDGES), 0,
                  N_NODES - 1)
    y = np.arange(N_NODES) * N_CLASS // N_NODES
    direction = rng.normal(size=(N_CLASS, N_FEAT))
    x = (rng.normal(size=(N_NODES, N_FEAT)) + 2 * direction[y]).astype(
        np.float32)
    perm = rng.permutation(N_NODES)  # new id i holds old node perm[i]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(N_NODES)
    return Graph(x=x[perm], y=y[perm], edge_index=inv[np.stack([src, dst])]
                 ).add_self_loop()


def clustered_graph(Graph):
    """The arxiv-shape graph with CLUSTER_SHARE of its edges inside
    clusters of CLUSTER consecutive ids and the rest uniform: a dense
    diagonal and a scattered tail, with self-loops."""
    rng = np.random.default_rng(SEED + 21)
    n_in = int(CLUSTER_SHARE * N_EDGES)
    base = rng.integers(0, -(-N_NODES // CLUSTER), n_in) * CLUSTER
    src = np.concatenate([
        np.minimum(base + rng.integers(0, CLUSTER, n_in), N_NODES - 1),
        rng.integers(0, N_NODES, N_EDGES - n_in)])
    dst = np.concatenate([
        np.minimum(base + rng.integers(0, CLUSTER, n_in), N_NODES - 1),
        rng.integers(0, N_NODES, N_EDGES - n_in)])
    x = rng.normal(size=(N_NODES, N_FEAT)).astype(np.float32)
    return Graph(x=x, edge_index=np.stack([src, dst])).add_self_loop()


def gcn_weights(ei, n):
    """The first GCN layer's normalised edge weights, in the caller's
    order: deg_src^-1/2 * deg_dst^-1/2."""
    deg = torch.bincount(ei[1], minlength=n).float()
    deg_src = torch.bincount(ei[0], minlength=n).float()
    return deg_src.rsqrt()[ei[0]] * deg.rsqrt()[ei[1]]


def _bp_small_case(rng, n_dst, n_src, e, R):
    """Edges near the diagonal; every third destination block empty."""
    dst = rng.integers(0, n_dst, e)
    dst = dst[(dst // R) % 3 != 1]
    src = np.clip(dst * n_src // n_dst
                  + rng.integers(-2 * R, 2 * R + 1, dst.size), 0, n_src - 1)
    return src, dst


def phase_block_pair_checks(k, plan, csr_plan, w, hybrid):
    """The block-pair forward and dw kernels against their plain versions
    on small cases and on the block pairs of the clustered graph's
    ``hybrid`` plan, with repeats bitwise equal, then on the banded slice
    graph (``plan``, its CSR ``csr_plan`` and GCN weights ``w`` in the
    caller's order), where the forward is timed beside the plain version,
    cuSPARSE (`torch.sparse.mm`) and the port's own `spmm_csr` on the same
    graph. Returns (max abs error by kernel, timings)."""
    phase_start("phase 18: block-pair SpMM and dw kernels vs plain versions "
                "on the card")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 22)
    rng = np.random.default_rng(SEED + 22)
    err = {"spmm_block_pair": 0.0, "block_pair_dw": 0.0}

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    plans = []
    for R, S, ET in ((8, 8, 16), (256, 256, 256)):
        n_dst, n_src = 40 * R // 8 + 3, 50 * R // 8 + 5  # N_src != N_dst
        src, dst = _bp_small_case(rng, n_dst, n_src, 30 * n_dst, R)
        p = k.build_block_pair_plan(src, dst, n_dst, num_src=n_src, R=R, S=S,
                                    ET=ET)
        if not (np.bincount(dst // R, minlength=p.nblocks) == 0).any():
            fail("the small case has no empty destination block")
        plans.append((f"R={R} S={S} ET={ET}", p))
    none = np.zeros(0, np.int64)
    plans.append(("E=0", k.build_block_pair_plan(none, none, 33, num_src=5,
                                                 R=8, S=8, ET=16)))
    n = 300
    dst = rng.integers(0, n, 3000)
    src = np.clip(dst + rng.integers(-6, 7, 3000), 0, n - 1)
    scramble = rng.permutation(n)
    plans.append(("reorder=True", k.build_block_pair_plan(
        scramble[src], scramble[dst], n, R=8, S=8, ET=16, reorder=True)))
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for F in (7, 40, 256):
            for pname, p in plans:
                x = rand(p.num_src, F, dtype=dtype)
                for weighted in (False, True):
                    tag = f"{dtype} F={F} {pname} weighted={weighted}"
                    wv = rand(p.num_edges).abs() if weighted else None
                    got = k.spmm_block_pair(x, wv, p)
                    err["spmm_block_pair"] = max(
                        err["spmm_block_pair"], check_close(
                            f"forward {tag}", got,
                            k.spmm_block_pair_reference(x, wv, p), rtol))
                    if not torch.equal(got, k.spmm_block_pair(x, wv, p)):
                        fail(f"block pair {tag}: repeated launches differ")
                g = rand(p.num_nodes, F, dtype=dtype)
                tag = f"{dtype} F={F} {pname}"
                # dx: the forward kernel on the transpose plan
                tp = p.transpose()
                wv = rand(p.num_edges).abs()
                dx = k.spmm_block_pair(g, wv, tp)
                dw = k.block_pair_dw(x, g, p)
                err["spmm_block_pair"] = max(
                    err["spmm_block_pair"], check_close(
                        f"dx (transpose plan) {tag}", dx,
                        k.spmm_block_pair_reference(g, wv, tp), rtol))
                err["block_pair_dw"] = max(
                    err["block_pair_dw"], check_close(
                        f"dw {tag}", dw,
                        k.block_pair_dw_reference(x, g, p), 1e-5))
                if not (torch.equal(dx, k.spmm_block_pair(g, wv, tp))
                        and torch.equal(dw, k.block_pair_dw(x, g, p))):
                    fail(f"block pair dx or dw {tag}: repeated launches "
                         "differ")
    # the clustered graph's hybrid plan: dense pairs whose blocks are not
    # contiguous, as the clustering order leaves them
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for F in (N_CLASS, HIDDEN):
            x = rand(hybrid.bp.num_src, F, dtype=dtype)
            wv = rand(hybrid.num_edges).abs()
            tag = f"clustered hybrid's block pairs {dtype} F={F}"
            got = k.spmm_block_pair(x, wv, hybrid.bp)
            err["spmm_block_pair"] = max(err["spmm_block_pair"], check_close(
                tag, got, k.spmm_block_pair_reference(x, wv, hybrid.bp),
                rtol))
            if not torch.equal(got, k.spmm_block_pair(x, wv, hybrid.bp)):
                fail(f"{tag}: repeated launches differ")

    # the slice graph: forward at GCN's widths, the dw kernel at F = 256
    N, Ns, E = plan.num_nodes, plan.num_src, plan.num_edges
    n_pairs = plan.pair_src.shape[0]
    # the least the function must read for the graph, whatever the layout:
    # a source column per edge and a CSR row pointer (spmm_csr's yardstick)
    graph_bytes = E * 4 + (N + 1) * 8
    rowptr, col, _ = csr_plan.arrays(dev)
    w_csr = k.pad_edge_weights(csr_plan, w)
    A = torch.sparse_csr_tensor(rowptr, col.long(), w_csr.to(torch.bfloat16),
                                size=(N, Ns))
    timings = {"spmm_block_pair": [], "block_pair_dw": []}
    print(f"  slice graph: {N} nodes, {E} edges, {n_pairs} (dst block, src "
          f"block) pairs, fill {plan.fill_ratio:.4f}")
    for F in (HIDDEN, N_CLASS):
        x = rand(Ns, F, dtype=torch.bfloat16)
        e = check_close(f"slice graph forward bf16 F={F}",
                        k.spmm_block_pair(x, w, plan),
                        k.spmm_block_pair_reference(x, w, plan), 1e-2)
        err["spmm_block_pair"] = max(err["spmm_block_pair"], e)
        row = timing(
            f"spmm_block_pair F={F} bf16", lambda: k.spmm_block_pair(x, w,
                                                                     plan),
            lambda: k.spmm_block_pair_reference(x, w, plan),
            # x, w and the graph in, out
            nbytes=Ns * F * 2 + E * 4 + graph_bytes + N * F * 2,
            flops=2 * E * F, library=lambda: torch.sparse.mm(A, x))
        # timed after the block pair's runs, which bring the card's clocks
        # up from the idle of the graph's host-side build
        csr_ms = cuda_ms(lambda: k.spmm_csr(x, w_csr, csr_plan,
                                            weights_padded=True))
        # where the time goes: weights read through w_perm (the route's),
        # already in the plan's order, and none
        w_plan = w[torch.from_numpy(plan.w_perm).to(dev).long()]
        plan_order_ms = cuda_ms(lambda: k.spmm_block_pair(
            x, w_plan, plan, weights_padded=True))
        unit_ms = cuda_ms(lambda: k.spmm_block_pair(x, None, plan))
        print(f"  the port's spmm_csr on the same graph, F={F} bf16: "
              f"{csr_ms:.4f} ms (block pair {row['ms']:.4f} ms; with the "
              f"weights in the plan's order {plan_order_ms:.4f} ms, unit "
              f"weights {unit_ms:.4f} ms)")
        timings["spmm_block_pair"].append({
            "F": F, "max_abs_err": e, "spmm_csr_ms": csr_ms,
            "plan_order_weights_ms": plan_order_ms, "unit_weights_ms": unit_ms,
            **row})
    F = HIDDEN
    x = rand(Ns, F, dtype=torch.bfloat16)
    # where the time goes, unit weights, F = 256: the same blocks with no
    # edges (zero and write the output) and with the self-loops only (one
    # slab and R edges a block)
    none = np.zeros(0, np.int64)
    ids = np.arange(N)
    for name, p in (("no_edges", k.build_block_pair_plan(none, none, N)),
                    ("self_loops_only", k.build_block_pair_plan(ids, ids,
                                                                N))):
        ms = cuda_ms(lambda: k.spmm_block_pair(x, None, p))
        print(f"  spmm_block_pair F={F} bf16, unit weights, on {name}: "
              f"{ms:.4f} ms")
        timings["spmm_block_pair"][0][f"{name}_ms"] = ms
    g = rand(N, F, dtype=torch.bfloat16)
    e = check_close("slice graph dw bf16 F=256", k.block_pair_dw(x, g, plan),
                    k.block_pair_dw_reference(x, g, plan), 1e-5)
    err["block_pair_dw"] = max(err["block_pair_dw"], e)
    mask = torch.sparse_csr_tensor(rowptr, col.long(),
                                   torch.ones(E, device=dev,
                                              dtype=torch.bfloat16),
                                   size=(N, Ns))
    timings["block_pair_dw"].append({"F": F, "max_abs_err": e, **timing(
        f"block_pair_dw F={F} bf16", lambda: k.block_pair_dw(x, g, plan),
        lambda: k.block_pair_dw_reference(x, g, plan),
        # x, g and the graph in, dw out
        nbytes=Ns * F * 2 + N * F * 2 + graph_bytes + E * 4, flops=2 * E * F,
        library=lambda: torch.sparse.sampled_addmm(mask, g, x.t(),
                                                   beta=0.0))})
    return err, timings


def gcn_model(GCNModel, load_jax_params, dtype=torch.bfloat16):
    model = GCNModel(hidden_dim=HIDDEN, num_class=N_CLASS,
                     num_layers=N_LAYERS, drop_rate=GCN_DROP, dtype=dtype)
    return load_jax_params(model, random_params())


def phase_gcn_plan_serve(k, title, name, GCNModel, InferenceSession,
                         load_jax_params, plan, x, ei, per_request,
                         csr_plan=None):
    """GCN served through `InferenceSession` with an `auto_plan()` plan:
    N_REQUESTS requests held against the plain COO path, the launches a
    request, then a trace of 3 more. With ``csr_plan``, the same requests
    through the graph's CSR plan too (the other side of `auto_plan`'s
    choice); returns their latencies as well."""
    phase_start(title)
    sess = InferenceSession(gcn_model(GCNModel, load_jax_params), (x, ei),
                            compute_dtype=torch.bfloat16, plan=plan)
    if sess.device.type != "cuda":
        fail(f"InferenceSession's default device is {sess.device}")
    counts, lat = serve(k, sess, x, ei, per_request, name)
    prof = profile(name.replace(" ", "_"), lambda: sess(x, ei))
    csr_lat = None
    if csr_plan is not None:
        csr_sess = InferenceSession(sess.model, (x, ei),
                                    compute_dtype=torch.bfloat16,
                                    plan=csr_plan)
        _, csr_lat = serve(k, csr_sess, x, ei, {"spmm_csr": N_LAYERS},
                           f"{name} (CSR plan)")
    return counts, lat, prof, csr_lat


def phase_gcn_banded_train(k, common, GCNModel, load_jax_params, plan, x,
                           ei, y):
    """The gcn twin's step (`common.train_step`: Adam lr 0.01 with decayed
    weights 5e-4, dropout 0.5 drawn from one generator state on both
    paths) on the banded graph with its `BlockPairPlan`, against the plain
    COO path. A forward launches the block-pair kernel 3 times and its
    backward 3 more (dx on the transpose plan; the weights need no
    gradient): checked once apart, then 6 a step. The two paths' dropout
    masks are compared once. Step-0 gradients are held in float32
    compute; the 5 steps run in bf16."""
    phase_start("phase 20: train GCN (the gcn twin's step) on the banded "
                "graph against the plain path")
    per_step = {"spmm_block_pair": 2 * N_LAYERS}
    rng = np.random.default_rng(SEED + 23)
    mask = torch.from_numpy(rng.random(x.shape[0]) < 0.54).to(x.device)
    model = gcn_model(GCNModel, load_jax_params).to(x.device).train()
    sync()
    reset_counts(k)
    loss = torch.nn.functional.cross_entropy(
        model(x, ei, plan=plan)[mask], y[mask])
    sync()
    fwd = read_counts(k)["spmm_block_pair"]
    loss.backward()
    sync()
    both = read_counts(k)
    print(f"  one step: {fwd} block-pair launches in the forward, "
          f"{both['spmm_block_pair'] - fwd} in the backward; {both}")
    if (fwd, both) != (N_LAYERS, every_kernel(per_step)):
        fail(f"GCN step launches: forward {fwd}, in all {both}")
    # nn.Dropout draws from the default generators, seeded alike before
    # each path: its keep masks must agree wherever both inputs are nonzero
    seen = {"kernel": [], "plain": []}
    for path, out in seen.items():
        hook = model.drop.register_forward_hook(
            lambda m, i, o, out=out: out.append((i[0] != 0, o != 0)))
        with torch.no_grad():
            model(x, ei, plan=plan if path == "kernel" else None,
                  **dropout_rng(model, SEED + 100))
        hook.remove()
    for j, ((live_k, kept_k), (live_p, kept_p)) in enumerate(zip(
            seen["kernel"], seen["plain"])):
        live = live_k & live_p
        differ = int((live & (kept_k != kept_p)).sum())
        print(f"  dropout {j}: keep masks of the two paths differ at "
              f"{differ} of {int(live.sum())} entries nonzero in both")
        if differ:
            fail("the two paths drew different dropout masks")
    del seen
    grad_err, _ = f32_step0_grads(
        k, "GCN", lambda: gcn_model(GCNModel, load_jax_params, None), common,
        per_step, plan, x, ei, (y, mask))
    launches, losses, step_ms, _, (state, _, _, _) = train_phase(
        k, "GCN", lambda: gcn_model(GCNModel, load_jax_params), common,
        per_step, GCN_LR, GCN_L2, plan, x, ei, check_step0=False,
        labels=(y, mask))
    prof = profile("gcn_banded_train", lambda: common.train_step(
        state, x, ei, y, mask, plan=plan))
    return launches, losses, step_ms, grad_err, prof


def phase_block_pair_entry(k, plan, w):
    """`spmm_block_pair` as the JAX package's test_block_pair_grads drives
    it: the gradient of sum(out^2) in x and w (bf16 x, F = 256, the banded
    graph's GCN weights). Per call 1 forward, 1 dx (the same kernel on the
    transpose plan) and 1 dw launch. The last call's gradients are held
    against the plain versions on the same cotangent, 2 * out (bf16, as
    autograd hands it over): dx within one bf16 rounding, dw within 1e-5.
    (The plain forward's own autograd is no yardstick in bf16: it adds the
    per-edge bf16 cotangents of x in bf16.)"""
    phase_start("phase 22: the spmm_block_pair entry point, forward and "
                "backward")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 25)
    x0 = torch.randn(plan.num_src, HIDDEN, generator=gen).to(
        dev, torch.bfloat16)
    sync()
    reset_counts(k)
    for r in range(N_BP_CALLS):
        x = (x0 + r * 1e-3).requires_grad_()
        wr = w.clone().requires_grad_()
        out = k.spmm_block_pair(x, wr, plan)
        (out.float() ** 2).sum().backward()
    sync()
    counts = read_counts(k)
    want = every_kernel({"spmm_block_pair": 2, "block_pair_dw": 1},
                        N_BP_CALLS)
    print(f"  {N_BP_CALLS} calls, launches {counts}")
    if counts != want:
        fail(f"block-pair entry point: expected launches {want}, counted "
             f"{counts}")
    g = (2 * out.detach().float()).to(torch.bfloat16)
    if not torch.isfinite(out).all():
        fail("block-pair entry point: non-finite output")
    err = {"spmm_block_pair": check_close(
               "entry point dx", x.grad,
               k.spmm_block_pair_reference(g, w, plan.transpose()), 1e-2),
           "block_pair_dw": check_close(
               "entry point dw", wr.grad,
               k.block_pair_dw_reference(x.detach(), g, plan), 1e-5)}
    return counts, err


def phase_acc_checks(k):
    """`spmm_csr_acc` against its plain version: f32 and bf16, F in {7, 40,
    128, 256}, prev None, separate and in place, empty rows (bitwise prev),
    N_src != N_dst, E = 0 (out == prev bitwise), a row-slice x, repeats
    bitwise equal. Returns the max abs error."""
    phase_start("phase 23: accumulating CSR SpMM kernel vs plain version on "
                "the card")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 23)
    rng = np.random.default_rng(SEED + 23)
    n_dst, n_src, e = 1000, 1500, 6000
    dst = 2 * rng.integers(0, 450, e)  # odd rows and the tail: empty
    sparse = k.build_csr_plan(rng.integers(0, n_src, e), dst, n_dst,
                              num_src=n_src)
    none = np.zeros(0, np.int64)
    empty = k.build_csr_plan(none, none, 50, num_src=30)
    bare = torch.from_numpy(np.diff(sparse.rowptr) == 0).to(dev)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    err = 0.0
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for F in (7, 40, 128, 256):
            x, w, prev = rand(n_src, F, dtype=dtype), rand(e), rand(
                n_dst, F, dtype=dtype)
            for mode in ("prev None", "prev separate", "in place"):
                p = None if mode == "prev None" else prev.clone()
                counter = k.spmm_csr if p is None else k.spmm_csr_acc
                before = counter.launches
                got = k.spmm_csr_acc(x, w, sparse, prev=p,
                                     out=p if mode == "in place" else None)
                sync()
                if counter.launches != before + 1:
                    fail(f"spmm_csr_acc {mode}: launches not counted")
                if mode == "in place" and got.data_ptr() != p.data_ptr():
                    fail("spmm_csr_acc in place wrote elsewhere")
                want = k.spmm_csr_acc_reference(
                    x, w, sparse, prev=None if p is None else prev)
                err = max(err, check_close(f"{dtype} F={F} {mode}", got,
                                           want, rtol))
                if p is not None and not torch.equal(got[bare], prev[bare]):
                    fail(f"spmm_csr_acc {dtype} F={F} {mode}: rows without "
                         "edges are not prev bit for bit")
                again = k.spmm_csr_acc(x, w, sparse, prev=None if p is None
                                       else prev)
                if not torch.equal(got, again):
                    fail(f"spmm_csr_acc {dtype} F={F} {mode}: repeats differ")
            pe = rand(50, F, dtype=dtype)
            if not torch.equal(k.spmm_csr_acc(rand(30, F, dtype=dtype),
                                              rand(0), empty, prev=pe), pe):
                fail(f"spmm_csr_acc {dtype} F={F} E=0: out != prev")
        table = rand(3 * n_src, 256, dtype=dtype)
        xs = table[n_src:2 * n_src]  # a row slice: a pointer offset
        w, prev = rand(e), rand(n_dst, 256, dtype=dtype)
        err = max(err, check_close(
            f"{dtype} F=256 row-slice x",
            k.spmm_csr_acc(xs, w, sparse, prev=prev),
            k.spmm_csr_acc_reference(xs, w, sparse, prev=prev), rtol))
    # hub rows: items that own their rows start from prev, the fold starts
    # a cut row from prev; in place too
    hub = hub_plan(k, SEED + 23)
    hub_bare = torch.from_numpy(np.diff(hub.rowptr) == 0).to(dev)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for F in (7, 40, 128, 256):
            x = exact(gen, hub.num_src, F).to(dev, dtype)
            w = exact(gen, hub.num_edges, weights=True).to(dev)
            prev = exact(gen, hub.num_nodes, F).to(dev, dtype)
            want = k.spmm_csr_acc_reference(x, w, hub, prev=prev)

            def keeps_prev(got, tag):
                if not torch.equal(got[hub_bare], prev[hub_bare]):
                    fail(f"hub spmm_csr_acc {tag}: rows without edges are "
                         "not prev bit for bit")

            tag = f"{dtype} F={F}"
            err = max(err, hub_check(
                k, f"spmm_csr_acc {tag} prev separate", k.spmm_csr_acc,
                lambda: k.spmm_csr_acc(x, w, hub, prev=prev), want, rtol,
                same=lambda got: keeps_prev(got, tag)))
            run = prev.clone()

            def in_place():
                run.copy_(prev)
                return k.spmm_csr_acc(x, w, hub, prev=run, out=run).clone()

            err = max(err, hub_check(
                k, f"spmm_csr_acc {tag} in place", k.spmm_csr_acc, in_place,
                want, rtol, same=lambda got: keeps_prev(got, tag)))
    print("  rows without edges keep prev bitwise, E=0 gives prev, repeats "
          "bitwise equal, in place writes prev (the hub graph too)")
    return err


def papers_shard(k):
    """The papers twin's synthetic shard at PAPERS_SCALE with self-loops,
    its GCN norms, and its planned partition of one part with
    `auto_src_blocks` source blocks; host seconds of each step."""
    from gammagl_tpu_torch.examples import papers100m_trainer as papers
    from gammagl_tpu_torch.parallel import (auto_src_blocks,
                                            build_halo_partition_planned)
    from gammagl_tpu_torch.utils import calc_gcn_norm_np
    t0 = time.perf_counter()
    ei0, x, y, train, val, c = papers.synthetic_papers(PAPERS_SCALE)
    n = x.shape[0]
    ei = np.concatenate([ei0, np.tile(np.arange(n, dtype=np.int64), (2, 1))],
                        1)
    w = calc_gcn_norm_np(ei, n)
    t_gen = time.perf_counter() - t0
    nsb = auto_src_blocks(n, max(x.shape[1], HIDDEN), torch.bfloat16)
    t0 = time.perf_counter()
    part = build_halo_partition_planned(ei, n, 1, w, num_src_blocks=nsb)
    t_part = time.perf_counter() - t0
    print(f"  papers shard: {n} nodes, {ei.shape[1]} edges with self-loops, "
          f"{c} classes; generated in {t_gen:.2f} s; planned partition "
          f"(num_src_blocks {nsb}: {len(part.interior)} interior plans, "
          f"transpose {len(part.transpose.interior)}) built in "
          f"{t_part:.2f} s")
    if nsb < 2 or len(part.interior) < nsb or len(
            part.transpose.interior) < nsb:
        fail(f"the papers shard has {nsb} source blocks and "
             f"{len(part.interior)} / {len(part.transpose.interior)} "
             "interior plans: the accumulating chain would not run")
    return {"ei": ei, "w": w, "x": x, "y": y, "train": train, "c": c,
            "part": part, "nsb": nsb, "t_part": t_part, "t_gen": t_gen,
            "ei0": ei0, "val": val}


def tier_launches(part):
    """Kernel launches of one call of the planned tier on ``part`` (one
    part): block 0 is `spmm_csr`, every later block with edges
    `spmm_csr_acc` (the boundary class is empty with one part), and each
    of those plans with cut rows one fold."""
    run = [part.interior[0][0]] + [blk[0] for blk in part.interior[1:]
                                   if blk[0].num_edges]
    return {"spmm_csr": 1, "spmm_csr_acc": len(run) - 1,
            "csr_fold": sum(1 for p in run if p.row_split().cut_row.size)}


def split_at(k, plan, K):
    """``plan`` with its work items cut at K edges in place of ROW_SPLIT
    (the same arrays; a measurement of the choice of K)."""
    other = k.CSRPlan(plan.rowptr, plan.col, plan.perm, plan.num_nodes,
                      plan.num_src, plan.num_edges)
    other._placed = plan._placed
    other._split = {k.ROW_SPLIT: k.build_row_split(plan.rowptr, K)}
    return other


def phase_papers_tier(k, shard):
    """The planned tier (forward and transpose) against the port's
    single-plan `spmm_csr` on the same graph, bf16 F = 256, with its exact
    launches, and both directions timed beside the single plan's; then
    `spmm_csr_acc` timed on one interior block at F = 256 and 128.
    Returns (launches, max error, timings, the directions' times)."""
    from gammagl_tpu_torch.parallel import make_halo_spmm_planned_pair
    phase_start("phase 24: the planned halo tier on the papers shard vs one "
                "CSR plan")
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    part = shard["part"]
    N = part.rows_per
    ei, w = shard["ei"], shard["w"]
    t0 = time.perf_counter()
    single = shard["single"] = k.build_csr_plan(ei[0], ei[1], N, num_src=N)
    print(f"  single CSR plan of the whole graph in "
          f"{time.perf_counter() - t0:.2f} s")
    w_single = torch.from_numpy(w[single.perm]).to(dev)
    tp = single.transpose()
    w_single_t = w_single[tp.arrays(dev)[2]]
    gen = torch.Generator().manual_seed(SEED + 24)
    x = torch.randn(N, HIDDEN, generator=gen).to(dev, bf16)
    g = torch.randn(N, HIDDEN, generator=gen).to(dev, bf16)
    spmm, spmm_t = make_halo_spmm_planned_pair(part)
    want_calls = {"forward": tier_launches(part),
                  "transpose": tier_launches(part.transpose)}
    launches = every_kernel({})
    err = 0.0
    for label, fn, inp, plan, wp in (
            ("forward", spmm, x, single, w_single),
            ("transpose", spmm_t, g, tp, w_single_t)):
        sync()
        reset_counts(k)
        out = fn(inp)
        sync()
        counts = read_counts(k)
        if counts != every_kernel(want_calls[label]):
            fail(f"papers tier {label}: expected launches "
                 f"{want_calls[label]}, counted {counts}")
        for name in launches:
            launches[name] += counts[name]
        want = k.spmm_csr(inp, wp, plan, weights_padded=True)
        err = max(err, check_close(f"tier {label} vs one plan bf16 F=256",
                                   out, want, 0.0, atol=3e-2))
    print(f"  launches a call: forward {want_calls['forward']}, transpose "
          f"{want_calls['transpose']}")
    # where the tier's time goes: each direction against one plan of the
    # whole graph; the transpose's rows are the generator's zipf sources
    indeg = np.bincount(ei[0], minlength=N)
    calls = {"tier_forward_ms": cuda_ms(lambda: spmm(x), iters=3, warmup=1),
             "tier_transpose_ms": cuda_ms(lambda: spmm_t(g), iters=3,
                                          warmup=1),
             "one_plan_forward_ms": cuda_ms(lambda: k.spmm_csr(
                 x, w_single, single, weights_padded=True), iters=3,
                 warmup=1),
             "one_plan_transpose_ms": cuda_ms(lambda: k.spmm_csr(
                 g, w_single_t, tp, weights_padded=True), iters=3, warmup=1),
             "transpose_max_row_edges": int(indeg.max()),
             "forward_max_row_edges": int(np.diff(single.rowptr).max())}
    split = tp.row_split()
    calls.update({
        "transpose_items": int(split.item_row.shape[0]),
        "transpose_cut_rows": int(split.cut_row.shape[0]),
        "transpose_slots": int(split.cut_ptr[-1]),
        "forward_cut_rows": int(single.row_split().cut_row.shape[0])})
    # the same function through one PyTorch call (cuSPARSE, bf16 CSR)
    At = torch.sparse_csr_tensor(tp.arrays(dev)[0], tp.arrays(dev)[1].long(),
                                 w_single_t.to(bf16), size=(N, N))
    calls["one_plan_transpose_library_ms"] = library_ms(
        "torch.sparse.mm, one-plan transpose", lambda: torch.sparse.mm(At, g))
    # the choice of K: the one-plan transpose with its rows cut at other K
    for K in SPLIT_SWEEP:
        other = split_at(k, tp, K)
        calls[f"one_plan_transpose_ms_K{K}"] = cuda_ms(
            lambda: k.spmm_csr(g, w_single_t, other, weights_padded=True),
            iters=3, warmup=1)
    print("  bf16 F=256 a call: " + ", ".join(
        f"{name} {v:.4f}" if isinstance(v, float) else f"{name} {v}"
        for name, v in calls.items()))
    # the fold alone, on the one-plan transpose's slots
    item_ptr, meta, cut_row, cut_ptr, n_slots = tp.split_arrays(dev)
    part_buf = torch.randn(n_slots, HIDDEN, generator=gen).to(dev)
    folded = torch.empty(N, HIDDEN, dtype=bf16, device=dev)
    fold = {"ms": cuda_ms(lambda: k.csr_fold(part_buf, cut_row, cut_ptr,
                                             None, folded)),
            **bound(n_slots * HIDDEN * 4 + cut_row.shape[0] * (
                HIDDEN * 2 + 12), n_slots * HIDDEN),
            "cut_rows": int(cut_row.shape[0]), "slots": n_slots}
    print(f"  csr_fold on the one-plan transpose ({fold['cut_rows']} cut "
          f"rows, {n_slots} slots, F={HIDDEN} bf16): {fold['ms']:.4f} ms, "
          f"bound {fold['bound_ms']:.4f} ms")

    # one interior block of the shard: x's rows in its span, prev the
    # running sum of the rows
    lo, hi = part.src_spans[1]
    plan = part.interior[1][0]
    wb = torch.from_numpy(part.interior_w[1][0]).to(dev)
    Ns, E = hi - lo, plan.num_edges
    rowptr, col, _ = plan.arrays(dev)
    A = torch.sparse_csr_tensor(rowptr, col.long(), wb.to(bf16),
                                size=(N, Ns))
    timings = []
    for F in (HIDDEN, N_FEAT):
        xb = torch.randn(Ns, F, generator=gen).to(dev, bf16)
        prev = torch.randn(N, F, generator=gen).to(dev, bf16)
        run = prev.clone()
        timings.append({"F": F, "block": 1, "E": E, **timing(
            f"spmm_csr_acc F={F} bf16, interior block 1 ({E} edges, "
            f"{Ns} source rows)",
            lambda: k.spmm_csr_acc(xb, wb, plan, prev=run,
                                   weights_padded=True, out=run),
            lambda: k.spmm_csr_acc_reference(xb, wb, plan, prev=prev,
                                             weights_padded=True),
            # x's rows in the span, w and col, the row pointer, prev read
            # and out written
            nbytes=Ns * F * 2 + E * 8 + (N + 1) * 8 + 2 * N * F * 2,
            flops=2 * E * F, plain_iters=3,
            library=lambda: torch.addmm(prev, A, xb))})
    # the transpose's interior block with the most edges in one row (the
    # hub's share of it): where one warp a row lost to torch.addmm
    tpart = part.transpose
    hb = max(range(len(tpart.interior)), key=lambda b: int(np.diff(
        tpart.interior[b][0].rowptr).max()))
    lo, hi = tpart.src_spans[hb]
    plan = tpart.interior[hb][0]
    wb = torch.from_numpy(tpart.interior_w[hb][0]).to(dev)
    Ns, E = hi - lo, plan.num_edges
    rowptr, col, _ = plan.arrays(dev)
    A = torch.sparse_csr_tensor(rowptr, col.long(), wb.to(bf16),
                                size=(N, Ns))
    split = plan.row_split()
    for F in (N_FEAT, HIDDEN):
        xb = torch.randn(Ns, F, generator=gen).to(dev, bf16)
        prev = torch.randn(N, F, generator=gen).to(dev, bf16)
        run = prev.clone()
        check_close(f"transpose block {hb} F={F} vs plain",
                    k.spmm_csr_acc(xb, wb, plan, prev=prev,
                                   weights_padded=True),
                    k.spmm_csr_acc_reference(xb, wb, plan, prev=prev,
                                             weights_padded=True), 1e-2)
        timings.append({"F": F, "transpose_block": hb, "E": E,
                        "max_row_edges": int(np.diff(plan.rowptr).max()),
                        "cut_rows": int(split.cut_row.shape[0]), **timing(
            f"spmm_csr_acc F={F} bf16, transpose interior block {hb} ({E} "
            f"edges, {Ns} source rows, largest row "
            f"{int(np.diff(plan.rowptr).max())} edges, "
            f"{split.cut_row.shape[0]} cut rows)",
            lambda: k.spmm_csr_acc(xb, wb, plan, prev=run,
                                   weights_padded=True, out=run),
            lambda: k.spmm_csr_acc_reference(xb, wb, plan, prev=prev,
                                             weights_padded=True),
            nbytes=Ns * F * 2 + E * 8 + (N + 1) * 8 + 2 * N * F * 2,
            flops=2 * E * F, plain_iters=3,
            library=lambda: torch.addmm(prev, A, xb))})
    return launches, err, timings, calls, fold


def papers_plain_step(ei, w, rows, num_layers, dtype):
    """The plain path of the papers GCN: the port's COO `spmm` over the
    whole graph, autograd, the recipe's loss (f32 cross-entropy over the
    masked rows). Rows enter `spmm` in float32, which its messages are
    formed in anyway, so autograd sums their cotangents in float32 too (a
    bf16 gather would add them in bf16: the kernel path's dx is summed in
    f32)."""
    from gammagl_tpu_torch.ops import spmm

    def forward(p, x):
        h = x.to(dtype)
        for i in range(num_layers):
            a = spmm(ei, w, h.float(), num_nodes=rows).to(dtype)
            h = a @ p[f"w{i}"].to(dtype) + p[f"b{i}"].to(dtype)
            if i < num_layers - 1:
                h = torch.relu(h)
        return h

    def loss_and_grads(p, x, y, mask):
        m = mask.float()
        ls = torch.nn.functional.cross_entropy(forward(p, x).float(),
                                               y.long(), reduction="none")
        loss = (ls * m).sum() / m.sum().clamp_min(1.0)
        return loss.detach(), dict(zip(p, torch.autograd.grad(
            loss, list(p.values()))))

    return forward, loss_and_grads


def phase_papers_train(k, shard):
    """N_STEPS steps of the twin's staged step (bf16) against the plain
    COO path with the same parameters and AdamW; f32 step-0 gradients;
    launches a step; a trace of 3 more steps. Returns (launches, losses,
    step ms, f32 gradient error, profile, edges a step)."""
    from gammagl_tpu_torch.parallel import (make_partitioned_gcn_train_staged,
                                            shard_nodes)
    phase_start("phase 25: train GCN on the papers shard (the twin's staged "
                "step) against the plain COO path")
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    part, c = shard["part"], shard["c"]
    rows = part.rows_per
    ys = shard_nodes(shard["y"], part, device=dev)
    ms = shard_nodes(shard["train"].astype(np.float32), part, device=dev)
    ei = torch.from_numpy(shard["ei"]).to(dev)
    w = torch.from_numpy(shard["w"]).to(dev)
    f = shard["x"].shape[1]
    fwd_calls = {name: PAPERS_LAYERS * n
                 for name, n in tier_launches(part).items()}
    per_step = {name: fwd_calls[name] + (PAPERS_LAYERS - 1) * n
                for name, n in tier_launches(part.transpose).items()}
    print(f"  launches a step: {per_step} ({PAPERS_LAYERS} tier calls "
          f"forward, {PAPERS_LAYERS - 1} on the transpose; a_i is kept from "
          "the forward, not recomputed)")

    # float32 step-0 gradients of both paths
    x32 = shard_nodes(shard["x"], part, device=dev, dtype=torch.float32)
    params, _, step, _ = make_partitioned_gcn_train_staged(
        part, f, HIDDEN, c, num_layers=PAPERS_LAYERS,
        compute_dtype=torch.float32, learning_rate=PAPERS_LR, device=dev)
    reset_counts(k)
    _, g_kernel = step.loss_and_grads(params, x32, ys, ms)
    sync()
    if read_counts(k) != every_kernel(per_step):
        fail(f"papers f32 gradients: expected {per_step}, counted "
             f"{read_counts(k)}")
    pp = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
    _, plain_grads = papers_plain_step(ei, w, rows, PAPERS_LAYERS,
                                       torch.float32)
    _, g_plain = plain_grads(pp, x32, ys, ms)
    grad_err = 0.0
    for name, want in g_plain.items():
        behind_relu = int(name[1:]) < PAPERS_LAYERS - 1
        grad_err = max(grad_err, check_close(
            f"f32 step-0 grad {name}", g_kernel[name], want, 0.0,
            atol=F32_RELU_GRAD_TOL if behind_relu else F32_GRAD_TOL))
    del x32, g_kernel, g_plain

    xs = shard_nodes(shard["x"], part, device=dev, dtype=bf16)
    params, opt, step, eval_logits = make_partitioned_gcn_train_staged(
        part, f, HIDDEN, c, num_layers=PAPERS_LAYERS, compute_dtype=bf16,
        learning_rate=PAPERS_LR, device=dev)
    pp = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
    popt = torch.optim.AdamW(list(pp.values()), lr=PAPERS_LR,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    plain_fwd, plain_grads = papers_plain_step(ei, w, rows, PAPERS_LAYERS,
                                               bf16)
    with torch.no_grad():
        got, want = eval_logits(params, xs), plain_fwd(pp, xs).float()
    if got.shape != (rows, c):
        fail(f"papers eval logits shape {tuple(got.shape)}")
    check_close("eval logits at init vs plain bf16", got, want, 0.0,
                atol=3e-2)
    losses = {"kernel": [], "plain": []}
    step_ms = {"kernel": [], "plain": []}
    launches = every_kernel({})
    for i in range(N_STEPS):
        sync()
        reset_counts(k)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, xs, ys, ms)
        losses["kernel"].append(float(loss))
        sync()
        step_ms["kernel"].append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(k)
        if counts != every_kernel(per_step):
            fail(f"papers step {i}: expected launches {per_step}, counted "
                 f"{counts}")
        for name in launches:
            launches[name] += counts[name]
        reset_counts(k)
        t0 = time.perf_counter()
        loss, grads = plain_grads(pp, xs, ys, ms)
        for name, t in pp.items():
            t.grad = grads[name]
        popt.step()
        popt.zero_grad(set_to_none=True)
        losses["plain"].append(float(loss))
        sync()
        step_ms["plain"].append((time.perf_counter() - t0) * 1e3)
        if any(read_counts(k).values()):
            fail(f"the plain path launched kernels: {read_counts(k)}")
        lk, lp = losses["kernel"][-1], losses["plain"][-1]
        print(f"  step {i}: loss kernel {lk:.5f}, plain {lp:.5f}; "
              f"{step_ms['kernel'][-1]:.2f} ms kernel path, "
              f"{step_ms['plain'][-1]:.2f} ms plain path")
        if not np.isfinite(lk) or abs(lk - lp) > LOSS_TOL * abs(lp):
            fail(f"papers step {i}: loss {lk} vs plain {lp}")
    if not losses["kernel"][-1] < (1 - MIN_FALL) * losses["kernel"][0]:
        fail(f"papers: loss did not fall by {MIN_FALL:.0%}: "
             f"{losses['kernel']}")
    del pp, popt
    prof = profile("papers_train",
                   lambda: step(params, opt, xs, ys, ms))
    E = int(shard["ei"].shape[1])
    med = float(np.median(step_ms["kernel"][1:]))
    print(f"  papers train step (steps 1-{N_STEPS - 1}): median {med:.2f} ms "
          f"kernel path ({E / med * 1e3:.4e} edges/s), "
          f"{np.median(step_ms['plain'][1:]):.2f} ms plain path")
    return launches, losses, step_ms, grad_err, prof, E


def flat_typed_graph(k, simplehgn_trainer, hg, dev):
    """The typed graph of phases 15-16 flattened to one node set by the
    simplehgn twin's `typed_graph` (papers first, then authors; edge type
    t the t-th relation), its CSR plan, and the papers' venues and train
    mask extended over the authors with the mask off. Returns (tensors on
    the card, the plan)."""
    t0 = time.perf_counter()
    d = simplehgn_trainer.typed_graph(hg)
    n = d["x"].shape[0]
    plan = k.build_csr_plan(d["edge_index"][0], d["edge_index"][1], n)
    if plan.row_split().cut_row.shape[0]:
        fail("the flattened typed graph has rows cut into work items")
    y, mask = np.zeros(n, np.int64), np.zeros(n, bool)
    y[:HGT_PAPERS], mask[:HGT_PAPERS] = d["y"], d["train_mask"]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    print(f"  flattened typed graph: {n} nodes, {plan.num_edges} edges in "
          f"{d['num_relations']} types, longest row "
          f"{int(np.diff(plan.rowptr).max())} edges, built in "
          f"{time.perf_counter() - t0:.2f} s")
    return {"x": put(d["x"]), "ei": put(d["edge_index"]),
            "fkw": {"edge_type": put(d["edge_type"])},
            "labels": (put(y), put(mask)), "R": d["num_relations"],
            "n": n}, plan


def typed_kernel_timings(k, plan):
    """Row 1 at SimpleHGN's shape (one head's f32 columns, F = 64, weighted
    by that head's attention), row 4 at RGCN's (f32 per-edge rows, C = 64
    and its class width C = 349) and row 9 at RGCN's class width (the
    backward of its layer-2 segment sum: C = 349 f32, rows of 1396 bytes)
    on the flattened typed graph, each held against its plain version
    (the expand bitwise) and timed beside cuSPARSE's SpMM,
    `segment_reduce`, or `repeat_interleave` and `index_select`. Returns
    (max abs error by kernel, timing rows by kernel)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    N, Ns, E = plan.num_nodes, plan.num_src, plan.num_edges
    rowptr, col, _ = plan.arrays(dev)
    F, C, CL = SHGN_HIDDEN, RGCN_HIDDEN, HGT_CLASSES
    x = torch.randn(Ns, F, generator=gen, device=dev)
    w = torch.rand(E, generator=gen, device=dev)
    err = {"spmm_csr": check_close(
        f"typed graph spmm_csr F={F} f32", k.spmm_csr(
            x, w, plan, weights_padded=True), k.spmm_csr_reference(
            x, w, plan, weights_padded=True), 1e-5)}
    A = torch.sparse_csr_tensor(rowptr, col.long(), w, size=(N, Ns))
    rows = {"spmm_csr": [{"F": F, "graph": "typed", "dtype": "float32",
                          "max_abs_err": err["spmm_csr"], **timing(
        f"spmm_csr F={F} f32, typed graph",
        lambda: k.spmm_csr(x, w, plan, weights_padded=True),
        lambda: k.spmm_csr_reference(x, w, plan, weights_padded=True),
        # x, col, rowptr and w in, out
        nbytes=Ns * F * 4 + E * 4 + (N + 1) * 8 + E * 4 + N * F * 4,
        flops=2 * E * F, library=lambda: A @ x)}],
        "segment_sum_csr": [], "expand_dst_csr": []}
    del A, x, w
    err["segment_sum_csr"] = 0.0
    for width in (C, CL):
        v = torch.randn(E, width, generator=gen, device=dev)
        e = check_close(f"typed graph segment sum C={width} f32",
                        k.segment_sum_csr(v, plan),
                        k.segment_sum_csr_reference(v, plan), 1e-5)
        err["segment_sum_csr"] = max(err["segment_sum_csr"], e)
        rows["segment_sum_csr"].append({
            "C": width, "graph": "typed", "dtype": "float32",
            "max_abs_err": e, **timing(
                f"segment sum C={width} f32, typed graph",
                lambda: k.segment_sum_csr(v, plan),
                lambda: k.segment_sum_csr_reference(v, plan),
                nbytes=E * width * 4 + (N + 1) * 8 + N * width * 4,
                flops=E * width, library=lambda: torch.segment_reduce(
                    v, "sum", offsets=rowptr))})
        del v
    # the expand at the class width: out (E, 349) f32, 6.98 GB
    xd = torch.randn(N, CL, generator=gen, device=dev)
    got = k.expand_dst_csr(xd, plan)
    if not torch.equal(got, k.expand_dst_csr_reference(xd, plan)):
        fail(f"typed graph expand C={CL} f32: not bitwise equal to x[row]")
    del got
    err["expand_dst_csr"] = 0.0
    counts = rowptr.diff()
    dst_rows = torch.repeat_interleave(torch.arange(N, device=dev), counts,
                                       output_size=E)
    row = {"C": CL, "scaled": False, "graph": "typed", "dtype": "float32",
           "max_abs_err": 0.0,
           **timing(f"expand C={CL} f32, typed graph",
                    lambda: k.expand_dst_csr(xd, plan),
                    lambda: k.expand_dst_csr_reference(xd, plan),
                    nbytes=N * CL * 4 + (N + 1) * 8 + E * CL * 4, flops=0,
                    library=lambda: torch.repeat_interleave(
                        xd, counts, dim=0, output_size=E))}
    row["index_select_ms"] = library_ms(
        f"expand C={CL} index_select", lambda: xd.index_select(0, dst_rows))
    print(f"  expand C={CL} f32, typed graph: index_select "
          f"{row['index_select_ms']:.4f} ms")
    rows["expand_dst_csr"].append(row)
    return err, rows


def typed_path(k, common, label, name, make_model, tg, plan, serve_calls,
               per_step, lr):
    """Serve ``N_REQUESTS`` requests (the eval forward, ``common.predict``)
    against the plain COO path, then a trace of 3 more; float32 step-0
    gradients of both paths; ``N_STEPS`` steps (``common.train_step``)
    against the plain path under one generator state, then a trace of 3
    more. Both the typed-edge models compute in float32, as in the JAX
    package. Returns a dict of the path's readings."""
    x, ei, fkw = tg["x"], tg["ei"], tg["fkw"]
    model = make_model().to(x.device)
    requests = [x + r * 1e-3 for r in range(N_REQUESTS)]
    counts, lat = serve_requests(
        k, requests,
        lambda xr: common.predict(model, xr, ei, plan=plan, **fkw),
        lambda xr: common.predict(model, xr, ei, **fkw),
        serve_calls, label, (tg["n"], HGT_CLASSES))
    serve_prof = profile(f"{name}_serve", lambda: common.predict(
        model, x, ei, plan=plan, **fkw))
    torch.cuda.reset_peak_memory_stats()
    grad_err, _ = f32_step0_grads(k, label, make_model, common, per_step,
                                  plan, x, ei, tg["labels"], fkw=fkw)
    launches, losses, step_ms, _, (state, y, mask, _) = train_phase(
        k, label, make_model, common, per_step, lr, 0.0, plan, x, ei,
        check_step0=False, labels=tg["labels"], fkw=fkw)
    print(f"  {label} peak device memory of the steps (both paths): "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    gen = dropout_rng(state.model, SEED + 200)
    train_prof = profile(f"{name}_train", lambda: common.train_step(
        state, x, ei, y, mask, plan=plan, **gen, **fkw))
    return {"serve": counts, "train": launches, "lat": lat,
            "step_ms": step_ms, "losses": losses, "grad_err": grad_err,
            "profile": {"serve": serve_prof, "train": train_prof}}


def phase_rgcn(k, common, RGCNModel, tg, plan):
    """RGCN (128 -> 64 -> 349, a full map a relation) on the flattened
    typed graph: a request is 2 `segment_sum_csr` launches (one a layer)
    and nothing else; a step adds their VJP, 2 expands (the messages'
    gathers from the relation table are PyTorch indexing, their backward
    an index_add)."""
    phase_start("phase 26: serve and train RGCN on the flattened typed "
                "graph")

    def make():
        torch.manual_seed(SEED + 26)
        return RGCNModel(HGT_FEAT, RGCN_HIDDEN, HGT_CLASSES, tg["R"])

    return typed_path(k, common, "RGCN", "rgcn", make, tg, plan,
                      {"segment_sum_csr": 2},
                      {"segment_sum_csr": 2, "expand_dst_csr": 2}, RGCN_LR)


def han_graph(HeteroGraph):
    """HAN's graph: the arxiv-shape node set with 128 random features,
    each node's class adding twice its own random direction (so the loss
    can fall in 5 steps, as in `hgt_graph`), 40 classes, 54% for training,
    and two metapath relations (HAN_RELATIONS), each bench.py's generator
    with its own seed."""
    rng = np.random.default_rng(SEED + 27)
    hg = HeteroGraph()
    y = rng.integers(0, N_CLASS, N_NODES)
    direction = rng.normal(size=(N_CLASS, N_FEAT))
    hg["paper"].x = (rng.normal(size=(N_NODES, N_FEAT))
                     + 2 * direction[y]).astype(np.float32)
    hg["paper"].y = y
    hg["paper"].train_mask = rng.random(N_NODES) < 0.54
    hg["paper"].test_mask = ~hg["paper"].train_mask
    for i, rel in enumerate(HAN_RELATIONS):
        hg[("paper", rel, "paper")].edge_index = arxiv_edges(
            np.random.default_rng(SEED + 28 + i), N_NODES, N_EDGES)
    return hg


def han_model(HANModel, hg):
    """HANModel at its defaults, its own init from the seed, with the GATs'
    maps scaled from truncated_normal(0.02) to glorot's std (0.1) and their
    attention vectors to std 0.3, as `gat_params`, so that the softmax is
    not uniform and the loss falls by MIN_FALL in 5 steps (at flax's init
    it fell 3.5% on an H100, 13% at these scales)."""
    torch.manual_seed(SEED + 29)
    model = HANModel(hg.metadata(), HAN_HIDDEN, N_CLASS, "paper",
                     heads=HAN_HEADS, drop_rate=HAN_DROP, in_channels=N_FEAT)
    with torch.no_grad():
        for gat in model.conv.gat.values():
            gat.w.mul_(5.0)
            gat.att.mul_(15.0)
    return model


def han_cross_type_check(k, common, HANConv, dev):
    """HANConv on the small synthetic movie/director graph, every
    relation's plan on the card (movie -> director: 200 source rows into
    60 destinations, the JAX plan path's fault C14) against its plain COO
    route, float32: one flash forward a relation."""
    hg, _ = common.synthetic_hetero()
    torch.manual_seed(SEED + 30)
    conv = HANConv(32, 4, hg.metadata(), heads=2).to(dev).eval()
    x = {nt: torch.from_numpy(v).to(dev) for nt, v in hg.x_dict.items()}
    ei = {et: torch.from_numpy(v).to(dev)
          for et, v in hg.edge_index_dict.items()}
    sync()
    reset_counts(k)
    with torch.no_grad():
        got = conv(x, ei, plan_dict=hg.csr_plans())
    sync()
    counts = read_counts(k)
    if counts != every_kernel({"flash_forward": len(hg.edge_types)}):
        fail(f"HAN cross-type check: launches {counts}")
    with torch.no_grad():
        want = conv(x, ei)
    return max(check_close(f"HAN cross-type relations, {nt}", got[nt],
                           want[nt], 1e-5) for nt in want)


def phase_han(k, common, HANModel, HANConv, HeteroGraph, compute_dtype,
              dev):
    """HAN (8 heads x 8, attention dropout 0.6) on two metapath relations
    over the arxiv-shape node set, bf16 compute (the process default): a
    request is 2 flash forward launches (one a relation); a step 2 flash
    forward, 2 flash backward and 4 SpMM (each GAT's score and feature
    gradients), as phase 7's GAT step. Step-0 gradients are held in float32 compute.
    First the cross-type check at a small size."""
    phase_start("phase 27: serve and train HAN on two metapath relations")
    cross_err = han_cross_type_check(k, common, HANConv, dev)
    t0 = time.perf_counter()
    hg = han_graph(HeteroGraph)
    plans = hg.csr_plans()
    x_dict, ei_dict, y, mask, _ = common.hetero_tensors(hg, "paper", dev)
    print(f"  HAN graph: {hg.num_nodes} nodes, {hg.num_edges} edges in "
          f"{len(plans)} relations, built in {time.perf_counter() - t0:.2f} s")
    with compute_dtype(torch.bfloat16):
        model = han_model(HANModel, hg).to(dev)
        requests = [{"paper": x_dict["paper"] + r * 1e-3}
                    for r in range(N_REQUESTS)]
        counts, lat = serve_requests(
            k, requests,
            lambda xr: common.predict(model, xr, ei_dict, plan_dict=plans),
            lambda xr: common.predict(model, xr, ei_dict),
            {"flash_forward": 2}, "HAN", (N_NODES, N_CLASS))
        serve_prof = profile("han_serve", lambda: common.predict(
            model, x_dict, ei_dict, plan_dict=plans))
    per_step = {"flash_forward": 2, "flash_backward": 2, "spmm_csr": 4}
    with compute_dtype(None):
        grad_err, _ = f32_step0_grads(
            k, "HAN", lambda: han_model(HANModel, hg), common, per_step,
            plans, x_dict, ei_dict, (y, mask), plan_key="plan_dict")
    with compute_dtype(torch.bfloat16):
        launches, losses, step_ms, _, (state, y, mask, _) = train_phase(
            k, "HAN", lambda: han_model(HANModel, hg), common, per_step,
            HAN_LR, 0.0, plans, x_dict, ei_dict, check_step0=False,
            labels=(y, mask), plan_key="plan_dict")
        gen = torch.Generator(device=dev).manual_seed(SEED + 200)
        train_prof = profile("han_train", lambda: common.train_step(
            state, x_dict, ei_dict, y, mask, plan_dict=plans,
            generator=gen))
    return {"serve": counts, "train": launches, "lat": lat,
            "step_ms": step_ms, "losses": losses, "grad_err": grad_err,
            "cross_type_err": cross_err,
            "profile": {"serve": serve_prof, "train": train_prof}}


def phase_simplehgn(k, common, SimpleHGNModel, tg, plan):
    """SimpleHGN (8 heads x 64, 2 layers) on the flattened typed graph. A
    request, per layer: 1 expand (the destination scores), the CSR-order
    softmax (1 segment max, 2 expands, 1 segment sum), 8 `spmm_csr` (one
    a head). A step adds, per layer, 8 `spmm_csr` (dx on the transpose
    plan) and 8 SDDMM (dalpha), 1 `spmm_csr` (the source scores' gather,
    on the edge-scatter plan), 1 segment sum (the destination scores'
    expand) and the softmax's 1 segment sum and 1 expand (its max carries
    no gradient)."""
    phase_start("phase 28: serve and train SimpleHGN on the flattened "
                "typed graph")

    def make():
        torch.manual_seed(SEED + 31)
        return SimpleHGNModel(tg["R"], SHGN_HIDDEN, HGT_CLASSES,
                              heads=SHGN_HEADS, drop_rate=SHGN_DROP,
                              in_channels=HGT_FEAT)

    H = SHGN_HEADS
    serve_calls = {"expand_dst_csr": 2 * 3, "segment_sum_csr": 2,
                   "spmm_max_csr": 2, "spmm_csr": 2 * H}
    per_step = {"expand_dst_csr": 2 * 4, "segment_sum_csr": 2 * 3,
                "spmm_max_csr": 2, "spmm_csr": 2 * (2 * H + 1),
                "sddmm_csr": 2 * H}
    return typed_path(k, common, "SimpleHGN", "simplehgn", make, tg, plan,
                      serve_calls, per_step, SHGN_LR)


# the data core's paths (phase 29), each on files written from SEED in a
# temporary directory, nothing fetched (GGL_TPU_OFFLINE=1): Planetoid's
# pubmed at its published shape (19,717 nodes, 500 features, 3 classes,
# 60 / 500 / 1,000 split, ~44,300 undirected edges) through the gcn twin
# at Kipf & Welling's width (its defaults: hidden 16, dropout 0.5, Adam lr
# 0.01, decay 5e-4); the papers shard of phase 24 staged in OGB's npy
# layout through the papers twin (--data-root); a TU set at ENZYMES'
# published statistics (600 graphs, 6 classes, ~33 nodes and ~62
# undirected edges a graph, 18 node attributes, 3 node labels) batched
# into GCNConvs of width 64 in float32
PUBMED_NODES, PUBMED_FEAT, PUBMED_CLASSES = 19_717, 500, 3
PUBMED_EDGES, PUBMED_TRAIN, PUBMED_TEST = 44_324, 60, 1_000
PAPERS_STAGED_STEPS = 2
TU_GRAPHS, TU_CLASSES, TU_ATTRS, TU_LABELS = 600, 6, 18, 3
TU_BATCH, TU_WIDTH, TU_LAYERS = 128, 64, 3
# float32 outputs of two sum orders: within this share of max |out| (the
# f32 rule of the parity tests, ROADMAP section C)
F32_OUT_TOL = 1e-5


def write_pubmed(raw_dir, rng):
    """The eight ``ind.pubmed.*`` files (scipy CSR features, one-hot
    labels, the adjacency dict, the test ids), as Planetoid ships them:
    x holds the 60 training rows, allx every row before the test block,
    tx / ty the test block in the order of ``test.index``. Features are
    sparse (10% of the columns) with a class-owned block of columns;
    80% of the edges stay within a class. Returns the arrays a reader
    must give back: x, y, edge_index (coalesced, no self-loops) and the
    test ids."""
    import pickle
    import scipy.sparse as sp
    n, f, c = PUBMED_NODES, PUBMED_FEAT, PUBMED_CLASSES
    y = rng.integers(0, c, n)
    y[:PUBMED_TRAIN] = np.arange(PUBMED_TRAIN) % c  # 20 a class
    x = (rng.random((n, f)) < 0.1) * rng.random((n, f))
    own = (np.arange(f)[None, :] // (f // c)) == y[:, None]
    x = (x + own * (rng.random((n, f)) < 0.2) * 0.5).astype(np.float32)
    e = int(PUBMED_EDGES * 1.08)
    src = rng.integers(0, n, e)
    same = rng.random(e) < 0.8
    pool = [np.nonzero(y == k)[0] for k in range(c)]
    dst = np.where(same, np.array([pool[k][i % len(pool[k])] for k, i in
                                   zip(y[src], rng.integers(0, n, e))]),
                   rng.integers(0, n, e))
    pairs = np.unique(np.sort(np.stack([src, dst]), 0), axis=1)
    pairs = pairs[:, pairs[0] != pairs[1]][:, :PUBMED_EDGES]
    both = np.concatenate([pairs, pairs[::-1]], 1)
    order = np.lexsort((both[1], both[0]))
    edge_index = both[:, order]
    n_all = n - PUBMED_TEST
    test = rng.permutation(np.arange(n_all, n))
    onehot = np.eye(c)[y]
    adj = {i: [] for i in range(n)}
    for a, b in edge_index.T.tolist():
        adj[a].append(b)
    files = {"x": sp.csr_matrix(x[:PUBMED_TRAIN]),
             "y": onehot[:PUBMED_TRAIN],
             "allx": sp.csr_matrix(x[:n_all]), "ally": onehot[:n_all],
             "tx": sp.csr_matrix(x[test]), "ty": onehot[test],
             "graph": adj}
    os.makedirs(raw_dir, exist_ok=True)
    for name, value in files.items():
        with open(os.path.join(raw_dir, f"ind.pubmed.{name}"), "wb") as fh:
            pickle.dump(value, fh)
    with open(os.path.join(raw_dir, "ind.pubmed.test.index"), "w") as fh:
        fh.write("\n".join(str(i) for i in test))
    return {"x": x, "y": y.astype(np.int64), "edge_index": edge_index,
            "test": test}


def write_tu(raw_dir, name, rng):
    """A TU collection of TU_GRAPHS graphs at ENZYMES' statistics:
    ``<name>_A.txt`` (both directions of each undirected edge, 1-based),
    the graph indicator, graph labels 1..6, 18 node attributes and node
    labels 1..3. Returns the node count of each graph."""
    sizes = rng.integers(10, 57, TU_GRAPHS)  # mean 33
    starts = np.concatenate([[0], np.cumsum(sizes)])
    edges = []
    for g, m in enumerate(sizes):
        k = int(round(1.9 * m))  # ~62 undirected edges at 33 nodes
        ab = rng.integers(0, m, (2, 3 * k))
        ab = np.unique(np.sort(ab, 0), axis=1)
        ab = ab[:, ab[0] != ab[1]][:, :k] + starts[g] + 1
        edges.append(np.concatenate([ab, ab[::-1]], 1))
    edges = np.concatenate(edges, 1).T
    os.makedirs(raw_dir, exist_ok=True)
    n = int(sizes.sum())

    def put(suffix, arr, fmt):
        np.savetxt(os.path.join(raw_dir, f"{name}_{suffix}.txt"), arr,
                   fmt=fmt, delimiter=", ")

    put("A", edges, "%d")
    put("graph_indicator", np.repeat(np.arange(1, TU_GRAPHS + 1), sizes),
        "%d")
    put("graph_labels", rng.integers(1, TU_CLASSES + 1, TU_GRAPHS), "%d")
    put("node_attributes", rng.normal(size=(n, TU_ATTRS)), "%.6f")
    put("node_labels", rng.integers(1, TU_LABELS + 1, n), "%d")
    return sizes


def stage_ogb(root, shard):
    """Phase 24's shard (before self-loops) in OGB's npy layout under
    ``root``: raw/{node_feat,edge_index,node_label}.npy (labels float64,
    as OGB stores them) and split/time/{train,valid}.npy."""
    base = os.path.join(root, "ogbn_papers100M")
    raw, split = os.path.join(base, "raw"), os.path.join(base, "split",
                                                          "time")
    os.makedirs(raw)
    os.makedirs(split)
    np.save(os.path.join(raw, "node_feat.npy"), shard["x"])
    np.save(os.path.join(raw, "edge_index.npy"), shard["ei0"])
    np.save(os.path.join(raw, "node_label.npy"),
            shard["y"].astype(np.float64))
    np.save(os.path.join(split, "train.npy"), np.nonzero(shard["train"])[0])
    np.save(os.path.join(split, "valid.npy"), np.nonzero(shard["val"])[0])


def data_planetoid_path(k, common, gcn_trainer, GCNModel, tmp, rng):
    """(a) pubmed's raw files -> load_node_dataset -> Planetoid -> Graph
    -> the gcn twin's `main` on the card (CSRPlan, `spmm_csr` forward and
    backward), held against the plain COO path of the same loop; a second
    construction reads the processed cache only."""
    from gammagl_tpu_torch.datasets import Planetoid
    from gammagl_tpu_torch.datasets import planetoid as planetoid_module
    t0 = time.perf_counter()
    want = write_pubmed(os.path.join(tmp, "pubmed", "raw"), rng)
    t_write = time.perf_counter() - t0
    common._DS_CACHE.clear()
    t0 = time.perf_counter()
    g, c = common.load_node_dataset("pubmed", tmp)
    t_raw = time.perf_counter() - t0
    n_all = PUBMED_NODES - PUBMED_TEST
    masks = {"train_mask": np.arange(PUBMED_NODES) < PUBMED_TRAIN,
             "val_mask": (np.arange(PUBMED_NODES) >= PUBMED_TRAIN)
             & (np.arange(PUBMED_NODES) < PUBMED_TRAIN + 500),
             "test_mask": np.arange(PUBMED_NODES) >= n_all}
    for name, arr in (("x", want["x"]), ("y", want["y"]),
                      ("edge_index", want["edge_index"]), *masks.items()):
        got = np.asarray(g[name])
        if got.shape != arr.shape or not np.array_equal(got, arr):
            fail(f"pubmed: loaded {name} differs from the written files")
    if c != PUBMED_CLASSES or g.num_nodes != PUBMED_NODES:
        fail(f"pubmed: {g.num_nodes} nodes, {c} classes")

    def no_parse(*a, **kw):
        fail("the second Planetoid construction parsed the raw files")

    real = planetoid_module.read_planetoid_data
    planetoid_module.read_planetoid_data = no_parse
    try:
        t0 = time.perf_counter()
        again = Planetoid(tmp, "pubmed")[0]
        t_cache = time.perf_counter() - t0
    finally:
        planetoid_module.read_planetoid_data = real
    if not np.array_equal(again.edge_index, g.edge_index):
        fail("pubmed: the processed cache gave another graph")
    print(f"  pubmed files: {PUBMED_NODES} nodes, "
          f"{g.num_edges // 2} undirected edges, {PUBMED_FEAT} features, "
          f"{c} classes; written in {t_write:.2f} s, raw parse "
          f"{t_raw:.3f} s, processed cache {t_cache:.3f} s")

    args = gcn_trainer.parser().parse_args(
        ["--dataset", "pubmed", "--dataset_path", tmp, "--n_epoch",
         str(N_STEPS)])
    if args.device != "cuda":
        fail("the gcn twin does not default to the card")
    # 2 layers, each a forward and a dx in the step, a forward in the eval
    per_epoch = {"spmm_csr": 2 * 3}
    sync()
    reset_counts(k)
    t0 = time.perf_counter()
    out = gcn_trainer.main(args)
    sync()
    t_kernel = time.perf_counter() - t0
    counts = read_counts(k)
    if counts != every_kernel(per_epoch, N_STEPS):
        fail(f"pubmed gcn twin: expected {per_epoch} an epoch, counted "
             f"{counts}")
    torch.manual_seed(args.seed)
    model = GCNModel(hidden_dim=args.hidden_dim, num_class=c,
                     drop_rate=args.drop_rate)
    reset_counts(k)
    plain = common.run_simple_node_trainer(model, args,
                                           forward_kwargs={"plan": None})
    if any(read_counts(k).values()):
        fail(f"the plain path launched kernels: {read_counts(k)}")
    for i, (lk, lp) in enumerate(zip(out["losses"], plain["losses"])):
        print(f"  pubmed step {i}: loss kernel {lk:.6f}, plain {lp:.6f}")
        if not np.isfinite(lk) or abs(lk - lp) > LOSS_TOL * abs(lp):
            fail(f"pubmed step {i}: loss {lk} vs plain {lp}")
    if not out["losses"][-1] < (1 - MIN_FALL) * out["losses"][0]:
        fail(f"pubmed: loss did not fall by {MIN_FALL:.0%}: "
             f"{out['losses']}")
    med = float(np.median(out["epoch_ms"][1:]))
    plain_med = float(np.median(plain["epoch_ms"][1:]))
    print(f"  pubmed gcn twin epoch (step and eval, epochs 1-{N_STEPS - 1}): "
          f"median {med:.3f} ms kernel path, {plain_med:.3f} ms plain path; "
          f"the twin's whole run {t_kernel:.2f} s")
    return {"counts": counts, "losses": out["losses"],
            "plain_losses": plain["losses"], "epoch_ms": out["epoch_ms"],
            "plain_epoch_ms": plain["epoch_ms"], "write_s": t_write,
            "raw_parse_s": t_raw, "processed_cache_s": t_cache,
            "twin_s": t_kernel}


def data_papers_path(k, shard, tmp):
    """(b) phase 24's shard staged in OGB's npy layout, read back by
    `load_ogb_root` (memory maps), and the papers twin on it with
    --data-root: step-0 loss and gradients bitwise those of the twin on
    the same arrays handed in, PAPERS_STAGED_STEPS staged steps with
    their launches, no warning about read-only memory."""
    import warnings
    from gammagl_tpu_torch.examples import papers100m_trainer as papers
    from gammagl_tpu_torch.parallel import make_partitioned_gcn_train_staged
    root = os.path.join(tmp, "ogb")
    t0 = time.perf_counter()
    stage_ogb(root, shard)
    t_stage = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = papers.load_ogb_root(root)
    t_load = time.perf_counter() - t0
    names = ("edge_index", "x", "y", "train", "val")
    for name, got, arr in zip(names, loaded, (shard["ei0"], shard["x"],
                                              shard["y"], shard["train"],
                                              shard["val"])):
        if got.shape != arr.shape or not np.array_equal(got, arr):
            fail(f"staged papers shard: {name} differs from the shard's")
    if loaded[5] != shard["c"]:
        fail(f"staged papers shard: {loaded[5]} classes")
    print(f"  papers shard staged in OGB's npy layout in {t_stage:.2f} s "
          f"(its in-memory build: {shard['t_gen']:.2f} s); load_ogb_root "
          f"(memory maps) {t_load:.3f} s")
    argv = ["--epochs", str(PAPERS_STAGED_STEPS)]
    args = papers.parser().parse_args(argv + ["--data-root", root])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        prep = papers.prepare(args)
        t_prep = time.perf_counter() - t0
    bad = [str(w.message) for w in caught if "writ" in str(w.message)]
    if bad:
        fail(f"staged papers shard: warnings about read-only memory: {bad}")
    if prep["device"].type != "cuda":
        fail("the papers twin does not run on the card")
    mem = papers.prepare(papers.parser().parse_args(argv), data=(
        shard["ei0"], shard["x"], shard["y"], shard["train"], shard["val"],
        shard["c"]))
    step0 = []
    for p in (prep, mem):
        params, _, step, _ = make_partitioned_gcn_train_staged(
            p["part"], p["f"], args.hidden, p["c"], num_layers=args.layers,
            compute_dtype=p["cdtype"], learning_rate=args.lr,
            device=p["device"])
        step0.append(step.loss_and_grads(params, p["xs"], p["ys"], p["ms"]))
    (la, ga), (lb, gb) = step0
    if not torch.equal(la, lb) or any(not torch.equal(ga[n], gb[n])
                                      for n in ga):
        fail("staged papers shard: step-0 loss or gradients differ from "
             "the twin's on the arrays handed in")
    del mem, step0, ga, gb
    part = prep["part"]
    fwd = {name: args.layers * n for name, n in tier_launches(part).items()}
    per_step = {name: fwd[name] + (args.layers - 1) * n
                for name, n in tier_launches(part.transpose).items()}
    # the twin scores validation after its first and last steps: one
    # forward each
    want = {name: PAPERS_STAGED_STEPS * per_step.get(name, 0)
            + 2 * fwd.get(name, 0) for name in set(per_step) | set(fwd)}
    sync()
    reset_counts(k)
    out = papers.train(args, prep)
    sync()
    counts = read_counts(k)
    if counts != every_kernel(want):
        fail(f"staged papers twin: expected {want}, counted {counts}")
    print(f"  staged papers twin: step-0 loss {float(la):.6f} and "
          f"gradients bitwise those on the arrays handed in; losses "
          f"{out['losses']}; prepare {t_prep:.2f} s")
    return {"counts": counts, "losses": out["losses"],
            "step0_loss": float(la), "stage_s": t_stage,
            "load_ogb_root_s": t_load, "in_memory_build_s": shard["t_gen"],
            "prepare_s": t_prep, "epoch_ms": out["epoch_ms"]}


def data_tu_path(k, tmp, rng, dev):
    """(c) TU files -> TUDataset -> BatchGraph of TU_BATCH graphs ->
    TU_LAYERS GCNConvs through the batch's `csr_plan()` and `spmm_csr`:
    each graph's rows against that graph alone, `to_data_list` round
    trip; then `pad_graph(batch, bucket=True)` through the COO route on
    the card, its real rows against the unpadded result."""
    from gammagl_tpu_torch.data import BatchGraph, pad_graph
    from gammagl_tpu_torch.datasets import TUDataset
    from gammagl_tpu_torch.layers.conv import GCNConv
    name = "ENZYMES"
    sizes = write_tu(os.path.join(tmp, name, "raw"), name, rng)
    t0 = time.perf_counter()
    ds = TUDataset(tmp, name)
    t_raw = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = TUDataset(tmp, name)
    t_cache = time.perf_counter() - t0
    graphs = [ds[i] for i in range(TU_BATCH)]
    if len(ds) != TU_GRAPHS or ds.num_classes != TU_CLASSES or [
            gr.num_nodes for gr in graphs] != sizes[:TU_BATCH].tolist():
        fail(f"TU set: {len(ds)} graphs, {ds.num_classes} classes")
    f = ds.num_node_features
    if f != TU_ATTRS + TU_LABELS:
        fail(f"TU set: {f} node features")
    batch = BatchGraph.from_data_list(graphs)
    for a, b in zip(batch.to_data_list(), graphs):
        for key in b.keys():
            if not np.array_equal(a[key], np.asarray(b[key]).reshape(
                    a[key].shape)):
                fail(f"TU batch: to_data_list changed {key}")
    print(f"  TU set ({name} statistics): {TU_GRAPHS} graphs, "
          f"{int(sizes.sum())} nodes, mean {sizes.mean():.2f} a graph, "
          f"{ds.data.num_edges // 2 / TU_GRAPHS:.2f} undirected edges a "
          f"graph; raw parse {t_raw:.3f} s, processed cache {t_cache:.3f} "
          f"s; batch of {TU_BATCH}: {batch.num_nodes} nodes, "
          f"{batch.num_edges} edges")
    torch.manual_seed(SEED)
    widths = [f] + [TU_WIDTH] * TU_LAYERS
    convs = [GCNConv(a, b).to(dev).eval() for a, b in zip(widths,
                                                          widths[1:])]

    def run(g, plan):
        h = torch.from_numpy(np.asarray(g.x, np.float32)).to(dev)
        ei = torch.from_numpy(np.asarray(g.edge_index)).to(dev)
        with torch.no_grad():
            for i, conv in enumerate(convs):
                h = conv(h, ei, num_nodes=g.num_nodes, plan=plan)
                if i < len(convs) - 1:
                    h = torch.relu(h)
        return h

    looped = batch.add_self_loop()
    plan = looped.csr_plan()
    sync()
    reset_counts(k)
    out = run(looped, plan)
    sync()
    counts = read_counts(k)
    if counts != every_kernel({"spmm_csr": TU_LAYERS}):
        fail(f"TU batch: expected {TU_LAYERS} SpMM, counted {counts}")
    if out.shape != (batch.num_nodes, TU_WIDTH):
        fail(f"TU batch: output shape {tuple(out.shape)}")
    ptr = batch.ptr
    err = 0.0
    for i, gr in enumerate(graphs):
        alone = gr.add_self_loop()
        err = max(err, float((out[ptr[i]:ptr[i + 1]] - run(
            alone, alone.csr_plan())).abs().max()))
    scale = float(out.abs().max())
    print(f"  TU batch vs each graph alone: max_abs_err {err:.3e} "
          f"(limit {F32_OUT_TOL:g} x max|out| {scale:.3e})")
    if not err <= F32_OUT_TOL * scale:
        fail("TU batch: a graph's rows differ from the graph alone")
    padded = pad_graph(looped, bucket=True)
    reset_counts(k)
    coo = run(padded, None)
    sync()  # a device assert from an index out of range fails here
    if any(read_counts(k).values()):
        fail(f"the COO route launched kernels: {read_counts(k)}")
    real = torch.from_numpy(padded.node_mask).to(dev)
    pad_err = check_close("TU padded batch, COO route, real rows vs the "
                          "unpadded kernel path", coo[real], out, 0.0)
    print(f"  padded to {padded.num_nodes} nodes, {padded.num_edges} edges "
          f"(pads at id {padded.num_nodes})")
    return {"counts": counts, "raw_parse_s": t_raw,
            "processed_cache_s": t_cache, "vs_alone_max_abs_err": err,
            "padded_max_abs_err": pad_err,
            "padded": [padded.num_nodes, padded.num_edges]}


# IMDB (phase 29 (d)): the published statistics of MAGNN's processed
# release, which the IMDB dataset reads (PyG's IMDB gives the same: 4,278
# movies, 2,081 directors, 5,257 actors, 3,066 bag-of-words features a
# type, 3 genres, 400 / 400 / 3,478 movies for training, validation and
# test); each movie one director (4,278 edges) and three actors but six
# with two (12,828 edges), both directions; feature rows of IMDB_WORDS
# words, a movie's genre among them. The han twin at its defaults (4
# heads x 16, dropout 0.4, lr 0.005) for IMDB_STEPS steps; its plan route
# against its COO route in bf16 within HAN_ROUTE_TOL of max |logit|
IMDB_MOVIES, IMDB_DIRECTORS, IMDB_ACTORS = 4278, 2081, 5257
IMDB_FEAT, IMDB_MA_EDGES, IMDB_CLASSES = 3066, 12828, 3
IMDB_SPLIT, IMDB_WORDS, IMDB_STEPS, HAN_ROUTE_TOL = (400, 400), 20, 2, 3e-2


def write_imdb(raw_dir, rng):
    """IMDB's processed layout (``features_{0,1,2}.npz`` CSR, labels.npy,
    train_val_test_idx.npz, the block adjacency adjM.npz in movie |
    director | actor order) at IMDB's statistics. Returns what was written
    as arrays: the dense features by type, labels, split and each
    relation's (src, dst) pairs sorted as a CSR walk of adjM gives
    them."""
    import scipy.sparse as sp
    os.makedirs(raw_dir, exist_ok=True)
    sizes = (IMDB_MOVIES, IMDB_DIRECTORS, IMDB_ACTORS)
    y = rng.integers(0, IMDB_CLASSES, IMDB_MOVIES)
    feats = []
    for i, n in enumerate(sizes):
        cols = rng.integers(0, IMDB_FEAT, (n, IMDB_WORDS))
        if i == 0:
            cols[:, 0] = y  # the genre's word
        m = sp.csr_matrix((np.ones(cols.size, np.float32),
                           (np.repeat(np.arange(n), IMDB_WORDS),
                            cols.ravel())), shape=(n, IMDB_FEAT))
        m.data[:] = 1.0  # repeated words count once
        sp.save_npz(os.path.join(raw_dir, f"features_{i}.npz"), m)
        feats.append(np.asarray(m.todense(), np.float32))
    np.save(os.path.join(raw_dir, "labels.npy"), y)
    perm = rng.permutation(IMDB_MOVIES)
    n_tr, n_va = IMDB_SPLIT
    split = {"train_idx": np.sort(perm[:n_tr]),
             "val_idx": np.sort(perm[n_tr:n_tr + n_va]),
             "test_idx": np.sort(perm[n_tr + n_va:])}
    np.savez(os.path.join(raw_dir, "train_val_test_idx.npz"), **split)
    director = rng.integers(0, IMDB_DIRECTORS, IMDB_MOVIES)
    n_two = 3 * IMDB_MOVIES - IMDB_MA_EDGES
    actors = [rng.choice(IMDB_ACTORS, 2 if m < n_two else 3, replace=False)
              for m in range(IMDB_MOVIES)]
    ma = np.stack([np.repeat(np.arange(IMDB_MOVIES), [len(a) for a in
                                                      actors]),
                   np.concatenate(actors)])
    md = np.stack([np.arange(IMDB_MOVIES), director])
    offs = np.concatenate([[0], np.cumsum(sizes)])
    blocks = {(0, 1): md, (1, 0): md[::-1], (0, 2): ma, (2, 0): ma[::-1]}
    rows = np.concatenate([b[0] + offs[i] for (i, _), b in blocks.items()])
    cols = np.concatenate([b[1] + offs[j] for (_, j), b in blocks.items()])
    adj = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                        shape=(offs[-1], offs[-1]))
    sp.save_npz(os.path.join(raw_dir, "adjM.npz"), adj)
    types = ("movie", "director", "actor")
    edges = {}
    for (i, j), b in blocks.items():
        order = np.lexsort((b[1], b[0]))
        edges[(types[i], "to", types[j])] = b[:, order].astype(np.int64)
    return {"x": dict(zip(types, feats)), "y": y, "split": split,
            "edges": edges}


def imdb_graph(HeteroGraph, want):
    """The written arrays as the `HeteroGraph` IMDB builds: node types,
    then relations, in IMDB's order."""
    hg = HeteroGraph()
    for nt, x in want["x"].items():
        hg[nt].x = x
    hg["movie"].y = want["y"].astype(np.int64)
    for name in ("train", "val", "test"):
        mask = np.zeros(IMDB_MOVIES, bool)
        mask[want["split"][f"{name}_idx"]] = True
        hg["movie"][f"{name}_mask"] = mask
    for et in (("movie", "to", "director"), ("movie", "to", "actor"),
               ("director", "to", "movie"), ("actor", "to", "movie")):
        hg[et].edge_index = want["edges"][et]
    return hg


def data_imdb_path(k, common, tmp, dev):
    """(d) IMDB's raw files at its published statistics -> `IMDB` (every
    loaded array equal to the written one) -> the han twin on the card
    with ``--dataset_path`` for IMDB_STEPS steps, each relation's GAT on
    its `CSRPlan` (actor -> movie has more source rows than destination
    rows, ROADMAP C14): step-0 loss and gradients bitwise those of the
    same `HeteroGraph` handed in as ``data=``, the flash launches counted
    exactly, and the plan route against the COO route in bf16."""
    from gammagl_tpu_torch.data import HeteroGraph
    from gammagl_tpu_torch.examples import han_trainer
    from gammagl_tpu_torch.models import HANModel
    from gammagl_tpu_torch.utils import compute_dtype
    root = os.path.join(tmp, "imdb")
    t0 = time.perf_counter()
    want = write_imdb(os.path.join(root, "raw"), np.random.default_rng(
        SEED + 290))
    t_write = time.perf_counter() - t0
    args = han_trainer.parser().parse_args(
        ["--dataset_path", root, "--n_epoch", str(IMDB_STEPS)])
    t0 = time.perf_counter()
    hg, target = han_trainer.load(args)
    t_load = time.perf_counter() - t0
    mem = imdb_graph(HeteroGraph, want)
    if (hg.node_types, hg.edge_types) != (mem.node_types, mem.edge_types):
        fail(f"IMDB: types {hg.metadata()} != {mem.metadata()}")
    for t in mem.node_types + mem.edge_types:
        if list(hg[t].keys()) != list(mem[t].keys()):
            fail(f"IMDB {t}: fields {list(hg[t].keys())}")
        for key, arr in mem[t].items():
            got = np.asarray(hg[t][key])
            if (got.dtype != arr.dtype or got.shape != arr.shape
                    or not np.array_equal(got, arr)):
                fail(f"IMDB {t}.{key} differs from the written array")
    n_ma = mem[("movie", "to", "actor")].edge_index.shape[1]
    print(f"  IMDB files written in {t_write:.2f} s, read by IMDB in "
          f"{t_load:.2f} s: {IMDB_MOVIES} movies, {IMDB_DIRECTORS} "
          f"directors, {IMDB_ACTORS} actors, {IMDB_FEAT} features, "
          f"{IMDB_MOVIES} + {n_ma} edges each way; every array as written")

    def twin_model(graph, x_dict):
        torch.manual_seed(args.seed)
        return HANModel(graph.metadata(), args.hidden_dim, IMDB_CLASSES,
                        target, heads=args.heads, drop_rate=args.drop_rate,
                        in_channels={nt: v.shape[1]
                                     for nt, v in x_dict.items()}).to(dev)

    def step0(graph):
        """The twin's first step, as it runs it: (loss, gradients)."""
        x_dict, ei_dict, y, mask, _ = common.hetero_tensors(graph, target,
                                                            dev)
        model = twin_model(graph, x_dict).train()
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        loss = common.loss_and_grad(model, x_dict, ei_dict, y, mask,
                                    plan_dict=graph.csr_plans(),
                                    generator=gen)
        # the GATs of relations into other types than the target's have
        # no gradient
        return loss, {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None}

    def apart(a, b):
        """The largest difference of two step-0 results (inf if their
        gradients' names differ)."""
        if sorted(a[1]) != sorted(b[1]):
            return float("inf")
        return max([float((a[0] - b[0]).abs())]
                   + [float((a[1][n] - b[1][n]).abs().max()) for n in a[1]])

    # HAN's backward sums the cross-type relations' clipped destination
    # rows with an indexed gather's backward, whose atomic adds land in
    # any order: two runs on one graph can differ in the last bits. The
    # comparison of the two graphs runs in PyTorch's deterministic mode
    # (the hand-written kernels are deterministic in any mode)
    nondet = apart(step0(mem), step0(mem))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (la, ga), (lb, gb) = step0(hg), step0(mem)
    finally:
        torch.use_deterministic_algorithms(False)
    if not torch.equal(la, lb) or apart((la, ga), (lb, gb)) != 0.0:
        fail(f"IMDB: the han twin's step-0 loss or gradients differ from "
             f"those on the HeteroGraph handed in by "
             f"{apart((la, ga), (lb, gb)):.3e} (two runs on one graph in "
             f"the default mode: {nondet:.3e})")
    rels = len(mem.edge_types)
    into = sum(et[2] == target for et in mem.edge_types)
    # the twin scores the test set (one eval forward) at every 10th epoch
    # and the last, then once more at the end
    evals = sum(e % 10 == 0 or e == IMDB_STEPS - 1
                for e in range(IMDB_STEPS)) + 1
    per_step = {"flash_forward": rels, "flash_backward": into,
                "spmm_csr": 2 * into}
    expect = {name: IMDB_STEPS * n + (evals * rels
                                      if name == "flash_forward" else 0)
              for name, n in per_step.items()}
    sync()
    reset_counts(k)
    t0 = time.perf_counter()
    out = han_trainer.main(args)
    sync()
    seconds = time.perf_counter() - t0
    counts = read_counts(k)
    if counts != every_kernel(expect):
        fail(f"IMDB han twin: expected {expect}, counted {counts}")
    x_dict, ei_dict, _, _, _ = common.hetero_tensors(hg, target, dev)
    model = out["state"].model
    with compute_dtype(torch.bfloat16):
        plan_logits = common.predict(model, x_dict, ei_dict,
                                     plan_dict=hg.csr_plans())
        coo_logits = common.predict(model, x_dict, ei_dict)
    route_err = check_close("IMDB HAN plan route vs COO route, bf16",
                            plan_logits, coo_logits, 0.0,
                            atol=HAN_ROUTE_TOL)
    print(f"  IMDB han twin on the card: step-0 loss {float(la):.6f} and "
          f"gradients bitwise those on the HeteroGraph handed in "
          f"(deterministic mode; two runs on one graph in the default mode "
          f"{nondet:.3e} apart); "
          f"{IMDB_STEPS} steps, losses {out['losses']}, {seconds:.2f} s "
          f"with its evaluations; launches {counts}")
    return {"counts": counts, "losses": out["losses"],
            "step0_loss": float(la), "step0_default_mode_apart": nondet,
            "write_s": t_write, "load_s": t_load,
            "twin_s": seconds, "route_max_abs_err": route_err}


def phase_data_paths(k, common, gcn_trainer, GCNModel, shard, smi):
    """Phase 29: the three paths of the data core, each through its entry
    points, on files written here."""
    import shutil
    import tempfile
    phase_start("phase 29: the data core's paths: Planetoid files -> GCN "
                "twin, staged OGB layout -> papers twin, TU files -> "
                "BatchGraph -> GCNConv, padding on the card, IMDB files -> "
                "han twin")
    os.environ["GGL_TPU_OFFLINE"] = "1"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    rng = np.random.default_rng(SEED)
    try:
        planetoid = data_planetoid_path(k, common, gcn_trainer, GCNModel,
                                        tmp, rng)
        staged = data_papers_path(k, shard, tmp)
        tu = data_tu_path(k, tmp, rng, torch.device("cuda"))
        imdb = data_imdb_path(k, common, tmp, torch.device("cuda"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  host load seconds ({smi}): pubmed raw parse "
          f"{planetoid['raw_parse_s']:.3f}, processed cache "
          f"{planetoid['processed_cache_s']:.3f}; papers shard npy staging "
          f"{staged['stage_s']:.2f} (in-memory build "
          f"{staged['in_memory_build_s']:.2f}), load_ogb_root "
          f"{staged['load_ogb_root_s']:.3f}, twin prepare "
          f"{staged['prepare_s']:.2f}; TU raw parse {tu['raw_parse_s']:.3f}, "
          f"processed cache {tu['processed_cache_s']:.3f}; IMDB write "
          f"{imdb['write_s']:.2f}, raw parse {imdb['load_s']:.2f}")
    return {"planetoid": planetoid, "staged": staged, "tu": tu,
            "imdb": imdb}


# the propagation zoo (phase 30) on the arxiv-shape graph of phases 5-9,
# each model at its JAX defaults (GCNII at its default 64 layers, the
# paper's deep setting) with its twin's Adam lr and decay, on planted
# labels (`zoo_inputs`) that 5 steps can lower by MIN_FALL on random
# edges. Logits within ZOO_TOL of max |logit| of the plain COO path, GCNII's
# 64 layers too (they differed by 1.6e-7 of it on an H100)
ZOO_TOL = 1e-4
# GIN (phase 31): the GIN paper's graph-classification setting (5 layers,
# hidden 64, sum readout) on phase 29's TU shape; sort pooling at
# DGCNN's k for ENZYMES-size graphs
GIN_LAYERS, GIN_HIDDEN, SORT_K = 5, 64, 35
# the rest of hetero (phase 32): requests and Adam steps of each model,
# every output within F32_OUT_TOL of max |out| of the same module's
# float64 run (ieHGCN: IEHGCN_TOL, below); HPN and RoheHAN at their
# twins' defaults (hidden 16, RoheHAN's 8 heads) on HAN's two metapath
# relations, ieHGCN (hidden 16) on HGT's typed graph, HiD-Net at its
# defaults (10 layers, hidden 64) on the arxiv-shape graph, HeCo at
# ACM's shape in the HeCo paper (4,019 papers, 7,167 authors, 60
# subjects, 1,902 paper features, 13,407 paper-author edges; schema P-A
# and P-S, metapaths PAP and PSP; hidden 64, tau 0.8, lambda 0.5,
# feature dropout 0.3; authors and subjects one-hot, as the paper's code
# gives them); the twins' Adam lr
# ieHGCN on HGT's typed graph: its scores q.k reach |s| ~ 80-340, and the
# softmax over the candidates scales the float32 rounding of every stage
# before it (mostly the 128-wide projections; the means alone leave under
# 1.7e-6). scripts/iehgcn_precision.py on an H100 (700 W): 7.5e-6 to
# 4.0e-5 of max |out| from float64 over 8 init seeds, TF32 matmuls
# 1.8e-2 to 4.7e-2, bf16 0.14 to 0.37. IEHGCN_TOL is twice the largest
# float32 reading rounded up to a power of ten
N_COO_REQUESTS, N_COO_STEPS, COO_LR, IEHGCN_TOL = 4, 3, 0.005, 1e-4
WAVE2_HIDDEN, ROHE_HEADS, HIDNET_LAYERS = 16, 8, 10
HECO_PAPERS, HECO_AUTHORS, HECO_SUBJECTS = 4019, 7167, 60
HECO_FEAT, HECO_PA_EDGES, HECO_CLASSES = 1902, 13407, 3


def zoo_models(models, agnn_trainer):
    """(name, make, launches a request, launches a step, Adam lr, decay)
    of each zoo model: the twins' lr and decay (0.2 and 5e-6 for SGC, a
    linear model; else 0.01 and 5e-4). A hop is one `spmm_csr` forward;
    backward, one more for each hop whose input carries a gradient (not
    ChebNet's first layer nor MixHop's one conv, which read the raw
    features) and one SDDMM for each hop whose weights carry one (AGNN's
    attention, FAGCN's gates)."""
    class PlannedAGNN(agnn_trainer.Net):
        """The agnn twin's network with the plan handed to its convs (the
        twin, like the JAX trainer, hands it none)."""

        def forward(self, x, edge_index, plan=None, generator=None):
            return self.run(x, edge_index, generator, plan)

    F, C = N_FEAT, N_CLASS
    table = [
        ("sgc", lambda: models.SGCModel(C, itera_k=2, in_channels=F), 2, 4,
         0.2, 5e-6),
        ("appnp", lambda: models.APPNPModel(64, C, alpha=0.1, itera_k=10,
                                            in_channels=F), 10, 20),
        ("gcnii", lambda: models.GCNIIModel(64, C, num_layers=64, alpha=0.1,
                                            lambd=0.5, in_channels=F),
         64, 128),
        ("jknet", lambda: models.JKNet(16, C, num_layers=4, mode="max",
                                       in_channels=F), 4, 8),
        ("chebnet", lambda: models.ChebNetModel(32, C, K=3, in_channels=F),
         4, 6),
        ("mixhop", lambda: models.MixHopModel(60, C, p=(0, 1, 2),
                                              in_channels=F), 2, 2),
        ("gprgnn", lambda: models.GPRGNNModel(64, C, K=10, alpha=0.1,
                                              in_channels=F), 10, 20),
        ("fagcn", lambda: models.FAGCNModel(16, C, num_layers=2,
                                            in_channels=F), 2, 4),
        ("agnn", lambda: PlannedAGNN(16, C, in_channels=F), 2, 4),
    ]
    out = []
    for i, (name, ctor, per_request, per_step, *opt) in enumerate(table):
        lr, l2 = opt if opt else (0.01, 5e-4)

        def make(ctor=ctor, seed=SEED + 300 + i):
            torch.manual_seed(seed)
            return ctor()

        step = {"spmm_csr": per_step}
        if name in ("fagcn", "agnn"):
            step["sddmm_csr"] = 2
        out.append((name, make, {"spmm_csr": per_request}, step, lr, l2))
    return out


def zoo_inputs(x, ei):
    """Labels a propagation model can learn in 5 steps on random edges:
    the argmax of a random linear map of the GCN-smoothed features (one
    hop, the first GCN layer's weights), `train_labels`' mask, and the
    features with twice a random direction of each node's class added
    (as HAN's graph). SGC, one linear map of A_hat^2 X, learns the
    planted labels from the raw features; the others learn them from the
    class directions. Returns (raw x, x with directions, y, mask)."""
    rng = np.random.default_rng(SEED + 30)
    proj, direction = (torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(x.device) for shape in ((N_FEAT, N_CLASS),
                                                (N_CLASS, N_FEAT)))
    w = gcn_weights(ei, x.shape[0])
    smooth = torch.zeros_like(x).index_add_(0, ei[1], x[ei[0]] * w[:, None])
    y = (smooth @ proj).argmax(1)
    return x, x + 2 * direction[y], y, train_labels(x)[1]


def phase_zoo(k, common, models, agnn_trainer, plan, x, ei):
    """Phase 30: each zoo model serves N_REQUESTS requests on the plan
    against the plain COO path (exact `spmm_csr` launches), takes float32
    step-0 gradients on both paths, then N_STEPS Adam steps against the
    plain path under one generator state (exact launches a step: SpMM,
    AGNN's and FAGCN's SDDMM, no fold); a trace of GCNII's step."""
    phase_start("phase 30: the propagation zoo (SGC, APPNP, GCNII, JKNet, "
                "ChebNet, MixHop, GPR-GNN, FAGCN, AGNN) on the arxiv-shape "
                "graph")
    x_raw, x_dir, y, mask = zoo_inputs(x, ei)
    out = {}
    for name, make, per_request, per_step, lr, l2 in zoo_models(
            models, agnn_trainer):
        label = f"zoo {name}"
        xz = x_raw if name == "sgc" else x_dir
        t0 = time.perf_counter()
        model = make().to(x.device)
        counts, lat = serve_requests(
            k, [xz + r * 1e-3 for r in range(N_REQUESTS)],
            lambda xr: common.predict(model, xr, ei, plan=plan),
            lambda xr: common.predict(model, xr, ei), per_request, label,
            (N_NODES, N_CLASS), tol=ZOO_TOL)
        grad_err, _ = f32_step0_grads(k, label, make, common, per_step, plan,
                                      xz, ei, (y, mask))
        launches, losses, step_ms, _, (state, _, _, _) = train_phase(
            k, label, make, common, per_step, lr, l2, plan, xz, ei,
            check_step0=False, labels=(y, mask))
        prof = None
        if name == "gcnii":
            gen = dropout_rng(state.model, SEED + 200)
            prof = profile("gcnii_train", lambda: common.train_step(
                state, xz, ei, y, mask, plan=plan, **gen))
        print(f"  {label}: {time.perf_counter() - t0:.1f} s")
        out[name] = {"serve": counts, "train": launches, "lat": lat,
                     "step_ms": step_ms, "losses": losses,
                     "grad_err": grad_err, "profile": prof}
        del model, state
    torch.cuda.empty_cache()
    return out


def tu_graphs():
    """Phase 29(c)'s TU shape (TU_GRAPHS graphs at ENZYMES' statistics),
    written from the seed into a temporary directory and read back by
    `TUDataset`: the graphs as a list."""
    import shutil
    import tempfile
    from gammagl_tpu_torch.datasets import TUDataset
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tu_")
    try:
        write_tu(os.path.join(tmp, "ENZYMES", "raw"), "ENZYMES",
                 np.random.default_rng(SEED + 31))
        ds = TUDataset(tmp, "ENZYMES")
        return [ds[i] for i in range(len(ds))]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_gin_pools(k, dev):
    """Phase 31: GINModel (COO: the JAX model passes no plan) on each
    `BatchGraph` of TU_BATCH graphs: logits within F32_OUT_TOL of max
    |logit| of the same module in float64 on the card, each graph's row
    against that graph alone; every global pool and `global_sort_pool`
    (k = SORT_K) of random 64-wide node rows against float64; no kernel
    launched."""
    from gammagl_tpu_torch.data import BatchGraph
    from gammagl_tpu_torch.layers import pool
    from gammagl_tpu_torch.models import GINModel
    phase_start("phase 31: GIN and the global pools on TU batches")
    graphs = tu_graphs()
    f = np.asarray(graphs[0].x).shape[1]
    torch.manual_seed(SEED + 31)
    model = GINModel(GIN_HIDDEN, TU_CLASSES, num_layers=GIN_LAYERS,
                     in_channels=f).to(dev).eval()
    model64 = copy.deepcopy(model).double()
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)

    def put(a, dtype=None):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    def run(m, g, dtype, batch=None):
        with torch.no_grad():
            return m(put(g.x, dtype), put(g.edge_index),
                     None if batch is None else put(batch),
                     None if batch is None else g.num_graphs)

    pools = {"sum": pool.global_sum_pool, "add": pool.global_add_pool,
             "mean": pool.global_mean_pool, "max": pool.global_max_pool,
             "min": pool.global_min_pool}
    err = {"logits": 0.0, "alone": 0.0, "pools": 0.0}
    sync()
    reset_counts(k)
    t0 = time.perf_counter()
    for start in range(0, len(graphs), TU_BATCH):
        part = graphs[start:start + TU_BATCH]
        batch = BatchGraph.from_data_list(part)
        b = np.asarray(batch.batch)
        logits = run(model, batch, torch.float32, b)
        if logits.shape != (len(part), TU_CLASSES):
            fail(f"GIN batch logits shape {tuple(logits.shape)}")
        err["logits"] = max(err["logits"], check_close(
            f"GIN batch {start // TU_BATCH} vs float64", logits,
            run(model64, batch, torch.float64, b), 0.0, atol=F32_OUT_TOL))
        alone = torch.cat([run(model, g, torch.float32) for g in part])
        err["alone"] = max(err["alone"], check_close(
            f"GIN batch {start // TU_BATCH}, each graph alone", logits,
            alone, 0.0, atol=F32_OUT_TOL))
        h = torch.randn((batch.num_nodes, GIN_HIDDEN), generator=gen,
                        device=dev)
        tb = put(b)
        for pname, fn in list(pools.items()) + [
                ("sort", lambda v, bb, n: pool.global_sort_pool(v, bb, SORT_K,
                                                                n))]:
            err["pools"] = max(err["pools"], check_close(
                f"global {pname} pool, batch {start // TU_BATCH}",
                fn(h, tb, len(part)), fn(h.double(), tb, len(part)), 0.0,
                atol=F32_OUT_TOL))
    sync()
    seconds = time.perf_counter() - t0
    if any(read_counts(k).values()):
        fail(f"GIN and the pools launched kernels: {read_counts(k)}")
    print(f"  GIN on {len(graphs)} graphs in batches of {TU_BATCH}, each "
          f"graph alone, the pools: {seconds:.2f} s; no kernel launched")
    return {"max_abs_err": err, "seconds": seconds,
            "counts": every_kernel({})}


def to_double(v):
    """Floating tensors (in dicts and lists too) as float64."""
    if isinstance(v, dict):
        return {key: to_double(val) for key, val in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(to_double(val) for val in v)
    if isinstance(v, torch.Tensor) and v.is_floating_point():
        return v.double()
    return v


def coo_path(k, label, make, request, loss, inputs, vary,
             tol=F32_OUT_TOL, n_requests=N_COO_REQUESTS,
             n_steps=N_COO_STEPS, lr=COO_LR):
    """``n_requests`` eval forwards ``request(model, inputs)`` of a COO
    model (``vary(inputs, r)`` gives request r), each held within ``tol``
    of max |out| of the same module in float64, then ``n_steps`` Adam
    steps (``lr``) of ``loss(model, inputs)`` in training mode: no kernel
    may launch, the loss must fall."""
    from gammagl_tpu_torch.train import TrainState
    model = make()
    model64 = copy.deepcopy(model).double().eval()
    lat, err = [], 0.0
    sync()
    reset_counts(k)
    for r in range(n_requests):
        inp = vary(inputs, r)
        model.eval()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = request(model, inp)
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            want = request(model64, to_double(inp))
        err = max(err, check_close(f"{label} request {r} vs float64", out,
                                   want, 0.0, atol=tol))
    del model64
    state = TrainState(model, lr)
    losses, step_ms = [], []
    for _ in range(n_steps):
        model.train()
        t0 = time.perf_counter()
        value = loss(model, inputs)
        value.backward()
        state.apply_gradients()
        losses.append(float(value.detach()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    sync()
    if any(read_counts(k).values()):
        fail(f"{label} launched kernels: {read_counts(k)}")
    print(f"  {label}: request p50 {np.median(lat):.2f} ms; steps "
          f"{[round(t, 2) for t in step_ms]} ms, losses {losses}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"{label}: loss did not fall: {losses}")
    return {"lat": np.asarray(lat), "step_ms": step_ms, "losses": losses,
            "max_abs_err": err, "counts": every_kernel({})}


def heco_acm_graph(dev):
    """HeCo's ACM shape from the seed: each paper has one or more of the
    13,407 author edges and one subject (subjects in 3 blocks of 20, one a
    class); PAP and PSP as the papers that share an author or a subject
    (each paper with itself); positives PAP and the diagonal. Returns
    (x_dict, schema edges, metapath edges, positives) on ``dev``."""
    import scipy.sparse as sp
    rng = np.random.default_rng(SEED + 32)
    P, A, S = HECO_PAPERS, HECO_AUTHORS, HECO_SUBJECTS
    y = rng.integers(0, HECO_CLASSES, P)
    paper = np.concatenate([np.arange(P),
                            rng.integers(0, P, HECO_PA_EDGES - P)])
    author = rng.integers(0, A, HECO_PA_EDGES)
    subject = (S // HECO_CLASSES) * y + rng.integers(0, S // HECO_CLASSES, P)

    def pairs(rows, cols, n):
        """The papers that share a column (an author, a subject)."""
        m = sp.coo_matrix((np.ones(len(cols)), (rows, cols)),
                          shape=(P, n)).tocsr()
        m.data[:] = 1
        pp = (m @ m.T).tocoo()
        return np.stack([pp.row, pp.col]).astype(np.int64)

    pap, psp = pairs(paper, author, A), pairs(np.arange(P), subject, S)
    pos = np.zeros((P, P), bool)
    pos[pap[0], pap[1]] = True
    pos[np.arange(P), np.arange(P)] = True

    def put(a, dtype=None):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    x_dict = {"paper": put(rng.random((P, HECO_FEAT)) < 0.01, torch.float32),
              "author": torch.eye(A, device=dev),
              "subject": torch.eye(S, device=dev)}
    schema = {("author", "writes", "paper"): put(np.stack([author, paper])),
              ("subject", "has", "paper"): put(np.stack([subject,
                                                         np.arange(P)]))}
    print(f"  HeCo ACM shape: {P} papers, {A} authors, {S} subjects; "
          f"P-A {HECO_PA_EDGES}, P-S {P}; PAP {pap.shape[1]}, PSP "
          f"{psp.shape[1]} edges; {int(pos.sum())} positives")
    return x_dict, schema, [put(pap), put(psp)], put(pos)


def phase_hetero_rest(k, models, han_hg, hgt_hg, x, ei, dev):
    """Phase 32: HPN, RoheHAN, ieHGCN, HiD-Net and HeCo, each through
    `coo_path` (the JAX models run no kernel, so neither do these)."""
    from gammagl_tpu_torch.examples import common
    from gammagl_tpu_torch.train import semi_supervised_loss
    phase_start("phase 32: the rest of hetero (HPN, RoheHAN, ieHGCN, "
                "HiD-Net, HeCo) against float64")
    out = {}

    def typed(label, hg, target, ctor, tol=F32_OUT_TOL):
        x_dict, ei_dict, y, mask, _ = common.hetero_tensors(hg, target, dev)

        def make():
            torch.manual_seed(SEED + 32)
            return ctor(hg.metadata()).to(dev)

        def vary(inp, r):
            return {**inp, target: inp[target] + r * 1e-3}

        return coo_path(
            k, label, make, lambda m, inp: m(inp, ei_dict),
            lambda m, inp: semi_supervised_loss(m(inp, ei_dict), y, mask),
            x_dict, vary, tol)

    n_cls = int(np.asarray(han_hg["paper"].y).max()) + 1
    out["hpn"] = typed("HPN", han_hg, "paper", lambda meta: models.HPNModel(
        meta, WAVE2_HIDDEN, n_cls, "paper", in_channels=N_FEAT))
    out["rohehan"] = typed("RoheHAN", han_hg, "paper",
                           lambda meta: models.RoheHANModel(
                               meta, WAVE2_HIDDEN, n_cls, "paper",
                               heads=ROHE_HEADS, in_channels=N_FEAT))
    out["iehgcn"] = typed("ieHGCN", hgt_hg, "paper",
                          lambda meta: models.ieHGCNModel(
                              meta, WAVE2_HIDDEN, HGT_CLASSES, "paper",
                              in_channels=HGT_FEAT), IEHGCN_TOL)
    torch.cuda.empty_cache()
    y, mask = train_labels(x)
    gen = torch.Generator(device=dev)

    def make_hidnet():
        torch.manual_seed(SEED + 33)
        return models.HiDNetModel(64, N_CLASS, num_layers=HIDNET_LAYERS,
                                  in_channels=N_FEAT).to(dev)

    out["hidnet"] = coo_path(
        k, "HiD-Net", make_hidnet, lambda m, inp: m(inp, ei),
        lambda m, inp: semi_supervised_loss(
            m(inp, ei, generator=gen.manual_seed(SEED + 34)), y, mask),
        x, lambda inp, r: inp + r * 1e-3)
    x_dict, schema, mp, pos = heco_acm_graph(dev)
    meta = (["paper", "author", "subject"], list(schema))

    def make_heco():
        torch.manual_seed(SEED + 35)
        return models.HeCoModel(meta, "paper", hidden_dim=64, feat_drop=0.3,
                                tau=0.8, lam=0.5, num_metapaths=2,
                                in_channels={nt: v.shape[1]
                                             for nt, v in x_dict.items()}
                                ).to(dev)

    out["heco"] = coo_path(
        k, "HeCo", make_heco, lambda m, inp: m(inp, schema, mp),
        lambda m, inp: m(inp, schema, mp, pos,
                         generator=gen.manual_seed(SEED + 36)),
        x_dict, lambda inp, r: {**inp, "paper": inp["paper"] + r * 1e-3})
    torch.cuda.empty_cache()
    return out


# the wave-2 zoo (phase 33), COO as in JAX, each model at its JAX
# defaults and its twin's Adam lr, WAVE2_REQUESTS requests within
# F32_OUT_TOL of max |out| of the same module in float64, then
# WAVE2_STEPS steps whose loss must fall: PNAModel (hidden 64, 2 layers,
# the 13 x 128-wide concatenation, dropout 0.3; lr PNA_LR), GaANModel (4
# heads x 16) and the film, gmm, dna and hcha twins' Nets (hidden 16,
# dropout 0.5), lr 0.01, on the arxiv-shape graph (with its self-loops, as
# the twins train; phase 30's planted labels and class directions, scaled
# by WAVE2_X_SCALE); CompGCNModel (hidden 64, 'sub'; lr 0.005) on phase 26's
# flattened typed graph, its three relations as edge types; DGCNNModel
# (hidden 32, k 30; lr 0.005) on a TU batch of phase 31
WAVE2_REQUESTS, WAVE2_STEPS = 8, 5
PNA_HIDDEN, GAAN_HIDDEN, GAAN_HEADS, WAVE2_NET_HIDDEN = 64, 16, 4, 16
COMPGCN_HIDDEN, DGCNN_HIDDEN, DGCNN_K = 64, 32, 30
WAVE2_LR, COMPGCN_LR, DGCNN_LR, WAVE2_X_SCALE = 0.01, 0.005, 0.005, 0.1
# PNA at the PNA paper's Adam lr (Corso et al. 2020), not the pna twin's
# 0.01: Adam's first step moves every weight by the lr, and a PNA map
# reads 13 aggregates a feature (1,664 inputs in the first layer, 832 in
# the second); at 0.01 its loss rose from 3.90 to 24.59 on the first
# step and was 4.55 after the fifth (NVIDIA H100 80GB HBM3, 700.00 W),
# on N(0, 1) features (the arxiv shape's) 10x and more (on the CPU at an
# eighth of the graph, where a tenth of them came back by the fifth step)
PNA_LR = 1e-3


def phase_wave2(k, models, hg, x, ei, dev):
    """Phase 33: the wave-2 models, each through `coo_path` (the JAX
    convs take no plan, so no kernel launches)."""
    import torch.nn.functional as F
    from gammagl_tpu_torch.data import BatchGraph
    from gammagl_tpu_torch.examples import (dna_trainer, film_trainer,
                                            gmm_trainer, hcha_trainer,
                                            simplehgn_trainer)
    from gammagl_tpu_torch.train import semi_supervised_loss
    phase_start("phase 33: the wave-2 zoo (PNA, GaAN, FiLM, GMM, DNA, "
                "HCHA, CompGCN, DGCNN) against float64")
    _, x, y, mask = zoo_inputs(x, ei)  # labels 5 steps can learn
    x = WAVE2_X_SCALE * x
    gen = torch.Generator(device=dev)
    out = {}

    def path(label, seed, ctor, request, loss, inputs, lr):
        def make():
            torch.manual_seed(SEED + seed)
            return ctor().to(dev)

        result = coo_path(k, label, make, request, loss, inputs,
                          lambda inp, r: inp + r * 1e-3,
                          n_requests=WAVE2_REQUESTS, n_steps=WAVE2_STEPS,
                          lr=lr)
        torch.cuda.empty_cache()
        return result

    node = {  # name -> (label, model, whether it drops out, Adam lr)
        "pna": ("PNA", lambda: models.PNAModel(
            PNA_HIDDEN, N_CLASS, in_channels=N_FEAT), True, PNA_LR),
        "gaan": ("GaAN", lambda: models.GaANModel(
            GAAN_HIDDEN, N_CLASS, heads=GAAN_HEADS, in_channels=N_FEAT),
            False, WAVE2_LR),
        "film": ("FiLM", lambda: film_trainer.Net(
            WAVE2_NET_HIDDEN, N_CLASS, 0.5, in_channels=N_FEAT), True,
            WAVE2_LR),
        "gmm": ("GMM", lambda: gmm_trainer.Net(
            WAVE2_NET_HIDDEN, N_CLASS, 0.5, in_channels=N_FEAT), True,
            WAVE2_LR),
        "dna": ("DNA", lambda: dna_trainer.Net(
            WAVE2_NET_HIDDEN, N_CLASS, 0.5, in_channels=N_FEAT), True,
            WAVE2_LR),
        "hcha": ("HCHA", lambda: hcha_trainer.Net(
            WAVE2_NET_HIDDEN, N_CLASS, 0.5, in_channels=N_FEAT), True,
            WAVE2_LR),
    }
    for i, (name, (label, ctor, drops, lr)) in enumerate(node.items()):
        def loss(m, inp, drops=drops, i=i):
            kw = ({"generator": gen.manual_seed(SEED + 340 + i)} if drops
                  else {})
            return semi_supervised_loss(m(inp, ei, **kw), y, mask)

        out[name] = path(label, 330 + i, ctor, lambda m, inp: m(inp, ei),
                         loss, x, lr)

    d = simplehgn_trainer.typed_graph(hg)
    n = d["x"].shape[0]
    ty, tmask = np.zeros(n, np.int64), np.zeros(n, bool)
    ty[:HGT_PAPERS], tmask[:HGT_PAPERS] = d["y"], d["train_mask"]

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    tx, tei, tet = put(d["x"]), put(d["edge_index"]), put(d["edge_type"])
    ty, tmask = put(ty), put(tmask)
    del d
    print(f"  CompGCN on the flattened typed graph: {n} nodes, "
          f"{tei.shape[1]} edges in {int(tet.max()) + 1} types")
    out["compgcn"] = path(
        "CompGCN", 350, lambda: models.CompGCNModel(
            3, COMPGCN_HIDDEN, HGT_CLASSES, in_channels=HGT_FEAT),
        lambda m, inp: m(inp, tei, tet),
        lambda m, inp: semi_supervised_loss(m(inp, tei, tet), ty, tmask),
        tx, COMPGCN_LR)
    del tx, tei, tet, ty, tmask

    part = tu_graphs()[:TU_BATCH]
    batch = BatchGraph.from_data_list(part)
    bx, bei = put(batch.x, torch.float32), put(batch.edge_index)
    bb = put(batch.batch)
    by = put(np.concatenate([np.asarray(g.y).reshape(-1) for g in part]))
    ng = len(part)
    print(f"  DGCNN on a TU batch: {ng} graphs, {batch.num_nodes} nodes, "
          f"{batch.num_edges} edges")
    out["dgcnn"] = path(
        "DGCNN", 360, lambda: models.DGCNNModel(
            DGCNN_HIDDEN, TU_CLASSES, k=DGCNN_K, in_channels=bx.shape[1]),
        lambda m, inp: m(inp, bei, bb, ng),
        lambda m, inp: F.cross_entropy(m(inp, bei, bb, ng), by), bx,
        DGCNN_LR)
    return out



# phase 34: the sampled path on a graph of Reddit's published statistics
# (Hamilton et al. 2017, the GraphSAGE paper; DGL's reddit.zip, which the
# Reddit dataset reads): 232,965 posts, 114,615,892 directed edges, 602
# features, 41 classes, 153,431 / 23,831 / 55,703 train / val / test,
# written in its raw layout from the seed (lognormal degrees, uniform
# sources, each class's direction planted in the features, so the loss
# can fall in 20 steps). Serving: the serving twin's protocol (batches
# of 128, fanouts 10 and 5, hidden 64, bf16 inputs, every row cached),
# SAMPLED_REQUESTS requests, then MICRO_REQUESTS single-node requests from
# the MicroBatcher's client threads. Training: the sage_sample twin's
# defaults (batches of 512, fanouts 25 and 10, hidden 64, dropout 0.5,
# Adam 3e-3, 4 batches a sampler call), SAMPLED_STEPS steps, then one
# EpochCache replay of as many batches; the gpu_sage twin (batches of 64,
# fanouts 8 and 4, hidden 32, half the rows cached) GPU_SAGE_STEPS steps
REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892
REDDIT_FEAT, REDDIT_CLASSES = 602, 41
REDDIT_SPLIT = (153_431, 23_831, 55_703)
REDDIT_SIGNAL = 1.0
SAMPLED_REQUESTS, MICRO_REQUESTS = 50, 48
SAMPLED_STEPS, GPU_SAGE_STEPS, N_PREFETCH_CHECK = 20, 10, 5
# the served logits against the float32 forward of the same blocks on the
# CPU: the card reads bf16 inputs
SAMPLED_SERVE_TOL = 3e-2
# the largest move, as a share of max |pre-activation|, of a first-layer
# pre-activation that the card and the CPU put on opposite sides of 0
# (f32 rounding of a 602-term dot product and a mean is ~1e-7 of it)
FLIP_MOVE_TOL = 1e-5


def host_cpu():
    """The host's CPU model (lscpu's, else /proc/cpuinfo's, else the
    machine's architecture) and the threads its OpenMP runs by default."""
    import platform
    model = None
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        model = next((line.split(":", 1)[1].strip()
                      for line in out.splitlines()
                      if line.startswith("Model name")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    if not model:
        try:
            with open("/proc/cpuinfo") as f:
                model = next((line.split(":", 1)[1].strip() for line in f
                              if line.startswith(("model name", "Model"))),
                             None)
        except OSError:
            pass
    model = model or f"unknown {platform.machine()}"
    return model, int(os.environ.get("OMP_NUM_THREADS") or os.cpu_count())


def write_reddit(raw_dir, rng):
    """Reddit's raw files at its published statistics; returns what was
    written (features, labels, split, and the coalesced edges as sorted
    row * N + col keys)."""
    import scipy.sparse as sp
    n, e = REDDIT_NODES, REDDIT_EDGES
    os.makedirs(raw_dir, exist_ok=True)
    w = rng.lognormal(0.0, 1.0, n)
    deg = np.floor(w / w.sum() * e).astype(np.int64)
    deg[rng.choice(n, e - int(deg.sum()), replace=False)] += 1
    key = np.repeat(np.arange(n, dtype=np.int64), deg) * n
    key += rng.integers(0, n, e)
    key = torch.from_numpy(key).sort().values.numpy()  # rows, then columns
    indptr = np.concatenate([[0], np.cumsum(deg)])
    adj = sp.csr_matrix((np.ones(e, np.float32),
                         (key % n).astype(np.int32), indptr), shape=(n, n))
    sp.save_npz(os.path.join(raw_dir, "reddit_graph.npz"), adj,
                compressed=False)
    del adj
    y = rng.integers(0, REDDIT_CLASSES, n)
    x = rng.standard_normal((n, REDDIT_FEAT), dtype=np.float32)
    x[np.arange(n), y] += REDDIT_SIGNAL
    types = np.full(n, 3, np.int64)
    perm = rng.permutation(n)
    types[perm[:REDDIT_SPLIT[0]]] = 1
    types[perm[REDDIT_SPLIT[0]:REDDIT_SPLIT[0] + REDDIT_SPLIT[1]]] = 2
    np.savez(os.path.join(raw_dir, "reddit_data.npz"), feature=x, label=y,
             node_types=types)
    keep = np.ones(e, bool)
    keep[1:] = key[1:] != key[:-1]
    return {"x": x, "y": y, "types": types, "keys": key[keep]}


def reddit_from_files(k, tmp, rng):
    """(a): write, load through `Reddit`, hold every array to the written
    one; the host seconds of each step."""
    from gammagl_tpu_torch.datasets import Reddit
    from gammagl_tpu_torch.loader import NeighborSamplerLoader
    root = os.path.join(tmp, "reddit")
    t0 = time.perf_counter()
    want = write_reddit(os.path.join(root, "raw"), rng)
    t_write_total = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = Reddit(root=root)[0]
    t_load = time.perf_counter() - t0
    ei = np.asarray(g.edge_index)
    n = REDDIT_NODES
    checks = {
        "x": np.array_equal(g.x, want["x"]) and g.x.dtype == np.float32,
        "y": np.array_equal(g.y, want["y"]),
        "train_mask": np.array_equal(g.train_mask, want["types"] == 1),
        "val_mask": np.array_equal(g.val_mask, want["types"] == 2),
        "test_mask": np.array_equal(g.test_mask, want["types"] == 3),
        "edge_index": (ei.shape == (2, len(want["keys"]))
                       and np.array_equal(ei[0], want["keys"] // n)
                       and np.array_equal(ei[1], want["keys"] % n)),
    }
    if not all(checks.values()) or g.num_nodes != n:
        fail(f"Reddit from files: {checks}, {g.num_nodes} nodes")
    split = tuple(int(np.asarray(g[m]).sum())
                  for m in ("train_mask", "val_mask", "test_mask"))
    if split != REDDIT_SPLIT:
        fail(f"Reddit split {split}")
    # the loader of (c)'s checks and (d)'s prefetch batches: one CSC, built
    # here and timed (each twin builds its own)
    t0 = time.perf_counter()
    loader = NeighborSamplerLoader(ei, sample_lists=[25, 10],
                                   batch_size=512, num_nodes=n, shuffle=True,
                                   seed=SEED + 341, presample_chunks=4)
    t_csc = time.perf_counter() - t0
    print(f"  Reddit shape written ({REDDIT_EDGES} directed edges, "
          f"{ei.shape[1]} kept by coalesce) and read by Reddit, every array "
          f"as written; host seconds: generate + write {t_write_total:.2f}, "
          f"load (parse, coalesce, cache) {t_load:.2f}, sampler CSC "
          f"{t_csc:.2f}")
    return g, loader, {"edges_written": REDDIT_EDGES,
                       "edges_kept": int(ei.shape[1]),
                       "generate_write_s": t_write_total, "load_s": t_load,
                       "csc_s": t_csc}


def sampled_serving(k, g, dev):
    """(b): the serving twin on the Reddit shape; each timed request's
    logits against the float32 forward of its blocks on the CPU."""
    from gammagl_tpu_torch.examples import serving_demo
    args = serving_demo.parser().parse_args(
        ["--batch", "128", "--fanout1", "10", "--fanout2", "5",
         "--requests", str(SAMPLED_REQUESTS), "--micro_requests",
         str(MICRO_REQUESTS), "--device", str(dev)])
    out = serving_demo.main(args, data=(g, REDDIT_CLASSES))
    cpu = copy.deepcopy(out["model"]).cpu().eval()
    err = 0.0
    with torch.no_grad():
        for r, (n_id_p, blocks, sizes, logits) in enumerate(out["records"]):
            want = cpu(torch.from_numpy(g.x[n_id_p]),
                       [(torch.from_numpy(b), s)
                        for b, s in zip(blocks, sizes)])
            if logits.shape != (128, REDDIT_CLASSES):
                fail(f"served logits of shape {tuple(logits.shape)}")
            err = max(err, check_close(
                f"sampled request {r} vs the CPU float32 forward", logits,
                want, 0.0, atol=SAMPLED_SERVE_TOL))
    micro = out["micro"]
    if not (len(micro["outs"]) == MICRO_REQUESTS and all(
            o.shape == (REDDIT_CLASSES,) and np.isfinite(o).all()
            for o in micro["outs"])):
        fail("a MicroBatcher future gave no finite logits of shape (41,)")
    lat, mlat = np.sort(out["lat_ms"]), np.sort(micro["lat_ms"])
    res = {"request_p50_ms": float(np.median(lat)),
           "request_p95_ms": float(lat[int(len(lat) * 0.95)]),
           "request_max_ms": float(lat.max()), "timed": int(len(lat)),
           "sessions": out["sessions"], "max_abs_err": err,
           "micro_p50_ms": float(np.median(mlat)),
           "micro_p95_ms": float(mlat[int(len(mlat) * 0.95)]),
           "micro_wall_ms": micro["wall_ms"],
           "micro_batches": micro["batches"],
           "micro_sessions": micro["sessions"]}
    print(f"  serving: {res['timed']} timed requests, p50 "
          f"{res['request_p50_ms']:.2f} ms, p95 {res['request_p95_ms']:.2f}, "
          f"max {res['request_max_ms']:.2f}, {res['sessions']} sessions; "
          f"MicroBatcher p50 {res['micro_p50_ms']:.2f} ms, p95 "
          f"{res['micro_p95_ms']:.2f}, {len(micro['batches'])} batches "
          f"{micro['batches']}")
    return res


def sampled_training(k, root, g, loader, dev):
    """(c): the sage_sample twin from the staged files for SAMPLED_STEPS
    steps and its test protocol; float32 step-0 gradients against the
    CPU; an EpochCache replay of SAMPLED_STEPS batches, bitwise the cached
    ones; the sampler's ms a batch. ``loader``: (a)'s, at the twin's
    fanouts and batch."""
    from gammagl_tpu_torch.examples import sage_sample_trainer as twin
    from gammagl_tpu_torch.loader import EpochCache
    from gammagl_tpu_torch.models import GraphSAGESampleModel
    args = twin.parser().parse_args(["--dataset_path", root, "--device",
                                     str(dev)])
    t0 = time.perf_counter()
    staged, n_class = twin.load(args)
    t_cache = time.perf_counter() - t0
    if n_class != REDDIT_CLASSES or not np.array_equal(staged.edge_index,
                                                       g.edge_index):
        fail("the twin's staged Reddit differs from the files' graph")
    del staged
    out = twin.main(args, data=(g, n_class), steps=SAMPLED_STEPS)
    losses = out["losses"]
    if not (np.isfinite(losses).all()
            and losses[-1] <= (1 - MIN_FALL) * losses[0]):
        fail(f"sage_sample twin: loss did not fall by {MIN_FALL:.0%}: "
             f"{losses}")
    with_host = np.add(out["batch_ms"], out["step_ms"])
    fcache = out["cache"]

    # float32 step-0 gradients, dropout off, card against the CPU. Where
    # a first-layer pre-activation sits within f32 rounding of 0 the two
    # sum orders can take opposite ReLU branches, and that unit's gradient
    # then moves by a whole upstream term (~|W| / (fanout x batch), some
    # 1e-3 of max |grad|). So the CPU path takes the card's branch there:
    # its pre-activation is moved to the card's value (the move must be
    # rounding, FLIP_MOVE_TOL of max |pre-activation|), its gradient
    # untouched, and every gradient is held at F32_GRAD_TOL
    train_idx = np.nonzero(g.train_mask)[0]
    batch = loader.sample(train_idx[:512])
    torch.manual_seed(SEED + 340)
    model = GraphSAGESampleModel(64, REDDIT_CLASSES, drop_rate=0.0,
                                 in_channels=REDDIT_FEAT)
    cpu = copy.deepcopy(model)
    pre, flips = [], {}

    def keep(mod, inp, out):
        pre.append(out.detach().cpu())

    def card_branch(mod, inp, out):
        flip = (out > 0) != (pre[0] > 0)
        moved = (pre[0] - out).detach() * flip
        flips.update(n=int(flip.sum()), move=float(moved.abs().max()),
                     scale=float(out.detach().abs().max()))
        return out + moved

    model.convs[0].register_forward_hook(keep)
    cpu.convs[0].register_forward_hook(card_branch)
    feats, eis, sizes, y = twin.device_batch(*batch, fcache, g.y)
    twin.loss_of(model.to(dev).train(), feats, eis, sizes, y)[0].backward()
    n_id_p, ceis, _ = twin.pad_batch_ids(*batch)
    twin.loss_of(cpu.train(), torch.from_numpy(g.x[n_id_p]),
                 [torch.from_numpy(e) for e in ceis], sizes,
                 torch.from_numpy(g.y[batch[1][:512]]))[0].backward()
    if flips["move"] > FLIP_MOVE_TOL * flips["scale"]:
        fail(f"first-layer pre-activations of the card and the CPU differ "
             f"by {flips['move']:.3e} across 0 (max {flips['scale']:.3e})")
    grad_err = 0.0
    for (name, pc), pg in zip(cpu.named_parameters(), model.parameters()):
        scale = float(pc.grad.abs().max())
        d = float((pg.grad.cpu() - pc.grad).abs().max())
        grad_err = max(grad_err, d / scale)
        if d > F32_GRAD_TOL * scale:
            fail(f"sampled step-0 gradient {name}: {d:.3e} > "
                 f"{F32_GRAD_TOL:g} x {scale:.3e}")

    # the sampler alone: one batch, and a call of 4 batches
    seeds = [train_idx[i * 512:(i + 1) * 512] for i in range(4)]
    sampler = loader._sampler
    t0 = time.perf_counter()
    for s in seeds:
        sampler.sample_from_nodes(s)
    one_ms = (time.perf_counter() - t0) * 1e3 / 4
    t0 = time.perf_counter()
    sampler.sample_from_nodes_many(seeds)
    many_ms = (time.perf_counter() - t0) * 1e3 / 4

    # EpochCache: epoch 0 samples and is kept, epoch 1 replays it
    state = out["state"]
    rng = np.random.default_rng(SEED + 342)
    loader.node_idx = rng.permutation(train_idx)[:SAMPLED_STEPS * 512]
    cache = EpochCache(loader, resample_every=2, seed=SEED + 344)
    first = list(cache)
    kept = [(n_id.copy(), [(a.edge_index.copy(), a.e_id.copy(), a.size)
                           for a in adjs]) for _, n_id, adjs in first]
    replay_ms = []
    for item in cache:
        j = next(i for i, f in enumerate(first) if f is item)
        bs, n_id, adjs = item
        same = np.array_equal(n_id, kept[j][0]) and all(
            np.array_equal(a.edge_index, e) and np.array_equal(a.e_id, i)
            and a.size == s for a, (e, i, s) in zip(adjs, kept[j][1]))
        if not same:
            fail(f"EpochCache replayed batch {j} differs from the cached one")
        t0 = time.perf_counter()
        feats, eis, sizes, y = twin.device_batch(bs, n_id, adjs, fcache,
                                                 g.y)
        state.model.train()
        loss, _ = twin.loss_of(state.model, feats, eis, sizes, y)
        loss.backward()
        state.apply_gradients()
        float(loss.detach())
        replay_ms.append((time.perf_counter() - t0) * 1e3)
    # where a step's device time goes: 3 steps on one cached batch
    fixed = twin.device_batch(*first[0], fcache, g.y)

    def train_once():
        state.model.train()
        loss, _ = twin.loss_of(state.model, *fixed)
        loss.backward()
        state.apply_gradients()

    prof = profile("sampled_train", train_once)
    cpu_model, threads = host_cpu()
    res = {"losses": losses, "test_acc": out["test_acc"],
           "profile": prof,
           "step_ms_median": float(np.median(out["step_ms"][1:])),
           "step_with_host_ms_median": float(np.median(with_host[1:])),
           "step_with_host_ms_mean": float(np.mean(with_host[1:])),
           "batch_ms": out["batch_ms"], "step_ms": out["step_ms"],
           "replay_step_ms_median": float(np.median(replay_ms)),
           "replayed": len(replay_ms),
           "sampler_ms_a_batch": one_ms,
           "sampler_ms_a_batch_in_calls_of_4": many_ms,
           "step0_f32_grad_rel_err": grad_err,
           "step0_relu_inputs_across_0": flips["n"],
           "step0_relu_inputs_moved_by": flips["move"],
           "staged_cache_load_s": t_cache,
           "host_cpu": cpu_model, "omp_threads": threads}
    print(f"  training: {len(losses)} steps, losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; median step {res['step_ms_median']:.2f} ms, "
          f"with sampling and padding {res['step_with_host_ms_median']:.2f} "
          f"(mean {res['step_with_host_ms_mean']:.2f}); replay step "
          f"{res['replay_step_ms_median']:.2f} ms over {len(replay_ms)} "
          f"batches, bitwise the cached ones; sampler {one_ms:.2f} ms a "
          f"batch ({many_ms:.2f} in calls of 4) on {cpu_model}, {threads} "
          f"OpenMP threads; step-0 f32 gradients {grad_err:.3e} of max "
          f"|grad| ({flips['n']} first-layer ReLU inputs on opposite sides "
          f"of 0 on the two paths, within {flips['move']:.3e} of it: the CPU "
          f"took the card's branch there); test acc {out['test_acc']:.4f}")
    return res


def sampled_loaders(k, g, loader, dev):
    """(d): the gpu_sage twin with half the rows cached (hits and misses
    as the host counts them, every gathered row bitwise x[n_id]), and
    PrefetchLoader batches (subgraphs of (a)'s sampler) bitwise the same
    batches moved at once."""
    from gammagl_tpu_torch.examples import gpu_sage_trainer
    from gammagl_tpu_torch.loader import NodeLoader, PrefetchLoader
    args = gpu_sage_trainer.parser().parse_args(["--device", str(dev)])
    seen = []
    out = gpu_sage_trainer.main(
        args, data=(g, REDDIT_CLASSES), steps=GPU_SAGE_STEPS,
        on_batch=lambda n_id, x: seen.append(
            (n_id, bool(torch.equal(x.cpu(), torch.from_numpy(g.x[n_id]))))))
    cache = out["cache"]
    hits = sum(int((cache.slot_of[n_id] >= 0).sum()) for n_id, _ in seen)
    total = sum(len(n_id) for n_id, _ in seen)
    if (cache.hits, cache.misses) != (hits, total - hits) or not all(
            ok for _, ok in seen) or cache.misses == 0:
        fail(f"gpu_sage twin's cache: {cache.hits} hits, {cache.misses} "
             f"misses (host {hits}, {total - hits}); rows bitwise "
             f"{[ok for _, ok in seen]}")
    batches = []
    for sub in NodeLoader(g, loader._sampler, batch_size=64,
                          seed=SEED + 345):
        batches.append(sub)
        if len(batches) == N_PREFETCH_CHECK:
            break
    want = [b.tensor(dev) for b in batches]
    for a, b in zip(PrefetchLoader(batches, size=2, device=dev), want):
        for key in b.keys():
            same = (torch.equal(a[key], b[key])
                    if isinstance(b[key], torch.Tensor) else a[key] == b[key])
            if not same:
                fail(f"PrefetchLoader batch field {key} differs")
    print(f"  gpu_sage twin: {len(out['losses'])} steps, losses "
          f"{[round(v, 4) for v in out['losses']]}; cache {cache.hits} hits "
          f"and {cache.misses} misses as counted on the host, every row "
          f"bitwise; {N_PREFETCH_CHECK} PrefetchLoader batches bitwise")
    return {"gpu_sage_losses": out["losses"], "cache_hits": cache.hits,
            "cache_misses": cache.misses, "hit_rate": cache.hit_rate}


def phase_sampled(k, smi):
    """Phase 34: the sampled path on Reddit's shape, from files: serving
    behind the MicroBatcher, training, the loaders on the card. No kernel
    of the 15 runs: the sampled blocks take no plan, as in JAX."""
    import shutil
    import tempfile
    phase_start("phase 34: sampled serving and training on the Reddit shape "
                "(files -> Reddit -> serving twin and MicroBatcher, "
                "sage_sample twin and EpochCache, gpu_sage twin)")
    os.environ["GGL_TPU_OFFLINE"] = "1"
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_reddit_")
    rng = np.random.default_rng(SEED + 300)
    sync()
    reset_counts(k)
    try:
        g, loader, data = reddit_from_files(k, tmp, rng)
        serving = sampled_serving(k, g, dev)
        training = sampled_training(k, os.path.join(tmp, "reddit"), g,
                                    loader, dev)
        loaders = sampled_loaders(k, g, loader, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sync()
    counts = read_counts(k)
    if any(counts.values()):
        fail(f"phase 34 launched kernels: {counts}")
    torch.cuda.empty_cache()
    print(f"  ({smi}; host {training['host_cpu']}, "
          f"{training['omp_threads']} OpenMP threads)")
    return {"counts": counts, "data": data, "serving": serving,
            "training": training, "loaders": loaders}


# phase 35: the rest of the datasets and the self-supervised family
# DGI's published width (Velickovic et al. 2019; DGIModel's and GGDModel's
# default) on the arxiv shape and on Flickr's; the other models at their
# trainers' defaults on a graph of Cora's published statistics (the
# adjacency itself is not in the repository, so it is drawn from the seed)
SSL_WIDE, SSL_STEPS, SSL_FLICKR_STEPS, SSL_REQUESTS = 512, 5, 3, 3
# Adam's rate for the steps of the models that score nodes against a
# summary or a sum (DGI, GGD, MVGRL): at their trainers' 1e-3, Adam's first
# step moves each entry of the discriminator (512 x 512 for DGI) and of
# the encoder by the rate, every score jumps, and the loss oscillates
# about ln 4 for ~20 steps before it falls (measured on the CPU: DGI and
# GGD at 20,000 nodes of the arxiv generator, MVGRL at Cora's shape); at
# 1e-5 it falls from the first step. The twins run at their own rates.
SSL_DISC_LR = 1e-5
CORA_NODES, CORA_EDGES, CORA_FEAT, CORA_CLASSES = 2708, 10556, 1433, 7
CORA_HOMOPHILY = 0.81
WIKICS_NODES, WIKICS_FEAT, WIKICS_EDGES, WIKICS_CLASSES = (11_701, 300,
                                                           216_123, 10)
FLICKR_NODES, FLICKR_FEAT, FLICKR_EDGES, FLICKR_CLASSES = (89_250, 500,
                                                           899_756, 7)
# card against the port's own code on the CPU, float32: outputs within
# SSL_OUT_TOL of max |out|, losses within SSL_LOSS_RTOL
SSL_OUT_TOL, SSL_LOSS_RTOL = 1e-4, 1e-4


def _pairs(rng, n, m):
    """``m`` distinct node pairs i < j, drawn from the seed."""
    out = np.empty((0, 2), np.int64)
    while len(out) < m:
        ab = np.sort(rng.integers(0, n, (2 * (m - len(out)) + 64, 2)), 1)
        ab = ab[ab[:, 0] != ab[:, 1]]
        out = np.unique(np.concatenate([out, ab]), axis=0)
    return out[rng.permutation(len(out))[:m]]


def write_wikics(raw_dir, rng):
    """WikiCS's ``data.json`` at its published statistics: 11,701 nodes,
    300 features, 10 classes, 20 train / val / stopping mask columns; the
    links one self-loop and 108,061 pairs, so the undirected graph holds
    216,123 edges."""
    n = WIKICS_NODES
    pairs = _pairs(rng, n, (WIKICS_EDGES - 1) // 2)
    links = [[] for _ in range(n)]
    for a, b in pairs.tolist():
        links[a].append(b)
    links[0].append(0)
    os.makedirs(raw_dir, exist_ok=True)
    data = {"features": np.round(rng.random((n, WIKICS_FEAT)), 4).tolist(),
            "labels": rng.integers(0, WIKICS_CLASSES, n).tolist(),
            "links": links,
            "train_masks": (rng.random((20, n)) < 0.05).tolist(),
            "val_masks": (rng.random((20, n)) < 0.15).tolist(),
            "stopping_masks": (rng.random((20, n)) < 0.15).tolist(),
            "test_mask": (rng.random(n) < 0.5).tolist()}
    with open(os.path.join(raw_dir, "data.json"), "w") as f:
        json.dump(data, f)


def write_flickr(raw_dir, rng):
    """Flickr's GraphSAINT files at its published statistics: 89,250
    nodes, 500 features (~180 MB), a symmetric ``adj_full.npz`` of 899,756
    entries, 7 classes, the 50 / 25 / 25 split."""
    import scipy.sparse as sp
    n = FLICKR_NODES
    ab = _pairs(rng, n, FLICKR_EDGES // 2)
    adj = sp.coo_matrix((np.ones(2 * len(ab), np.float32),
                         (np.concatenate([ab[:, 0], ab[:, 1]]),
                          np.concatenate([ab[:, 1], ab[:, 0]]))),
                        shape=(n, n)).tocsr()
    os.makedirs(raw_dir, exist_ok=True)
    np.savez(os.path.join(raw_dir, "adj_full.npz"), data=adj.data,
             indices=adj.indices, indptr=adj.indptr,
             shape=np.asarray(adj.shape))
    np.save(os.path.join(raw_dir, "feats.npy"),
            rng.normal(size=(n, FLICKR_FEAT)).astype(np.float32))
    with open(os.path.join(raw_dir, "class_map.json"), "w") as f:
        json.dump({str(i): int(c) for i, c in enumerate(
            rng.integers(0, FLICKR_CLASSES, n))}, f)
    perm = rng.permutation(n)
    tr, va = n // 2, n // 2 + n // 4
    with open(os.path.join(raw_dir, "role.json"), "w") as f:
        json.dump({"tr": perm[:tr].tolist(), "va": perm[tr:va].tolist(),
                   "te": perm[va:].tolist()}, f)


def write_small_datasets(root, rng):
    """The other twelve classes' raw layouts at fixture size, each under
    ``root/<class>``. Returns {class: (constructor keywords, its root)}."""
    import pickle
    import scipy.sparse as sp
    from scipy import io as sio

    def raw(name, *sub):
        path = os.path.join(root, name, *sub)
        os.makedirs(path, exist_ok=True)
        return path

    out = {}
    for cls, name, sparse in (("WebKB", "cornell", False),
                              ("WikipediaNetwork", "chameleon", False),
                              ("Actor", "film", True)):
        d = raw(cls, name, "raw")
        n = 20
        lines = ["node_id\tfeature\tlabel"]
        for i in range(n):
            feats = (",".join(str(v) for v in sorted(set(
                rng.integers(0, 932, 4).tolist()))) if sparse else
                ",".join(f"{v:.3f}" for v in rng.random(6)))
            lines.append(f"{i}\t{feats}\t{rng.integers(0, 3)}")
        with open(os.path.join(d, "out1_node_feature_label.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(d, "out1_graph_edges.txt"), "w") as f:
            f.write("\n".join(["src\tdst"] + [f"{a}\t{b}" for a, b in
                                              rng.integers(0, n, (40, 2))])
                    + "\n")
        for i in range(10):
            m = rng.integers(0, 3, n)
            np.savez(os.path.join(d, f"{name}_split_0.6_0.2_{i}.npz"),
                     train_mask=(m == 0).astype(np.uint8),
                     val_mask=(m == 1).astype(np.uint8),
                     test_mask=(m == 2).astype(np.uint8))
        out[cls] = ({} if cls == "Actor" else {"name": name},
                    os.path.join(root, cls))
    d = raw("PPI", "raw")
    for split in ("train", "valid", "test"):
        links = [{"source": int(a) + 6 * g, "target": int(b) + 6 * g}
                 for g in range(2) for a, b in rng.integers(0, 6, (10, 2))]
        with open(os.path.join(d, f"{split}_graph.json"), "w") as f:
            json.dump({"links": links}, f)
        np.save(os.path.join(d, f"{split}_feats.npy"),
                rng.random((12, 50)).astype(np.float32))
        np.save(os.path.join(d, f"{split}_labels.npy"),
                rng.integers(0, 2, (12, 121)).astype(np.float32))
        np.save(os.path.join(d, f"{split}_graph_id.npy"),
                np.repeat([1, 2], 6))
    out["PPI"] = ({"split": "train"}, os.path.join(root, "PPI"))
    d = raw("Yelp", "raw")
    n = 30
    adj = sp.csr_matrix((rng.random((n, n)) < 0.2).astype(np.float32))
    np.savez(os.path.join(d, "adj_full.npz"), data=adj.data,
             indices=adj.indices, indptr=adj.indptr,
             shape=np.asarray(adj.shape))
    np.save(os.path.join(d, "feats.npy"), rng.random((n, 300)))
    with open(os.path.join(d, "class_map.json"), "w") as f:
        json.dump({str(i): rng.integers(0, 2, 100).tolist()
                   for i in range(n)}, f)
    ids = rng.permutation(n)
    with open(os.path.join(d, "role.json"), "w") as f:
        json.dump({"tr": ids[:20].tolist(), "va": ids[20:25].tolist(),
                   "te": ids[25:].tolist()}, f)
    out["Yelp"] = ({}, os.path.join(root, "Yelp"))
    try:
        import h5py
    except ImportError:
        h5py = None
    if h5py is not None:
        d = raw("ModelNet40", "raw")
        for split, k in (("train", 4), ("test", 2)):
            with h5py.File(os.path.join(d, f"ply_data_{split}0.h5"),
                           "w") as f:
                f["data"] = rng.random((k, 2048, 3)).astype(np.float32)
                f["label"] = rng.integers(0, 40, (k, 1))
        out["ModelNet40"] = ({"split": "train"},
                             os.path.join(root, "ModelNet40"))
    d = raw("ShapeNet", "raw")
    from gammagl_tpu_torch.datasets import ShapeNet
    for cid in ShapeNet.category_ids.values():
        os.makedirs(os.path.join(d, cid), exist_ok=True)
    os.makedirs(os.path.join(d, "train_test_split"), exist_ok=True)
    cat = ShapeNet.category_ids["Airplane"]
    for split, count in (("train", 2), ("val", 1), ("test", 1)):
        names = []
        for i in range(count):
            np.savetxt(os.path.join(d, cat, f"{split}{i}.txt"),
                       np.hstack([rng.normal(size=(64, 6)),
                                  rng.integers(0, 4, (64, 1))]))
            names.append(f"shape_data/{cat}/{split}{i}")
        with open(os.path.join(d, "train_test_split",
                               f"shuffled_{split}_file_list.json"),
                  "w") as f:
            json.dump(names, f)
    out["ShapeNet"] = ({"categories": "Airplane", "split": "trainval"},
                       os.path.join(root, "ShapeNet"))
    proc = raw("NGSIM_US_101", "ngsim", "processed", "train")
    open(os.path.join(raw("NGSIM_US_101", "ngsim", "raw", "train"),
                      "train.zip"), "wb").close()
    for i in range(3):
        with open(os.path.join(proc, f"sample_{i}.pkl"), "wb") as f:
            pickle.dump({"x": rng.normal(size=(5, 10, 2)).astype(np.float32),
                         "edge_attr": rng.normal(size=(2, 7)).astype(
                             np.float32),
                         "edge_type": rng.integers(0, 3, (2, 7))}, f)
    out["NGSIM_US_101"] = ({"name": "train"},
                           os.path.join(root, "NGSIM_US_101"))
    d = raw("ACM4DHN", "raw")
    with open(os.path.join(d, "MA.txt"), "w") as f:
        f.write("\n".join(f"M{rng.integers(0, 20)} A{rng.integers(0, 30)}"
                          for _ in range(50)))
    out["ACM4DHN"] = ({}, os.path.join(root, "ACM4DHN"))
    d = raw("ACM4Rohe", "raw")
    n_p = 40
    sio.savemat(os.path.join(d, "ACM.mat"), {
        "PvsL": sp.random(n_p, 8, 0.2, random_state=1, format="csr"),
        "PvsA": sp.random(n_p, 15, 0.2, random_state=2, format="csr"),
        "PvsT": sp.random(n_p, 12, 0.3, random_state=3, format="csr"),
        "PvsC": sp.csr_matrix((np.ones(n_p), (np.arange(n_p), rng.choice(
            [0, 1, 9, 10, 13], n_p))), shape=(n_p, 14))})
    out["ACM4Rohe"] = ({}, os.path.join(root, "ACM4Rohe"))
    d = raw("ADDataset", "inj_cora", "raw")
    np.savez(os.path.join(d, "inj_cora.npz"),
             edge_index=rng.integers(0, 20, (2, 60)),
             x=rng.normal(size=(20, 8)).astype(np.float32),
             y=rng.integers(0, 2, 20))
    out["ADDataset"] = ({"name": "inj_cora"}, os.path.join(root,
                                                           "ADDataset"))
    d = raw("AliRCD", "raw")
    emb = ":".join(f"{v:.4f}" for v in rng.random(256))
    with open(os.path.join(d, "AliRCD_session1_nodes.csv"), "w") as f:
        f.write("\n".join([f"{i},item,{emb}" for i in range(6)]
                          + [f"{i},user," for i in range(6, 10)]))
    with open(os.path.join(d, "AliRCD_session1_edges.csv"), "w") as f:
        f.write("\n".join(f"{i + 6},{i},user,item,clicks" for i in range(4)))
    with open(os.path.join(d, "AliRCD_session1_train_labels.csv"), "w") as f:
        f.write("0,1\n1,0\n2,1\n")
    out["AliRCD"] = ({}, os.path.join(root, "AliRCD"))
    return out


def ssl_datasets(dev, tmp, rng):
    """(a): WikiCS and Flickr from raw files at their published shapes,
    read by their classes and moved to the card; the other twelve classes
    at fixture size. Returns (Flickr's arrays on the card, figures)."""
    from gammagl_tpu_torch import datasets as D
    figures = {}
    loaded = {}
    for cls, write, want in (
            ("WikiCS", write_wikics, (WIKICS_NODES, WIKICS_FEAT,
                                      WIKICS_EDGES, WIKICS_CLASSES)),
            ("Flickr", write_flickr, (FLICKR_NODES, FLICKR_FEAT,
                                      FLICKR_EDGES, FLICKR_CLASSES))):
        root = os.path.join(tmp, cls)
        t0 = time.perf_counter()
        write(os.path.join(root, "raw"), rng)
        t1 = time.perf_counter()
        g = getattr(D, cls)(root=root)[0]
        t2 = time.perf_counter()
        y = np.asarray(g.y)
        got = (g.num_nodes, np.asarray(g.x).shape[1], g.num_edges,
               int(y.max()) + 1)
        if got != want:
            fail(f"{cls} loaded as (nodes, features, edges, classes) "
                 f"{got}, want {want}")
        on_card = {k: torch.from_numpy(np.asarray(g[k])).to(dev)
                   for k in ("x", "edge_index", "y", "train_mask",
                             "val_mask", "test_mask")}
        sync()
        t3 = time.perf_counter()
        loaded[cls] = on_card
        figures[cls] = {"write_s": t1 - t0, "load_s": t2 - t1,
                        "to_card_s": t3 - t2, "shape": list(got)}
        print(f"  {cls}: {got[0]} nodes, {got[1]} features, {got[2]} "
              f"edges, {got[3]} classes; written {t1 - t0:.2f} s, read "
              f"{t2 - t1:.2f} s, to the card {t3 - t2:.2f} s")
    small = write_small_datasets(os.path.join(tmp, "small"), rng)
    t0 = time.perf_counter()
    for cls, (kw, root) in small.items():
        ds = getattr(D, cls)(root=root, **kw)
        if len(ds) == 0:
            fail(f"{cls} loaded no item")
        x = getattr(ds[0], "_store", {}).get("x")
        if x is not None:
            torch.as_tensor(np.asarray(x)).to(dev)
    missing = sorted({"WebKB", "WikipediaNetwork", "Actor", "PPI", "Yelp",
                      "ModelNet40", "ShapeNet", "NGSIM_US_101", "ACM4DHN",
                      "ACM4Rohe", "ADDataset", "AliRCD"} - set(small))
    print(f"  {len(small)} more classes at fixture size read in "
          f"{time.perf_counter() - t0:.2f} s"
          + (f"; not read: {missing} (h5py is not installed here)"
             if missing else ""))
    figures["small"] = {"read": sorted(small), "not_read": missing}
    return loaded["Flickr"], figures


def ssl_check(label, make, request, loss, draw, cpu_draws, trace=None):
    """One model: its loss at init from CPU-made draws on the card
    against the CPU (SSL_LOSS_RTOL), SSL_STEPS Adam steps on the card
    with fresh card draws, the loss of the init's draws again (it must
    have fallen: the steps' own losses move with their draws), then
    SSL_REQUESTS eval requests, the last held against the CPU at
    SSL_OUT_TOL of max |out|.
    ``make()`` gives (model, lr) on the CPU; ``request(model, dev)`` and
    ``loss(model, dev, draws)`` run it on ``dev``'s inputs; ``draw(gen)``
    makes a step's draws with ``gen``; ``cpu_draws`` the init's. With
    ``trace`` (a name), 3 more steps are traced with torch.profiler and
    the share of the COO gather's backward (`indexing_backward_kernel`)
    in the step's device time is printed."""
    from gammagl_tpu_torch.train import TrainState
    dev = torch.device("cuda")
    model, lr = make()
    cpu = copy.deepcopy(model).eval()
    model = model.to(dev).eval()  # dropout off for the comparison
    with torch.no_grad():
        got = float(loss(model, dev, cpu_draws))
        want = float(loss(cpu, "cpu", cpu_draws))
    if not abs(got - want) <= SSL_LOSS_RTOL * abs(want):
        fail(f"{label}: init loss on the card {got!r} vs the CPU {want!r}")
    state = TrainState(model, lr)
    gen = torch.Generator(device=dev).manual_seed(SEED + 35)
    losses, step_ms = [], []
    for _ in range(SSL_STEPS):
        sync()
        t0 = time.perf_counter()
        model.train()
        value = loss(model, dev, draw(gen))
        value.backward()
        state.apply_gradients()
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(value.detach()))
    prof = None
    if trace is not None:
        def step():
            model.train()
            loss(model, dev, draw(gen)).backward()
            state.apply_gradients()
        prof = profile(trace, step)
        prof["indexing_backward_share"] = sum(
            us for name, us in prof["by_kernel_us"].items()
            if "indexing_backward_kernel" in name) / prof["busy_us"]
        print(f"  {label}: indexing_backward_kernel "
              f"{prof['indexing_backward_share']:.3f} of the step's device "
              "time")
    model.eval()
    with torch.no_grad():
        final = float(loss(model, dev, cpu_draws))
    lat = []
    for _ in range(SSL_REQUESTS):
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = request(model, dev)
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    with torch.no_grad():
        ref = request(cpu, "cpu")
    err = check_close(f"{label} request vs the CPU", out.cpu(), ref, 0.0,
                      atol=SSL_OUT_TOL)
    print(f"  {label}: loss of the init's draws {got:.6f} (CPU "
          f"{want:.6f}) -> {final:.6f} after the steps; steps "
          f"{[round(t, 2) for t in step_ms]} ms, losses "
          f"{[round(v, 5) for v in losses]}; request p50 "
          f"{np.median(lat):.2f} ms")
    if not (np.isfinite(losses).all() and final < got):
        fail(f"{label}: loss did not fall: {got} -> {final} ({losses})")
    return {"init_loss": got, "init_loss_cpu": want, "final_loss": final,
            "losses": losses, "step_ms": step_ms, "request_ms": lat,
            "max_abs_err": err, "profile": prof, "model": model}


def corruption_check(label, cls, x, ei, lr, hidden, views=(), trace=None):
    """DGI / GGD / MVGRL at ``hidden`` on (x, ei) (CPU tensors; the card
    copies made once) through `ssl_check`."""
    from gammagl_tpu_torch.models import corrupt_features
    n = x.shape[0]
    on = {"cpu": (x, ei, *views)}
    on["cuda"] = tuple(v.to("cuda") for v in on["cpu"])

    def inputs(dev):
        return on["cuda" if str(dev).startswith("cuda") else "cpu"]

    def make():
        torch.manual_seed(SEED + 35)
        return cls(hidden_dim=hidden, in_channels=x.shape[1]), lr

    def loss(m, dev, perm):
        xx, e, *v = inputs(dev)
        return m(xx, e, *v, corrupt_features(xx, perm=perm))

    return ssl_check(label, make, lambda m, dev: m(*inputs(dev)), loss,
                     lambda gen: torch.randperm(n, generator=gen,
                                                device=gen.device),
                     torch.randperm(n, generator=torch.Generator()
                                    .manual_seed(SEED + 35)), trace)


def cora_shape(rng):
    """A graph of Cora's published statistics from the seed: 2,708 nodes,
    5,278 undirected pairs (10,556 directed edges), 81% of them inside a
    class (Cora's edge homophily), 1,433 binary features (1.27% set, as in
    Cora) with a class signal, 7 classes; Planetoid's split (20 a class,
    500 validation, 1,000 test). numpy arrays."""
    n = CORA_NODES
    y = rng.integers(0, CORA_CLASSES, n)
    members = [np.nonzero(y == c)[0] for c in range(CORA_CLASSES)]
    m = CORA_EDGES // 2
    pairs = set()
    while len(pairs) < m:
        a = int(rng.integers(0, n))
        b = (int(rng.choice(members[y[a]])) if rng.random() < CORA_HOMOPHILY
             else int(rng.integers(0, n)))
        if a != b:
            pairs.add((min(a, b), max(a, b)))
    ab = np.asarray(sorted(pairs), np.int64).T
    ei = np.concatenate([ab, ab[::-1]], 1)
    x = (rng.random((n, CORA_FEAT)) < 0.0127).astype(np.float32)
    x[np.arange(n), 200 * y + rng.integers(0, 200, n)] = 1.0
    perm = rng.permutation(n)
    masks = {k: np.zeros(n, bool) for k in ("train_mask", "val_mask",
                                            "test_mask")}
    for c in range(CORA_CLASSES):
        masks["train_mask"][perm[y[perm] == c][:20]] = True
    rest = perm[~masks["train_mask"][perm]]
    masks["val_mask"][rest[:500]] = True
    masks["test_mask"][rest[500:1500]] = True
    return {"x": x, "edge_index": ei, "y": y, **masks}


def phase_ssl(k, smi, x, ei):
    """Phase 35: the rest of the datasets from files, and the
    self-supervised family (DGI, GGD, GRACE, MVGRL, VGAE, Specformer,
    MGNNI, InfoGraph) on the card, each against the CPU; COO, as in JAX:
    no kernel launches."""
    import shutil
    import tempfile
    from gammagl_tpu_torch import models as M
    from gammagl_tpu_torch.data import BatchGraph
    from gammagl_tpu_torch.examples import (common, dgi_trainer,
                                            ggd_trainer, grace_trainer,
                                            mgnni_trainer, mvgrl_trainer,
                                            specformer_trainer, vgae_trainer)
    from gammagl_tpu_torch.train import TrainState, semi_supervised_loss
    from gammagl_tpu_torch.utils import add_self_loops
    phase_start("phase 35: the rest of the datasets (WikiCS, Flickr at "
                "their shapes; twelve more) and the self-supervised family")
    os.environ["GGL_TPU_OFFLINE"] = "1"
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 35)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssl_")
    out = {}
    sync()
    reset_counts(k)
    t_phase = time.perf_counter()
    try:
        flickr, out["datasets"] = ssl_datasets(dev, tmp, rng)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # (b) DGI and GGD at 512 on the arxiv shape, DGI on Flickr
    cx, cei = x.cpu(), ei.cpu()
    for name, cls in (("dgi_arxiv", M.DGIModel), ("ggd_arxiv", M.GGDModel)):
        out[name] = corruption_check(
            f"{cls.__name__[:3]} {SSL_WIDE}, arxiv shape", cls, cx, cei,
            SSL_DISC_LR, SSL_WIDE, trace=name)
        out[name].pop("model")
        torch.cuda.empty_cache()
    fx, fei = flickr["x"], add_self_loops(flickr["edge_index"],
                                          num_nodes=FLICKR_NODES)[0]
    torch.manual_seed(SEED + 36)
    model = M.DGIModel(SSL_WIDE, in_channels=FLICKR_FEAT).to(dev)
    state = TrainState(model, SSL_DISC_LR)
    gen = torch.Generator(device=dev).manual_seed(SEED + 36)
    fixed = torch.randperm(FLICKR_NODES, generator=gen, device=dev)

    def fixed_loss():
        model.eval()
        with torch.no_grad():
            return float(model(fx, fei, M.corrupt_features(fx, perm=fixed)))

    before, flosses, fms = fixed_loss(), [], []
    for _ in range(SSL_FLICKR_STEPS):
        sync()
        t0 = time.perf_counter()
        model.train()
        value = model(fx, fei, M.corrupt_features(fx, gen))
        value.backward()
        state.apply_gradients()
        sync()
        fms.append((time.perf_counter() - t0) * 1e3)
        flosses.append(float(value.detach()))
    after = fixed_loss()
    print(f"  DGI 512 on Flickr: loss of one fixed draw {before:.6f} -> "
          f"{after:.6f}; steps {[round(t, 2) for t in fms]} ms, losses "
          f"{[round(v, 5) for v in flosses]}")
    if not (np.isfinite(flosses).all() and after < before):
        fail(f"DGI on Flickr: loss did not fall: {before} -> {after}")
    out["dgi_flickr"] = {"step_ms": fms, "losses": flosses,
                         "fixed_draw_loss": [before, after]}
    del model, state, flickr, fx, fei
    torch.cuda.empty_cache()

    # (c) the trainers' defaults on a graph of Cora's statistics
    cora = cora_shape(rng)
    d = {key: v.cpu() for key, v in common.device_graph(cora, "cpu")
         .items()}
    cx, cei = d["x"], d["edge_index"]
    n, e = cx.shape[0], cei.shape[1]
    out["mvgrl"] = corruption_check(
        "MVGRL 128, Cora shape", M.MVGRLModel, cx, cei, SSL_DISC_LR,
        mvgrl_trainer.parser().get_default("hidden_dim"),
        mvgrl_trainer.diffusion_view(d))
    out["mvgrl"].pop("model")
    gp = grace_trainer.parser()
    rates = [gp.get_default(f"drop_{a}_rate_{i}") for i in (1, 2)
             for a in ("edge", "feature")]
    cuda_cora = {"cpu": (cx, cei), "cuda": (cx.to(dev), cei.to(dev))}

    def on(dev_):
        return cuda_cora["cuda" if str(dev_).startswith("cuda") else "cpu"]

    def grace_draw(gen):
        return [((torch.rand((1, CORA_FEAT), generator=gen,
                             device=gen.device) < 1 - rates[2 * v]),
                 torch.rand(e, generator=gen, device=gen.device)
                 < 1 - rates[2 * v + 1]) for v in range(2)]

    def grace_loss(m, dev_, draws):
        xx, ee = on(dev_)
        (fa, ea), (fb, eb) = draws
        xa, wa = M.drop_edge_and_feature(xx, ee, rates[0], rates[1],
                                         feat_mask=fa, edge_mask=ea)
        xb, wb = M.drop_edge_and_feature(xx, ee, rates[2], rates[3],
                                         feat_mask=fb, edge_mask=eb)
        return m(xa, ee, wa, xb, ee, wb)

    hid = gp.get_default("hidden_dim")

    def make_grace():
        torch.manual_seed(SEED + 35)
        return (M.GraceModel(hid, hid, in_channels=CORA_FEAT),
                gp.get_default("lr"))

    out["grace"] = ssl_check(
        "GRACE 128, Cora shape", make_grace,
        lambda m, dev_: m(*on(dev_), None), grace_loss, grace_draw,
        grace_draw(torch.Generator().manual_seed(SEED + 35)))
    out["grace"].pop("model")

    train_g, _, _, neg = vgae_trainer.link_split(cora, SEED)
    tei = torch.from_numpy(np.asarray(train_g.edge_index))
    vg = {"cpu": (cx, tei, torch.from_numpy(neg))}
    vg["cuda"] = tuple(v.to(dev) for v in vg["cpu"])
    vp = vgae_trainer.parser()

    def vgae_inputs(dev_):
        return vg["cuda" if str(dev_).startswith("cuda") else "cpu"]

    def vgae_loss(m, dev_, noise):
        xx, ee, nn_ = vgae_inputs(dev_)
        mu, logstd, z = m(xx, ee, noise=noise)
        return M.recon_loss(z, ee, nn_) + M.VGAEModel.kl_loss(mu, logstd) / n

    def make_vgae():
        torch.manual_seed(SEED + 35)
        return (M.VGAEModel(vp.get_default("hidden_dim"), 16,
                            in_channels=CORA_FEAT), vp.get_default("lr"))

    out["vgae"] = ssl_check(
        "VGAE 32/16, Cora shape", make_vgae,
        lambda m, dev_: m(*vgae_inputs(dev_)[:2])[0], vgae_loss,
        lambda gen: torch.randn(n, 16, generator=gen, device=gen.device),
        torch.randn(n, 16, generator=torch.Generator().manual_seed(SEED)))
    out["vgae"].pop("model")

    t0 = time.perf_counter()
    lam, u = M.laplacian_eigh(cei.numpy(), n)
    eigh_s = time.perf_counter() - t0
    sp_in = {"cpu": (cx, torch.from_numpy(lam), torch.from_numpy(u))}
    sp_in["cuda"] = tuple(v.to(dev) for v in sp_in["cpu"])
    yy = {"cpu": (d["y"], d["train_mask"])}
    yy["cuda"] = tuple(v.to(dev) for v in yy["cpu"])
    spp = specformer_trainer.parser()

    def key_of(dev_):
        return "cuda" if str(dev_).startswith("cuda") else "cpu"

    def spec_loss(m, dev_, gen):
        return semi_supervised_loss(m(*sp_in[key_of(dev_)], generator=gen),
                                    *yy[key_of(dev_)])

    def make_spec():
        torch.manual_seed(SEED + 35)
        return (M.SpecformerModel(CORA_CLASSES, spp.get_default("hidden_dim"),
                                  num_filters=2,
                                  drop_rate=spp.get_default("drop_rate"),
                                  in_channels=CORA_FEAT),
                spp.get_default("lr"))

    out["specformer"] = ssl_check(
        "Specformer 32, Cora shape (full eigh)", make_spec,
        lambda m, dev_: m(*sp_in[key_of(dev_)]), spec_loss,
        lambda gen: gen, None)
    out["specformer"].pop("model")
    out["specformer"]["eigh_s"] = eigh_s
    print(f"  Specformer's full eigh of the {n}-node Laplacian on the host: "
          f"{eigh_s:.2f} s")
    mp = mgnni_trainer.parser()

    def make_mgnni():
        torch.manual_seed(SEED + 35)
        return (M.MGNNIModel(CORA_CLASSES, mp.get_default("hidden_dim"),
                             scales=(1, 2), iters=8, in_channels=CORA_FEAT),
                mp.get_default("lr"))

    def mgnni_loss(m, dev_, _):
        xx, ee = on(dev_)
        return semi_supervised_loss(m(xx, ee), *yy[key_of(dev_)])

    out["mgnni"] = ssl_check(
        "MGNNI 32 (scales 1, 2; 8 iterations), Cora shape", make_mgnni,
        lambda m, dev_: m(*on(dev_)), mgnni_loss, lambda gen: None, None)
    out["mgnni"].pop("model")

    # (d) InfoGraph on phase 31's TU batch
    batch = BatchGraph.from_data_list(tu_graphs()[:TU_BATCH])
    tb = {"cpu": (torch.from_numpy(np.asarray(batch.x, np.float32)),
                  torch.from_numpy(np.asarray(batch.edge_index)),
                  torch.from_numpy(np.asarray(batch.batch)))}
    tb["cuda"] = tuple(v.to(dev) for v in tb["cpu"])

    def make_info():
        torch.manual_seed(SEED + 35)
        return (M.InfoGraph(32, 2, in_channels=tb["cpu"][0].shape[1]),
                1e-3)

    out["infograph"] = ssl_check(
        "InfoGraph 32 x 2, TU batch", make_info,
        lambda m, dev_: m(*tb[key_of(dev_)], TU_BATCH)[1],
        lambda m, dev_, _: m(*tb[key_of(dev_)], TU_BATCH)[0],
        lambda gen: None, None)
    out["infograph"].pop("model")

    # the twins' loops end to end on the card (a few steps, then their
    # probe or score) from the Cora-shape arrays
    twins = {}
    for name, module in (("dgi", dgi_trainer), ("ggd", ggd_trainer),
                         ("grace", grace_trainer), ("mvgrl", mvgrl_trainer),
                         ("vgae", vgae_trainer),
                         ("specformer", specformer_trainer),
                         ("mgnni", mgnni_trainer)):
        args = module.parser().parse_args(["--n_epoch", str(SSL_STEPS)])
        sync()
        t0 = time.perf_counter()
        res = module.main(args, data=cora)
        sync()
        seconds = time.perf_counter() - t0
        score = res.get("probe_acc", res.get("auc", res.get("best_test")))
        twins[name] = {"seconds": seconds, "losses": res["losses"],
                       "score": score}
        if not np.isfinite(res["losses"]).all():
            fail(f"the {name} twin's losses: {res['losses']}")
    print("  twins on the card, Cora shape, " + str(SSL_STEPS)
          + " epochs then the probe / score: " + ", ".join(
              f"{n_} {t['seconds']:.2f} s (score {t['score']:.3f})"
              for n_, t in twins.items()))
    out["twins"] = twins
    sync()
    counts = read_counts(k)
    if any(counts.values()):
        fail(f"phase 35 launched kernels: {counts}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  ({smi}) phase 35 in {out['seconds']:.1f} s; no kernel "
          "launched")
    torch.cuda.empty_cache()
    return counts, out



# phase 36: the wave-5 to wave-8 models (SIGN, UniFews, HardGAT, AdaGAD,
# Sp2GCL, MAGCL, GCIL, SFGCN, EdgePrompt, AMP, DHN, HEAT, CoED, NodeID,
# GNRF, GRACE-POT, GRACE-Spco, FatraGNN) at their twins' defaults on a
# graph of Cora's statistics (DHN, HEAT and FatraGNN on their twins' own
# synthetic inputs), UniFews and HardGAT also on the arxiv shape; each
# against the same model on the CPU (float32, dropout off, the same
# draws): requests at W58_OUT_TOL of max |out|, each step's loss at
# W58_LOSS_RTOL
W58_STEPS, W58_ARXIV_STEPS, W58_REQUESTS = 4, 3, 3
W58_OUT_TOL, W58_LOSS_RTOL = 1e-4, 1e-4


def _both(*tensors):
    """The same CPU tensors and their card copies: {"cpu": .., "cuda": ..}."""
    return {"cpu": tensors, "cuda": tuple(t.to("cuda") for t in tensors)}


def _pick(inputs, dev):
    return inputs["cuda" if str(dev).startswith("cuda") else "cpu"]


def _head(out):
    """A model's first output (its logits or embeddings)."""
    if isinstance(out, dict):
        return out["h1"]
    return out[0] if isinstance(out, (tuple, list)) else out


def pair_check(label, make, request, loss, draws, fixed=None, couple=None):
    """One model on the card against its copy on the CPU. ``make()`` gives
    (model, lr, weight decay) on the CPU; ``request(model, dev)`` an eval
    forward on ``dev``'s inputs; ``loss(model, dev, draw)`` a training
    loss with ``draw`` (made on the CPU and handed to both devices, or
    None). W58_REQUESTS timed requests on the card, the last held against
    the CPU at W58_OUT_TOL of max |out|; then one Adam step a draw on both
    devices, each step's loss held at W58_LOSS_RTOL. The loss must fall:
    the last step's below the first, or, with ``fixed`` (a draw), the eval
    loss of that draw after the steps below the one before them (the
    steps' own losses move with their draws). ``couple(card model, CPU
    model)`` may tie the two copies before the run."""
    from gammagl_tpu_torch.train import TrainState
    dev = torch.device("cuda")
    model, lr, l2 = make()
    cpu = copy.deepcopy(model)
    model = model.to(dev).eval()
    if couple is not None:
        couple(model, cpu)
    cpu.eval()
    lat = []
    for _ in range(W58_REQUESTS):
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = request(model, dev)
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        ref = request(cpu, "cpu")
    err = check_close(f"{label} request vs the CPU", _head(out).cpu(),
                      _head(ref), 0.0, atol=W58_OUT_TOL)

    def fixed_loss(m, dev_):
        m.eval()
        with torch.no_grad():
            return float(loss(m, dev_, fixed))

    before = None if fixed is None else fixed_loss(model, dev)
    states = (TrainState(model, lr, l2), TrainState(cpu, lr, l2))
    losses, cpu_losses, step_ms, cpu_ms = [], [], [], []
    for draw in draws:
        for m, state, dev_, vals, ms in ((model, states[0], dev, losses,
                                          step_ms),
                                         (cpu, states[1], "cpu", cpu_losses,
                                          cpu_ms)):
            sync()
            t0 = time.perf_counter()
            m.train()
            value = loss(m, dev_, draw)
            value.backward()
            state.apply_gradients()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            vals.append(float(value.detach()))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    if not (np.isfinite(losses).all() and rel <= W58_LOSS_RTOL):
        fail(f"{label}: step losses on the card {losses} vs the CPU "
             f"{cpu_losses}")
    after = None if fixed is None else fixed_loss(model, dev)
    fell = (after < before) if fixed is not None else (losses[-1]
                                                        < losses[0])
    print(f"  {label}: request p50 {np.median(lat):.2f} ms; steps "
          f"{[round(t, 2) for t in step_ms]} ms (CPU "
          f"{[round(t, 1) for t in cpu_ms]}); losses "
          f"{[round(v, 5) for v in losses]} (worst rel. gap to the CPU "
          f"{rel:.2e})" + ("" if fixed is None else
                           f"; loss of a fixed draw {before:.6f} -> "
                           f"{after:.6f}"))
    if not fell:
        fail(f"{label}: loss did not fall ({losses}; fixed draw {before} "
             f"-> {after})")
    return {"request_ms": lat, "step_ms": step_ms, "cpu_step_ms": cpu_ms,
            "losses": losses, "cpu_losses": cpu_losses,
            "loss_rel_err": rel, "max_abs_err": err,
            "fixed_draw_loss": None if fixed is None else [before, after]}


def phase_wave5_8(k, smi, x, ei):
    """Phase 36: the wave-5 to wave-8 models at their twins' defaults on
    the card, each against the CPU (`pair_check`), then the 18 twins'
    loops end to end. COO, as in JAX: no kernel launches."""
    import shutil
    import tempfile
    from gammagl_tpu_torch import models as M
    from gammagl_tpu_torch.examples import (
        adagad_trainer, amgcn_trainer, amp_trainer, coed_trainer, common,
        dhn_trainer, edgeprompt_trainer, fatragnn_trainer, gcil_trainer,
        gnrf_trainer, grace_pot_trainer, grace_spco_trainer,
        hardgat_trainer, heat_trainer, magcl_trainer, nodeid_trainer,
        sign_trainer, sp2gcl_trainer, unifews_trainer)
    from gammagl_tpu_torch.train import semi_supervised_loss
    phase_start("phase 36: the wave-5 to wave-8 models (Cora's shape; "
                "UniFews and HardGAT also on the arxiv shape) and their "
                "twins")
    rng = np.random.default_rng(SEED + 36)
    cora = cora_shape(rng)
    d = {key: v.cpu() for key, v in common.device_graph(cora, "cpu")
         .items()}
    g = _both(d["x"], d["edge_index"], d["y"], d["train_mask"])
    n, e = d["x"].shape[0], d["edge_index"].shape[1]
    out, runs = {}, {}
    sync()
    reset_counts(k)
    t_phase = time.perf_counter()

    def default(module, name):
        return module.parser().get_default(name)

    def seeded(build):
        torch.manual_seed(SEED + 36)
        return build()

    def node_task(label, module, build, inputs=g, forward=None, extra=None,
                  steps=W58_STEPS, couple=None):
        """A supervised model: ``build()`` at the twin's defaults (Adam at
        its rate; decayed weights for the twins on the shared loop)."""
        fwd = forward or (lambda m, xx, ee: m(xx, ee))
        decay = (default(module, "l2_coef") if module in (
            hardgat_trainer, edgeprompt_trainer, coed_trainer,
            gnrf_trainer) else 0.0)

        def loss(m, dev_, _):
            xx, ee, yy, mm = _pick(inputs, dev_)
            o = fwd(m, xx, ee)
            value = semi_supervised_loss(_head(o), yy, mm)
            return value if extra is None else value + extra(o)

        runs[label] = pair_check(
            label, lambda: (seeded(build), default(module, "lr"), decay),
            lambda m, dev_: fwd(m, *_pick(inputs, dev_)[:2]), loss,
            [None] * steps, couple=couple)

    fdim, ncls = CORA_FEAT, CORA_CLASSES
    # (a) supervised node models on Cora's shape
    xs = [torch.from_numpy(a) for a in sign_trainer.sign_features(
        cora, default(sign_trainer, "K"))]
    sign_in = {"cpu": (xs, None, d["y"], d["train_mask"])}
    sign_in["cuda"] = ([a.cuda() for a in xs], None, d["y"].cuda(),
                       d["train_mask"].cuda())
    node_task("SIGN 64 (K 3)", sign_trainer, lambda: M.SIGNModel(
        ncls, default(sign_trainer, "hidden_dim"), K=3, drop_rate=0.0,
        in_channels=fdim), inputs=sign_in, forward=lambda m, xx, _: m(xx))
    thr = default(unifews_trainer, "edge_thr")

    def unifews_weights(label, inputs):
        """The card's GCN norms, handed to both devices: a norm equal to
        the threshold in exact arithmetic (degree products of 400 at
        0.05) is kept or pruned by the last bit of deg^-0.5, which the
        card and the CPU may round apart (ROADMAP C33); the count of such
        flips is printed."""
        from gammagl_tpu_torch.utils import calc_gcn_norm
        w = {dev_: calc_gcn_norm(inputs[dev_][1], inputs[dev_][0].shape[0])
             for dev_ in ("cpu", "cuda")}
        flips = int(((w["cuda"].abs() >= thr).cpu()
                     != (w["cpu"].abs() >= thr)).sum())
        kept = float((w["cuda"].abs() >= thr).float().mean())
        print(f"  {label}: {kept:.4f} of the edges kept at {thr}; "
              f"{flips} decided apart by the card's and the CPU's "
              "rounding (the card's weights go to both)")
        out.setdefault("unifews_threshold_flips", {})[label] = flips
        return {"cpu": w["cuda"].cpu(), "cuda": w["cuda"]}

    uw = unifews_weights("GCNUniFews, Cora shape", g)
    node_task("GCNUniFews 16", unifews_trainer, lambda: M.GCNUniFews(
        ncls, default(unifews_trainer, "hidden_dim"), edge_thr=thr,
        in_channels=fdim),
        forward=lambda m, xx, ee: m(xx, ee, _pick(uw, xx.device)))
    node_task("HardGAT 8 x 8 heads (k 8)", hardgat_trainer,
              lambda: M.HardGATModel(8, ncls, heads=8, k=8,
                                     in_channels=fdim))
    fei = _both(torch.from_numpy(amgcn_trainer.knn_graph(cora["x"])))
    node_task("SFGCN 16", amgcn_trainer, lambda: M.SFGCNModel(
        ncls, default(amgcn_trainer, "hidden_dim"), in_channels=fdim),
        forward=lambda m, xx, ee: m(xx, ee, _pick(fei, xx.device)[0]),
        extra=lambda o: 0.01 * o[1])
    node_task("EdgePrompt 16", edgeprompt_trainer,
              lambda: edgeprompt_trainer.Net(
                  default(edgeprompt_trainer, "hidden_dim"), ncls,
                  in_channels=fdim))
    node_task("AMP 16 (4 steps)", amp_trainer, lambda: M.AMPModel(
        ncls, default(amp_trainer, "hidden_dim"), max_steps=4,
        in_channels=fdim))
    node_task("CoED 16 (alpha 0.3, JK cat)", coed_trainer, lambda: M.CoEDModel(
        ncls, default(coed_trainer, "hidden_dim"), alpha=0.3,
        jumping_knowledge="cat", drop_rate=0.0, in_channels=fdim))
    node_task("NodeID 16 (3 GAT layers, 32 codes)", nodeid_trainer,
              lambda: M.NodeIDModel(fdim, default(nodeid_trainer,
                                                  "hidden_dim"), ncls,
                                    num_codes=32, dropout=0.0),
              extra=lambda o: 0.25 * o[1])
    node_task("GNRF 16 (8 RK4 steps)", gnrf_trainer, lambda: M.GNRFModel(
        ncls, default(gnrf_trainer, "hidden_dim"), num_steps=8, dropout=0.0,
        in_channels=fdim))

    # (b) UniFews and HardGAT on the arxiv shape (planted labels)
    _, xd, ya, ma = zoo_inputs(x, ei)
    arxiv = {"cpu": (xd.cpu(), ei.cpu(), ya.cpu(), ma.cpu()),
             "cuda": (xd, ei, ya, ma)}
    uwa = unifews_weights("GCNUniFews, arxiv shape", arxiv)
    node_task("GCNUniFews 16, arxiv shape", unifews_trainer,
              lambda: M.GCNUniFews(N_CLASS, default(unifews_trainer,
                                                    "hidden_dim"),
                                   edge_thr=thr, in_channels=N_FEAT),
              inputs=arxiv,
              forward=lambda m, xx, ee: m(xx, ee, _pick(uwa, xx.device)),
              steps=W58_ARXIV_STEPS)
    flips = []

    def card_selection(card, cpu):
        """HardGAT keeps the edges whose float32 scores reach the k-th of
        their destination (or 0): where two scores, or a score and 0,
        are within rounding, the card and the CPU may choose apart. Each
        layer's CPU forward takes the card's last choice, and counts the
        edges its own choice differs on."""
        for cc, pc in ((card.conv0, cpu.conv0), (card.conv1, cpu.conv1)):
            seen = {}

            def record(*args, real=cc.keep_mask, seen=seen):
                seen["keep"] = real(*args)
                return seen["keep"]

            def replay(*args, real=pc.keep_mask, seen=seen):
                want = seen["keep"].cpu()
                flips.append(int((real(*args) != want).sum()))
                return want

            cc.keep_mask, pc.keep_mask = record, replay

    node_task("HardGAT 8 x 8 heads (k 8), arxiv shape", hardgat_trainer,
              lambda: M.HardGATModel(8, N_CLASS, heads=8, k=8,
                                     in_channels=N_FEAT), inputs=arxiv,
              steps=W58_ARXIV_STEPS, couple=card_selection)
    out["hardgat_arxiv_selection_flips"] = flips
    print(f"  HardGAT, arxiv shape: the CPU's own top-k choice differs from "
          f"the card's on {flips} edges (each CPU forward's two layers in "
          f"turn; of {ei.shape[1]})")
    del arxiv, xd, uwa
    torch.cuda.empty_cache()

    # (c) the unsupervised and two-view models on Cora's shape
    ax, aei, neg, _ = adagad_trainer.inject_anomalies(
        cora["x"], d["edge_index"].numpy(), SEED)
    ad = _both(*(torch.from_numpy(a) for a in (ax, aei, neg)))
    runs["AdaGAD 32/8"] = pair_check(
        "AdaGAD 32/8", lambda: (seeded(lambda: M.AdaGADModel(
            default(adagad_trainer, "hidden_dim"), 8, in_channels=fdim)),
            default(adagad_trainer, "lr"), 0.0),
        lambda m, dev_: m(*_pick(ad, dev_)[:2]),
        lambda m, dev_, _: m(*_pick(ad, dev_)), [None] * W58_STEPS)
    t0 = time.perf_counter()
    _, u = M.laplacian_eigh(d["edge_index"].numpy(), n)
    eigh_s = time.perf_counter() - t0
    spe = default(sp2gcl_trainer, "spe_dim")
    sp = _both(d["x"], d["edge_index"],
               torch.from_numpy(np.ascontiguousarray(u[:, :spe])))
    runs["Sp2GCL 64"] = pair_check(
        "Sp2GCL 64", lambda: (seeded(lambda: M.Sp2GCLModel(
            default(sp2gcl_trainer, "hidden_dim"), in_channels=fdim,
            spe_dim=spe)), default(sp2gcl_trainer, "lr"), 0.0),
        lambda m, dev_: m.conv1(torch.relu(m.conv0(*_pick(sp, dev_)[:2])),
                                _pick(sp, dev_)[1]),
        lambda m, dev_, _: m(*_pick(sp, dev_)), [None] * W58_STEPS)
    print(f"  Sp2GCL's full eigh of the {n}-node Laplacian on the host: "
          f"{eigh_s:.2f} s")
    draw_gen = torch.Generator().manual_seed(SEED + 36)

    def two_view(label, module, build, rates, objective, embed):
        def draw():
            return [((torch.rand((1, fdim), generator=draw_gen)
                      < 1 - rates[2 * v]),
                     torch.rand(e, generator=draw_gen) < 1 - rates[2 * v + 1])
                    for v in range(2)]

        def loss(m, dev_, draws):
            xx, ee = _pick(g, dev_)[:2]
            (fa, ea), (fb, eb) = draws
            xa, wa = M.drop_edge_and_feature(xx, ee, rates[0], rates[1],
                                             feat_mask=fa, edge_mask=ea)
            xb, wb = M.drop_edge_and_feature(xx, ee, rates[2], rates[3],
                                             feat_mask=fb, edge_mask=eb)
            return objective(m, xa, ee, wa, xb, wb)

        fixed = draw()
        runs[label] = pair_check(
            label, lambda: (seeded(build), default(module, "lr"), 0.0),
            lambda m, dev_: embed(m, *_pick(g, dev_)[:2]), loss,
            [draw() for _ in range(W58_STEPS)], fixed=fixed)

    def rates_of(module):
        """(edge1, feat1, edge2, feat2): the twin's flags (ROADMAP C27:
        the edge rate masks the features, as `drop_edge_and_feature` is
        called here)."""
        return [default(module, f"drop_{a}_rate_{i}") for i in (1, 2)
                for a in ("edge", "feature")]

    def loss_form(m, xa, ee, wa, xb, wb):
        return m(xa, ee, wa, xb, ee, wb)

    two_view("MAGCL 128", magcl_trainer, lambda: M.MAGCLModel(
        default(magcl_trainer, "hidden_dim"), in_channels=fdim),
        rates_of(magcl_trainer), loss_form,
        lambda m, xx, ee: m(xx, ee, None))
    two_view("GCIL 128", gcil_trainer, lambda: M.GCILModel(
        default(gcil_trainer, "hidden_dim"), in_channels=fdim),
        rates_of(gcil_trainer), loss_form,
        lambda m, xx, ee: m(xx, ee, None))
    hp = default(grace_pot_trainer, "hidden_dim")
    two_view("GRACE-POT 64", grace_pot_trainer, lambda: M.GracePOTModel(
        hp, hp, in_channels=fdim), (0.2, 0.2, 0.3, 0.3),
        lambda m, xa, ee, wa, xb, wb: m.loss(xa, ee, wa, xb, ee, wb),
        lambda m, xx, ee: m(xx, ee))
    hs = default(grace_spco_trainer, "hidden_dim")
    two_view("GRACE-Spco 64", grace_spco_trainer, lambda: M.GraceSpcoModel(
        hs, hs, in_channels=fdim), (0.2, 0.2, 0.3, 0.3), loss_form,
        lambda m, xx, ee: m(xx, ee, torch.ones(ee.shape[1],
                                               device=ee.device)))

    # (d) the twins' own synthetic inputs: DHN, HEAT, FatraGNN
    # each of the dhn twin's batches plants its own direction, and each of
    # the heat twin's scenes has its own agents, so a few steps on fresh
    # ones need not lower a fixed one's loss: the steps here all take the
    # first batch (scene)
    dhn_batch = tuple(torch.from_numpy(a)
                      for a in next(dhn_trainer.batches(SEED)))

    def dhn_loss(m, dev_, b):
        n1, n2, y = (t.to(dev_) for t in b)
        return torch.nn.functional.binary_cross_entropy_with_logits(
            m(n1, n2)[:, 0], y)

    runs["DHN 32"] = pair_check(
        "DHN 32", lambda: (seeded(lambda: M.DHNModel(
            dhn_trainer.F_DIM, dhn_trainer.K,
            default(dhn_trainer, "hidden_dim"))), default(dhn_trainer, "lr"),
            0.0),
        lambda m, dev_: m(*(t.to(dev_) for t in dhn_batch[:2])),
        dhn_loss, [dhn_batch] * W58_STEPS)
    scene = tuple(torch.from_numpy(a) for a in heat_trainer.scene(0))

    def heat_loss(m, dev_, sc):
        xx, ee, attr, et, y = (t.to(dev_) for t in sc)
        return ((m(xx, ee, attr, et) - y) ** 2).mean()

    runs["HEAT 16/32 (2 heads)"] = pair_check(
        "HEAT 16/32 (2 heads)", lambda: (seeded(lambda: M.HEATModel(
            16, 32, heat_trainer.FUT, 16, 16, 16, heads=2,
            dropout_rate=0.0, in_channels=heat_trainer.HIST * 4,
            edge_attr_channels=5,
            edge_type_channels=4)), default(heat_trainer, "lr"), 0.0),
        lambda m, dev_: m(*(t.to(dev_) for t in scene[:4])),
        heat_loss, [scene] * W58_STEPS)
    fx, fei_, fy, sens, ftm = fatragnn_trainer.fairness_graph(SEED)
    fe2 = M.modify_structure(fei_, fei_, sens, drop=0.6)
    fg = _both(torch.from_numpy(fx), torch.from_numpy(fei_),
               torch.from_numpy(fe2), torch.from_numpy(fy.astype(np.float32)),
               torch.from_numpy(ftm))

    def fatra_loss(m, dev_, _):
        xx, e1, e2, yy, tm = _pick(fg, dev_)
        ce = torch.nn.functional.binary_cross_entropy_with_logits(
            m(xx, e1, 0)[:, 0], yy, reduction="none")
        ce = torch.where(tm, ce, 0).sum() / tm.sum()
        o = m(xx, e1, 5, edge_index2=e2)
        return ce + 0.5 * ((o["h1"] - o["h2"]) ** 2).sum(1).mean()

    runs["FatraGNN 16"] = pair_check(
        "FatraGNN 16", lambda: (seeded(lambda: M.FatraGNNModel(
            fx.shape[1], default(fatragnn_trainer, "hidden_dim"))),
            default(fatragnn_trainer, "lr"), 0.0),
        lambda m, dev_: m(*_pick(fg, dev_)[:2], 0), fatra_loss,
        [None] * W58_STEPS)
    out["models"] = runs

    # (e) the twins' loops end to end on the card (their own draws and
    # dropout): W58_STEPS epochs, then their probe or score
    twins = {}
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_unifews_")
    try:
        for name, module in (
                ("sign", sign_trainer), ("unifews", unifews_trainer),
                ("hardgat", hardgat_trainer), ("adagad", adagad_trainer),
                ("sp2gcl", sp2gcl_trainer), ("magcl", magcl_trainer),
                ("gcil", gcil_trainer), ("amgcn", amgcn_trainer),
                ("edgeprompt", edgeprompt_trainer), ("amp", amp_trainer),
                ("dhn", dhn_trainer), ("heat", heat_trainer),
                ("coed", coed_trainer), ("nodeid", nodeid_trainer),
                ("gnrf", gnrf_trainer), ("grace_pot", grace_pot_trainer),
                ("grace_spco", grace_spco_trainer),
                ("fatragnn", fatragnn_trainer)):
            args = module.parser().parse_args(["--n_epoch", str(W58_STEPS)])
            kw = ({} if name in ("dhn", "heat", "fatragnn")
                  else {"data": cora})
            if name == "unifews":
                kw["log_dir"] = log_dir
            sync()
            t0 = time.perf_counter()
            res = module.main(args, **kw)
            sync()
            score = next((res[key] for key in ("probe_acc", "auc",
                                               "best_test", "test_acc")
                          if key in res), None)
            twins[name] = {"seconds": time.perf_counter() - t0,
                           "losses": res["losses"], "score": score}
            if not np.isfinite(res["losses"]).all():
                fail(f"the {name} twin's losses: {res['losses']}")
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    print(f"  twins on the card, {W58_STEPS} epochs then the probe / "
          "score: " + ", ".join(
              f"{n_} {t['seconds']:.2f} s" + ("" if t["score"] is None
                                              else f" ({t['score']:.3f})")
              for n_, t in twins.items()))
    out["twins"] = twins
    out["sp2gcl_eigh_s"] = eigh_s
    sync()
    counts = read_counts(k)
    if any(counts.values()):
        fail(f"phase 36 launched kernels: {counts}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  ({smi}) phase 36 in {out['seconds']:.1f} s; no kernel "
          "launched")
    torch.cuda.empty_cache()
    return counts, out


# phase 37: FusedGATConv at the arxiv shape (phases 6-7's GAT), then the
# rest of the slice against the CPU
W3_STEPS, W3_TWIN_STEPS = 3, 3


def fused_gat_model(load_jax_params):
    """`models.FusedGATModel` with phases 6-7's GAT parameters (its convs'
    flax names). Like the JAX model it has no attention dropout and no
    dtype of its own: it is called under `compute_dtype(bfloat16)`."""
    from gammagl_tpu_torch.models import FusedGATModel
    tree = gat_params()["params"]
    model = FusedGATModel(hidden_dim=GAT_HIDDEN, num_class=N_CLASS,
                          heads=GAT_HEADS, drop_rate=GAT_DROP,
                          in_channels=N_FEAT)
    return load_jax_params(model, {"params": {
        f"FusedGATConv_{i}": tree[f"GATConv_{i}"] for i in (0, 1)}})


def fused_gat_path(k, twin, GATModel, load_jax_params, x, ei):
    """(b) `FusedGATModel` (bf16, `compute_dtype`) on the plan
    `FusedGATModel.to_graph_format` builds: it raises without the plan;
    its requests run the flash forward (row 10), equal phase 6's GATModel
    on that plan bit for bit (the same kernels) and are held against the
    plain COO path; its steps are phase 7's (`train_phase`, row 11 too),
    with GATModel on the COO path as the plain side, its attention
    dropout off as FusedGATModel's is (the input dropout from one
    generator on both)."""
    from gammagl_tpu_torch.models import FusedGATModel
    from gammagl_tpu_torch.utils import compute_dtype
    fplan = FusedGATModel.to_graph_format(ei.cpu().numpy(), N_NODES)
    fused = fused_gat_model(load_jax_params).to(x.device).eval()
    gat = gat_model(GATModel, load_jax_params).to(x.device).eval()

    def plain_gat():
        model = gat_model(GATModel, load_jax_params)
        for conv in model.convs:
            conv.dropout_rate = 0.0
        return model

    with compute_dtype(torch.bfloat16):
        try:
            fused(x, ei)
            fail("FusedGATModel ran without a plan")
        except ValueError:
            pass
        requests = [x + r * 1e-3 for r in range(N_REQUESTS)]
        with torch.inference_mode():
            req_counts, lat = serve_requests(
                k, requests, lambda xr: fused(xr, ei, plan=fplan),
                lambda xr: gat(xr, ei), {"flash_forward": 2},
                "FusedGATModel", (N_NODES, N_CLASS))
            for r, xr in enumerate(requests):
                if not torch.equal(fused(xr, ei, plan=fplan),
                                   gat(xr, ei, plan=fplan)):
                    fail(f"FusedGATModel request {r} != GATModel on the "
                         "plan")
            out = {"request_latency_ms": lat.tolist(),
                   "request_ms": cuda_ms(lambda: fused(x, ei, plan=fplan),
                                         iters=5, warmup=1),
                   "request_plain_ms": cuda_ms(lambda: gat(x, ei), iters=3,
                                               warmup=1),
                   "request_profile": profile(
                       "fgat_request", lambda: fused(x, ei, plan=fplan))}
        print("  FusedGATModel requests equal GATModel's on the plan bit "
              "for bit")
        del fused, gat
        step_counts, losses, step_ms, grad_err, (state, y, mask, _) = \
            train_phase(k, "FusedGATModel",
                        lambda: fused_gat_model(load_jax_params), twin,
                        GAT_STEP_LAUNCHES, GAT_LR, 0.0, fplan, x, ei,
                        make_plain=plain_gat)

        def one_step():
            twin.loss_and_grad(state.model, x, ei, y, mask, plan=fplan)
            state.model.zero_grad(set_to_none=True)

        out["step_profile"] = profile("fgat_step", one_step)
    out.update(step_ms=step_ms["kernel"], losses=losses["kernel"],
               plain_losses=losses["plain"],
               step0_grad_vs_plain_max_abs_err=grad_err)
    for key, prof in (("request", out["request_profile"]),
                      ("step", out["step_profile"])):
        for kname, label in (("flash_fwd", "flash_forward"),
                             ("flash_bwd", "flash_backward")):
            out[f"{key}_{label}_us"] = sum(
                v for n_, v in prof["by_kernel_us"].items() if kname in n_)
    print(f"  FusedGATModel request {out['request_ms']:.3f} ms (plain COO "
          f"{out['request_plain_ms']:.3f}); flash forward "
          f"{out['request_flash_forward_us']:.1f} us a request, in a step "
          f"forward {out['step_flash_forward_us']:.1f} us, backward "
          f"{out['step_flash_backward_us']:.1f} us")
    del state
    torch.cuda.empty_cache()
    return req_counts, step_counts, out


def phase_wave3(k, smi, x, ei):
    """Phase 37: SGFormer, GNN-LF/HF, CAGCN, MERIT, GRADE and TADW at
    their twins' defaults on a graph of Cora's statistics, Graphormer on
    its twin's graphs and RGT through `ExtractNodeLoader`, each against
    the CPU (`pair_check`); then the eight twins on the card. No kernel
    (its FusedGATConv path runs `FusedGATModel` in phase 39)."""
    from gammagl_tpu_torch import models as M
    from gammagl_tpu_torch.examples import (
        cagcn_trainer, common, gnnlfhf_trainer, grade_trainer,
        graphormer_trainer, merit_trainer, rgt_trainer, sgformer_trainer,
        tadw_trainer)
    from gammagl_tpu_torch.train import semi_supervised_loss
    phase_start("phase 37: the rest of wave 3, Graphormer and RGT against "
                "the CPU, and their twins")
    t_phase = time.perf_counter()
    out = {}
    rng = np.random.default_rng(SEED + 37)
    cora = cora_shape(rng)
    d = {key: v.cpu() for key, v in common.device_graph(cora, "cpu")
         .items()}
    g = _both(d["x"], d["edge_index"], d["y"], d["train_mask"])
    e = d["edge_index"].shape[1]
    fdim, ncls = CORA_FEAT, CORA_CLASSES
    runs = {}
    sync()
    reset_counts(k)

    def default(module, name):
        return module.parser().get_default(name)

    def seeded(build):
        torch.manual_seed(SEED + 37)
        return build()

    def node_task(label, module, build):
        """A supervised model at its twin's defaults (dropout off), Adam
        with decayed weights, as `run_simple_node_trainer`."""
        def loss(m, dev_, _):
            xx, ee, yy, mm = _pick(g, dev_)
            return semi_supervised_loss(m(xx, ee), yy, mm)

        runs[label] = pair_check(
            label, lambda: (seeded(build), default(module, "lr"),
                            default(module, "l2_coef")),
            lambda m, dev_: m(*_pick(g, dev_)[:2]), loss,
            [None] * W3_STEPS)

    node_task("SGFormer 32", sgformer_trainer, lambda: M.SGFormerModel(
        default(sgformer_trainer, "hidden_dim"), ncls, drop_rate=0.0,
        in_channels=fdim))
    for variant in ("lf", "hf"):
        node_task(f"GNN-{variant.upper()} 64 (K 10)", gnnlfhf_trainer,
                  lambda v=variant: M.GNNLFHFModel(
                      default(gnnlfhf_trainer, "hidden_dim"), ncls,
                      variant=v, K=10, drop_rate=0.0, in_channels=fdim))
    node_task("CAGCN 16", cagcn_trainer, lambda: M.CAGCNModel(
        ncls, default(cagcn_trainer, "hidden_dim"), in_channels=fdim))
    draw_gen = torch.Generator().manual_seed(SEED + 37)

    def two_view(label, module, build, embed):
        rates = [default(module, f"drop_{a}_rate_{i}") for i in (1, 2)
                 for a in ("edge", "feature")]

        def draw():
            return [((torch.rand((1, fdim), generator=draw_gen)
                      < 1 - rates[2 * v]),
                     torch.rand(e, generator=draw_gen) < 1 - rates[2 * v + 1])
                    for v in range(2)]

        def loss(m, dev_, draws):
            xx, ee = _pick(g, dev_)[:2]
            (fa, ea), (fb, eb) = draws
            xa, wa = M.drop_edge_and_feature(xx, ee, rates[0], rates[1],
                                             feat_mask=fa, edge_mask=ea)
            xb, wb = M.drop_edge_and_feature(xx, ee, rates[2], rates[3],
                                             feat_mask=fb, edge_mask=eb)
            return m(xa, ee, wa, xb, ee, wb)

        runs[label] = pair_check(
            label, lambda: (seeded(build), default(module, "lr"), 0.0),
            lambda m, dev_: embed(m, *_pick(g, dev_)[:2]), loss,
            [draw() for _ in range(W3_STEPS)], fixed=draw())

    two_view("MERIT 128", merit_trainer, lambda: merit_trainer.Net(
        default(merit_trainer, "hidden_dim"), in_channels=fdim),
        lambda m, xx, ee: m(xx, ee, None))
    two_view("GRADE 128", grade_trainer, lambda: M.GRADEModel(
        default(grade_trainer, "hidden_dim"), in_channels=fdim),
        lambda m, xx, ee: m(xx, ee, None))

    # TADW on the card (its default device) against the CPU from the same
    # draws: one step (finite), and its twin's 20, where both diverge
    # (ROADMAP C38)
    adj, text = tadw_trainer.inputs(cora)
    tadw_out = {}
    for steps in (1, default(tadw_trainer, "n_epoch")):
        sync()
        t0 = time.perf_counter()
        card = M.tadw(adj, text, dim=default(tadw_trainer, "hidden_dim"),
                      iters=steps)
        sync()
        card_s = time.perf_counter() - t0
        cpu = M.tadw(adj, text, dim=default(tadw_trainer, "hidden_dim"),
                     iters=steps, device="cpu")
        finite = bool(np.isfinite(card).all())
        tadw_out[steps] = {"seconds": card_s, "finite": finite,
                           "cpu_finite": bool(np.isfinite(cpu).all())}
        if steps == 1:
            tadw_out[steps]["max_abs_err"] = check_close(
                "TADW 80, one step, card vs CPU", torch.from_numpy(card),
                torch.from_numpy(cpu), 0.0, atol=1e-4)
        elif finite or tadw_out[steps]["cpu_finite"]:
            fail(f"TADW at {steps} steps was finite on one device: C38 "
                 "says both diverge")
        print(f"  TADW {steps} steps: {card_s:.3f} s on the card, finite "
              f"{finite} (CPU {tadw_out[steps]['cpu_finite']})")
    out["tadw"] = tadw_out

    # (c) Graphormer on its twin's graphs
    gs = graphormer_trainer.graphs(SEED, default(graphormer_trainer,
                                                 "num_graphs"))
    gt = [_both(*(torch.as_tensor(a) for a in gr[:4]),
                torch.tensor([gr[4]])) for gr in gs]

    def graphormer_loss(m, dev_, _):
        return sum(torch.nn.functional.cross_entropy(
            m(*_pick(t, dev_)[:4])[None], _pick(t, dev_)[4]) for t in gt)

    runs["Graphormer 32"] = pair_check(
        "Graphormer 32", lambda: (seeded(lambda: M.GraphormerModel(
            default(graphormer_trainer, "hidden_dim"), 2, num_layers=2,
            num_heads=2, dropout_rate=0.0, in_channels=8)),
            default(graphormer_trainer, "lr"), 0.0),
        lambda m, dev_: m(*_pick(gt[0], dev_)[:4]), graphormer_loss,
        [None] * W3_STEPS)

    # (d) RGT through ExtractNodeLoader at its twin's defaults
    rargs = rgt_trainer.parser().parse_args([])
    t0 = time.perf_counter()
    loader = rgt_trainer.loader(cora, rargs)
    batches = list(itertools.islice(iter(loader), W3_STEPS + 1))
    loader_s = time.perf_counter() - t0
    rb = [{"cpu": rgt_trainer.batch_args(b, "cpu"),
           "cuda": rgt_trainer.batch_args(b, "cuda")} for b in batches]
    flips = []

    def rgt_request(m, dev_):
        o = m(*_pick(rb[0], dev_))
        if str(dev_).startswith("cuda"):
            flips.append([i.cpu() for i in o["indices"]])
        else:
            flips[-1] = sum(int((a != b).sum()) for a, b in zip(
                flips[-1], o["indices"]))
        return o["q_E"]

    runs["RGT 64 (2 layers)"] = pair_check(
        "RGT 64 (2 layers)", lambda: (seeded(lambda: M.RGTModel(
            fdim, hidden_dim=rargs.hidden_dim, embed_dim=32, n_layers=2,
            codebook_size=64, codebook_dim=16, codebook_heads=4)),
            rargs.lr, 0.0),
        rgt_request, lambda m, dev_, b: m.train_loss(*_pick(b, dev_))[0],
        rb[1:], fixed=rb[0])
    out["rgt_vq_argmin_flips"] = flips[-1]
    out["rgt_loader_s"] = loader_s
    print(f"  RGT: {flips[-1]} of the card's codebook choices (3 "
          f"quantisers x {rb[0]['cpu'][0].shape[0]} rows x 4 heads) differ "
          f"from the CPU's on the last request; loader {loader_s:.2f} s for "
          f"{len(batches)} batches")
    out["models"] = runs

    # (e) the twins end to end on the card
    twins = {}
    for name, module, argv, kw in (
            ("sgformer", sgformer_trainer, [], {"data": cora}),
            ("gnnlfhf", gnnlfhf_trainer, [], {"data": cora}),
            ("cagcn", cagcn_trainer, [], {"data": cora}),
            ("merit", merit_trainer, [], {"data": cora}),
            ("grade", grade_trainer, [], {"data": cora}),
            ("tadw", tadw_trainer, ["--n_epoch", "1"], {"data": cora}),
            ("graphormer", graphormer_trainer, ["--n_epoch", "1"], {}),
            ("rgt", rgt_trainer, ["--n_epoch", "1"],
             {"data": cora, "max_steps": 2 * W3_TWIN_STEPS})):
        if not argv:
            argv = ["--n_epoch", str(W3_TWIN_STEPS)]
        args = module.parser().parse_args(argv)
        sync()
        t0 = time.perf_counter()
        res = module.main(args, **kw)
        sync()
        score = next((res[key] for key in ("probe_acc", "best_test", "acc")
                      if key in res), None)
        vals = res["losses"] if "losses" in res else res["embedding"]
        twins[name] = {"seconds": time.perf_counter() - t0, "score": score,
                       "losses": res.get("losses")}
        if not np.isfinite(vals).all():
            fail(f"the {name} twin: non-finite {vals}")
    print("  twins on the card: " + ", ".join(
        f"{n_} {t['seconds']:.2f} s ({t['score']:.3f})"
        for n_, t in twins.items()))
    out["twins"] = twins
    sync()
    counts = read_counts(k)
    if any(counts.values()):
        fail(f"phase 37's COO models launched kernels: {counts}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  ({smi}) phase 37 in {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return counts, out


# -- phase 38: slice 21 (C39, the port's profiling utilities, A6e) ----------

# phase 7's step on the card before the gathered backward's score
# gradient took `spmm_csr` (NVIDIA H100 80GB HBM3, 700 W): 5.53-6.78 ms;
# row 1 at F = 40 bf16 on the arxiv shape (PERF.md section 6): 0.1804 ms
ATOMIC_GAT_STEP_MS, ROW1_F40_MS = (5.53, 6.78), 0.1804
P38_STEPS, P38_CHAIN_K = 3, 8
P38_STEP_SPAN = "phase38_gcn_step"  # the traced step's span


def c39_gat_steps(k, twin, GATModel, load_jax_params, plan, x, ei):
    """(a) ROADMAP C39 on the card: phase 7's GAT step (bf16, the arxiv
    shape, heads (8, 8) then (1, 40)) run twice from the same parameters,
    keep masks, labels and generator state: the loss and every step-0
    gradient bitwise equal; each step exactly 2 flash forward, 2 flash
    backward and 4 `spmm_csr` launches; then N_STEPS of the twin's step,
    timed, and a trace of one."""
    from gammagl_tpu_torch.train import TrainState
    y, mask = train_labels(x)
    keeps_for = gat_keeps(k, x, ei)
    keeps = keeps_for(0)
    want = every_kernel(GAT_STEP_LAUNCHES)
    launches = every_kernel({})

    def counted(label):
        counts = read_counts(k)
        if counts != want:
            fail(f"C39 {label}: expected launches {want}, counted {counts}")
        for name in launches:
            launches[name] += counts[name]

    runs = []
    for _ in range(2):
        model = gat_model(GATModel, load_jax_params).to(x.device).train()
        kw = {"plan": plan, "keeps": keeps,
              **dropout_rng(model, SEED + 100)}
        sync()
        reset_counts(k)
        loss = twin.loss_and_grad(model, x, ei, y, mask, **kw)
        sync()
        counted("step 0")
        runs.append((loss.detach().clone(),
                     [p.grad.clone() for p in model.parameters()]))
    (la, ga), (lb, gb) = runs
    apart = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(ga, gb))
    if not torch.equal(la, lb) or not all(torch.equal(a, b)
                                          for a, b in zip(ga, gb)):
        fail(f"C39: two runs of one GAT step differ (loss {float(la)} vs "
             f"{float(lb)}, gradients {apart:.3e} apart)")
    largest = max(float(g.float().abs().max()) for g in ga)
    print(f"  C39: two GAT steps from one state: loss {float(la):.6f} and "
          f"all {len(ga)} gradients bitwise equal (max |grad| "
          f"{largest:.4e})")
    model.zero_grad(set_to_none=True)
    state = TrainState(model, GAT_LR)
    step_ms = []
    for step in range(N_STEPS):
        kw = {"plan": plan, "keeps": keeps_for(step),
              **dropout_rng(model, SEED + 100 + step)}
        sync()
        reset_counts(k)
        t0 = time.perf_counter()
        twin.train_step(state, x, ei, y, mask, **kw)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counted(f"step {step}")
    gen = torch.Generator(device=x.device).manual_seed(SEED + 200)
    prof = profile("c39_gat_step", lambda: twin.train_step(
        state, x, ei, y, mask, plan=plan, generator=gen))
    med = float(np.median(step_ms[1:]))
    print(f"  C39 GAT step (steps 1-{N_STEPS - 1}): median {med:.2f} ms "
          f"(phase 7 with the atomic score scatter: "
          f"{ATOMIC_GAT_STEP_MS[0]}-{ATOMIC_GAT_STEP_MS[1]} ms), device "
          f"busy {prof['busy_us']:.1f} us; launches {launches}")
    del state, model, runs
    torch.cuda.empty_cache()
    return launches, {"step0_loss": float(la), "max_abs_grad": largest,
                      "step_ms": step_ms, "step_median_ms": med,
                      "profile": prof}


def profiling_path(k, GCNModel, load_jax_params, plan, x, ei):
    """(b) `gammagl_tpu_torch.utils.profiling` on the main path:
    `chain_time` of `spmm_csr` (row 1) at F = 40 bf16 on the arxiv shape
    beside its CUDA-event time and the table's figure; `trace` around one
    step of phase 20's GCN (3 layers, bf16) on the CSR plan, whose kernel
    events must name `spmm_csr` as often as the wrappers count; and
    `device_timer` around the same step."""
    from gammagl_tpu_torch.examples import common
    from gammagl_tpu_torch.train import TrainState
    from gammagl_tpu_torch.utils.profiling import (chain_time, device_timer,
                                                   trace)
    dev = x.device
    w = k.pad_edge_weights(plan, gcn_weights(ei, N_NODES))
    gen = torch.Generator(device=dev).manual_seed(SEED + 38)
    h0 = torch.randn(N_NODES, N_CLASS, generator=gen,
                     device=dev).bfloat16()

    def step(h):
        return k.spmm_csr(h, w, plan, weights_padded=True)

    chain_ms = chain_time(step, h0, K=P38_CHAIN_K, reps=3) * 1e3
    event_ms = cuda_ms(lambda: step(h0))
    print(f"  chain_time(spmm_csr, F = 40 bf16, K = {P38_CHAIN_K}): "
          f"{chain_ms:.4f} ms a step (with its bound h / (max|h| + 1)); "
          f"CUDA events of the launch alone {event_ms:.4f} ms; PERF.md row "
          f"1: {ROW1_F40_MS} ms")
    y, mask = train_labels(x)
    model = gcn_model(GCNModel, load_jax_params).to(dev)
    state = TrainState(model, GCN_LR, GCN_L2)
    common.train_step(state, x, ei, y, mask, plan=plan)  # warm
    want = every_kernel({"spmm_csr": 2 * N_LAYERS})
    launches = every_kernel({})
    sync()
    reset_counts(k)
    with trace(TRACE_DIR) as prof:
        # one small kernel and a wait first: a trace once lost one of the
        # step's kernel events (5 of 6 `spmm_csr`, the wrappers counting
        # 6); that the first launch after the capture opens is the one
        # lost is a guess, not confirmed. The step runs in its own span,
        # and the kernel time counts only the kernels that start in it.
        torch.ones(1, device=dev).add_(1)
        sync()
        with torch.profiler.record_function(P38_STEP_SPAN):
            common.train_step(state, x, ei, y, mask, plan=plan)
    counts = read_counts(k)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [ev for ev in events if ev.get("name") == P38_STEP_SPAN
             and ev.get("ph") == "X"]
    if not spans:
        fail(f"trace: no {P38_STEP_SPAN} span in the trace")
    t_step = min(ev["ts"] for ev in spans)
    events = [ev for ev in events
              if ev.get("cat") != "kernel" or ev["ts"] >= t_step]
    named = [ev["name"] for ev in events
             if ev.get("cat") == "kernel" and "spmm_csr" in ev["name"]]
    if counts != want or len(named) != counts["spmm_csr"]:
        fail(f"trace: the GCN step counted {counts} (expected {want}); its "
             f"trace names spmm_csr in {len(named)} kernel events")
    for name in launches:
        launches[name] += counts[name]
    busy = sum(ev["dur"] for ev in events if ev.get("cat") == "kernel")
    lines = []
    sync()
    reset_counts(k)
    with device_timer("GCN train step (3 x 256, bf16, CSR plan)",
                      sink=lines.append):
        common.train_step(state, x, ei, y, mask, plan=plan)
    counts = read_counts(k)
    if counts != want or len(lines) != 1:
        fail(f"device_timer: counted {counts}, lines {lines}")
    for name in launches:
        launches[name] += counts[name]
    print(f"  trace: {len(events)} events, {len(named)} spmm_csr kernels "
          f"(the wrappers counted {counts['spmm_csr']}), kernel time "
          f"{busy:.1f} us; {os.path.relpath(prof.trace_path)}")
    print(f"  device_timer: {lines[0]}")
    del state, model
    torch.cuda.empty_cache()
    return launches, {"chain_ms": chain_ms, "event_ms": event_ms,
                      "trace_spmm_kernels": len(named),
                      "trace_kernel_us": busy, "device_timer": lines[0]}


def a6e_models(k):
    """(c) The A6e models at their twins' defaults, each against its copy
    on the CPU (`pair_check`: requests at W58_OUT_TOL of max |out|, step
    losses at W58_LOSS_RTOL, the loss falling; for the models that draw
    new walks, batches or noise each step, one fixed draw's loss). COO,
    as in JAX: no kernel launches."""
    from gammagl_tpu_torch import models as M
    from gammagl_tpu_torch.examples import (
        cogsl_trainer, common, deepwalk_trainer, defog_trainer,
        glnn_trainer, graphgan_trainer, metapath2vec_trainer,
        node2vec_trainer, seal_trainer)
    from gammagl_tpu_torch.models.defog import (flow_draws,
                                                flow_interpolate_apply)
    rng = np.random.default_rng(SEED + 38)
    cora = cora_shape(rng)
    d = {key: v.cpu() for key, v in common.device_graph(cora, "cpu")
         .items()}
    n, ncls, fdim = CORA_NODES, CORA_CLASSES, CORA_FEAT
    runs = {}
    sync()
    reset_counts(k)

    def default(module, name):
        return module.parser().get_default(name)

    def seeded(build):
        torch.manual_seed(SEED + 38)
        return build()

    def walk_model(label, module, cls, **kw):
        hidden = default(module, "hidden_dim")
        model = seeded(lambda: cls(n, hidden, walk_length=10, **kw))
        walks = iter(model.make_loader(cora["edge_index"], batch_size=default(
            module, "batch_size"), seed=SEED))
        draws = [_both(*(torch.from_numpy(a) for a in next(walks)))
                 for _ in range(P38_STEPS + 1)]
        runs[label] = pair_check(
            label, lambda: (model, default(module, "lr"), 0.0),
            lambda m, dev_: m().detach(),
            lambda m, dev_, w: m(*_pick(w, dev_)),
            draws[1:], fixed=draws[0])

    walk_model("DeepWalk 128", deepwalk_trainer, M.DeepWalk)
    walk_model("Node2Vec 128 (p 4, q 1)", node2vec_trainer, M.Node2Vec,
               p=default(node2vec_trainer, "p"),
               q=default(node2vec_trainer, "q"))

    hg, _ = common.synthetic_hetero()
    ei_dict = {key: np.asarray(v) for key, v in hg.edge_index_dict.items()}
    n_dict = {"movie": 200, "director": 60}
    mp = seeded(lambda: M.MetaPath2Vec(
        n_dict, metapath2vec_trainer.METAPATH,
        default(metapath2vec_trainer, "hidden_dim"), walk_length=4))
    mrng = np.random.default_rng(SEED)

    def mp_draw():
        walks = mp.sample_walks(ei_dict, mrng.integers(0, 200, 128), mrng)
        neg = mrng.integers(0, 260, (128, 1, walks.shape[1]))
        return _both(torch.from_numpy(walks), torch.from_numpy(neg))

    mdraws = [mp_draw() for _ in range(P38_STEPS + 1)]
    runs["MetaPath2Vec 64"] = pair_check(
        "MetaPath2Vec 64", lambda: (mp, default(metapath2vec_trainer, "lr"),
                                    0.0),
        lambda m, dev_: m.embed("movie"),
        lambda m, dev_, w: m(*_pick(w, dev_)), mdraws[1:], fixed=mdraws[0])

    ei = cora["edge_index"]
    grng = np.random.default_rng(SEED)

    def gan_draw(kind):
        pos = ei[:, grng.integers(0, ei.shape[1], 256)]
        fake = grng.integers(0, n, 256)
        u = torch.from_numpy(np.concatenate([pos[0], pos[0]]))
        v = torch.from_numpy(np.concatenate([pos[1], fake]))
        lab = torch.cat([torch.ones(256), torch.zeros(256)])
        return {**_both(u, v, lab), "kind": kind}

    def gan_loss(m, dev_, b):
        u, v, lab = _pick(b, dev_)
        return (m(u, v, lab) if b["kind"] == "d"
                else m(u[:256], v[256:]))

    gfixed = gan_draw("d")
    runs["GraphGAN 64"] = pair_check(
        "GraphGAN 64", lambda: (seeded(lambda: M.GraphGAN(
            n, default(graphgan_trainer, "hidden_dim"))),
            default(graphgan_trainer, "lr"), 0.0),
        lambda m, dev_: m.dis_score(*_pick(gfixed, dev_)[:2]), gan_loss,
        [gan_draw(kind) for _ in range(P38_STEPS) for kind in "dg"],
        fixed=gfixed)

    with torch.no_grad():
        teacher = seeded(lambda: M.GCNModel(16, ncls, drop_rate=0.0))
        t_logits = common.predict(teacher, d["x"], d["edge_index"])
    gl = _both(d["x"], t_logits, d["y"], d["train_mask"])
    runs["GLNN 16"] = pair_check(
        "GLNN 16", lambda: (seeded(lambda: M.GLNNStudent(
            default(glnn_trainer, "hidden_dim"), ncls, drop_rate=0.0,
            in_channels=fdim)), default(glnn_trainer, "lr"), 0.0),
        lambda m, dev_: m(_pick(gl, dev_)[0]),
        lambda m, dev_, _: M.distill_loss(m(_pick(gl, dev_)[0]),
                                          *_pick(gl, dev_)[1:], lam=0.5),
        [None] * P38_STEPS)

    srng = np.random.default_rng(SEED)
    bs = default(seal_trainer, "batch_size")

    def seal_draw():
        lab, sei, b, y, ng = seal_trainer.subgraph_batch(ei, n, srng, bs)
        return {**_both(*(torch.from_numpy(a) for a in (lab, sei, b, y))),
                "ng": ng}

    def seal_out(m, dev_, b):
        lab, sei, bb, _ = _pick(b, dev_)
        return m(lab, sei, None, bb, b["ng"])

    sdraws = [seal_draw() for _ in range(P38_STEPS + 1)]
    runs["SEAL 16 (k 6)"] = pair_check(
        "SEAL 16 (k 6)", lambda: (seeded(lambda: M.SEALModel(
            default(seal_trainer, "hidden_dim"), k=6)),
            default(seal_trainer, "lr"), 0.0),
        lambda m, dev_: seal_out(m, dev_, sdraws[0]),
        lambda m, dev_, b: torch.nn.functional.
        binary_cross_entropy_with_logits(seal_out(m, dev_, b)[:, 0],
                                         _pick(b, dev_)[3].float()),
        sdraws[1:], fixed=sdraws[0])

    e2 = torch.from_numpy(cogsl_trainer.second_view(
        d["edge_index"].numpy(), SEED))
    cg = _both(d["x"], d["edge_index"], e2, d["y"], d["train_mask"])
    runs["CoGSL 16"] = pair_check(
        "CoGSL 16", lambda: (seeded(lambda: M.CoGSLModel(
            ncls, default(cogsl_trainer, "hidden_dim"), in_channels=fdim)),
            default(cogsl_trainer, "lr"), 0.0),
        lambda m, dev_: m(*_pick(cg, dev_)[:3])[0][2],
        lambda m, dev_, _: cogsl_trainer.cogsl_loss(
            m(*_pick(cg, dev_)[:3]), *_pick(cg, dev_)[3:]),
        [None] * P38_STEPS)

    fgen = torch.Generator().manual_seed(SEED + 38)
    frng = np.random.default_rng(SEED)

    def flow_draw():
        X1 = torch.nn.functional.one_hot(torch.from_numpy(
            frng.integers(0, 4, 8)), 4).float()
        e = frng.integers(0, 3, (8, 8))
        E1 = torch.nn.functional.one_hot(torch.from_numpy(
            np.triu(e) + np.triu(e, 1).T), 3).float()
        t = torch.rand((), generator=fgen)
        fd = flow_draws(fgen, 8, 4, 3, t)
        keys = sorted(fd)
        return {**_both(X1, E1, t.reshape(1), *(fd[key] for key in keys)),
                "keys": keys}

    def flow_loss(m, dev_, b):
        X1, E1, t, *rest = _pick(b, dev_)
        Xt, Et = flow_interpolate_apply(dict(zip(b["keys"], rest)), X1, E1)
        return defog_trainer.flow_loss(m, Xt, Et, torch.zeros(1, device=
                                       X1.device), t[0], X1, E1)

    fdraws = [flow_draw() for _ in range(P38_STEPS + 1)]
    runs["DeFoG (2 layers)"] = pair_check(
        "DeFoG (2 layers)", lambda: (seeded(lambda: M.DeFoGModel(
            **defog_trainer.DIMS)), default(defog_trainer, "lr"), 0.0),
        lambda m, dev_: m(*_pick(fdraws[0], dev_)[:2],
                          torch.zeros(1, device=dev_),
                          _pick(fdraws[0], dev_)[2][0]),
        flow_loss, fdraws[1:], fixed=fdraws[0])
    sync()
    counts = read_counts(k)
    if any(counts.values()):
        fail(f"phase 38's COO models launched kernels: {counts}")
    return counts, runs


def phase_slice21(k, smi, twin, GATModel, GCNModel, load_jax_params, plan,
                  x, ei):
    """Phase 38: (a) C39's deterministic gathered flash backward held
    bitwise over two GAT steps; (b) the port's profiling utilities on
    row 1 and the GCN step; (c) the A6e models against the CPU."""
    phase_start("phase 38: C39 bitwise GAT steps, utils.profiling on the "
                "main path, the A6e models against the CPU")
    t_phase = time.perf_counter()
    gat_counts, c39 = c39_gat_steps(k, twin, GATModel, load_jax_params,
                                    plan, x, ei)
    prof_counts, prof = profiling_path(k, GCNModel, load_jax_params, plan,
                                       x, ei)
    a6e_counts, a6e = a6e_models(k)
    out = {"c39": c39, "profiling": prof, "a6e": a6e,
           "seconds": time.perf_counter() - t_phase}
    print(f"  ({smi}) phase 38 in {out['seconds']:.1f} s")
    return gat_counts, prof_counts, a6e_counts, out


# -- phase 39: the export trio, FusedGATModel, the graph-LLM
# twins and the thin models of models/compat.py

# the fresh process of phase 39 (a): it imports only `serve`, loads the
# artifact, and runs the requests (argv: the directory, the count)
EXPORT_CHILD = r'''
import hashlib, json, sys, time
import torch
t0 = time.perf_counter()
from gammagl_tpu_torch.serve import load_exported
prog = load_exported(sys.argv[1] + "/gcn.pt2")
load_s = time.perf_counter() - t0
sm = sys.modules["gammagl_tpu_torch.ops.cuda.segment_matmul"]
x = torch.load(sys.argv[1] + "/x.pt").cuda()
ei = torch.load(sys.argv[1] + "/ei.pt").cuda()
lat, launches, digests = [], [], []
with torch.no_grad():
    prog(x, ei)
    torch.cuda.synchronize()
    for r in range(int(sys.argv[2])):
        xr = x + r * 1e-3
        torch.cuda.synchronize()
        before = sm.spmm_csr.launches
        t = time.perf_counter()
        out = prog(xr, ei)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        launches.append(sm.spmm_csr.launches - before)
        digests.append(hashlib.sha256(
            out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            .hexdigest())
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        prog(x, ei)
    stop.record()
    torch.cuda.synchronize()
bad = [m for m in sys.modules if m == "gammagl_tpu" or m.startswith(
    ("gammagl_tpu.", "gammagl_tpu_torch.models", "jax"))]
print(json.dumps({"load_s": load_s, "lat_ms": lat, "launches": launches,
                  "digests": digests, "imported": bad,
                  "events_ms": start.elapsed_time(stop) / 20}))
'''


def _digest(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def gcn_request_routes(sess, xr, ei):
    """One GCN request timed through the op (``gammagl::spmm_csr``) and
    through its CUDA implementation called directly (`op_routes`); the
    two outputs bitwise equal."""
    with direct_launches():
        direct = sess(xr, ei)
    if not torch.equal(sess(xr, ei), direct):
        fail("the GCN request differs through the op and without it")
    return op_routes("GCN request (bitwise equal on both routes)",
                     lambda: sess(xr, ei))


def export_path(k, GCNModel, InferenceSession, load_jax_params, plan, x, ei):
    """(a) Phase 5's GCN exported on its CSR plan, saved, and loaded in a
    fresh process that imports only `serve`: its logits bitwise the live
    session's, 3 `spmm_csr` launches a request there."""
    import tempfile
    from gammagl_tpu_torch.serve import (export_forward, load_exported,
                                         save_exported)
    model = gcn_model(GCNModel, load_jax_params)
    sess = InferenceSession(model, (x, ei), device="cuda",
                            compute_dtype=torch.bfloat16, plan=plan)
    requests = [x + r * 1e-3 for r in range(N_REQUESTS)]
    out = {"request_ms_by_route": gcn_request_routes(sess, requests[0], ei)}
    sync()
    reset_counts(k)
    live, live_lat = [], []
    for xr in requests:
        t0 = time.perf_counter()
        logits = sess(xr, ei)
        sync()
        live_lat.append((time.perf_counter() - t0) * 1e3)
        live.append(_digest(logits))
    if read_counts(k) != every_kernel({"spmm_csr": N_LAYERS}, N_REQUESTS):
        fail(f"GCN session launches {read_counts(k)}")
    t0 = time.perf_counter()
    ep = export_forward(model, (x, ei), device="cuda",
                        compute_dtype=torch.bfloat16, plan=plan)
    out["export_s"] = time.perf_counter() - t0
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    if ops.count("gammagl.spmm_csr.default") != N_LAYERS:
        fail(f"the exported GCN calls gammagl.spmm_csr "
             f"{ops.count('gammagl.spmm_csr.default')} times")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        save_exported(ep, os.path.join(tmp, "gcn.pt2"))
        out["artifact_bytes"] = os.path.getsize(os.path.join(tmp, "gcn.pt2"))
        torch.save(x.cpu(), os.path.join(tmp, "x.pt"))
        torch.save(ei.cpu(), os.path.join(tmp, "ei.pt"))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, tmp, str(N_REQUESTS)],
            capture_output=True, text=True, timeout=300, cwd=root,
            env=dict(os.environ, PYTHONPATH=root))
        out["child_s"] = time.perf_counter() - t0
        # the same artifact here too, timed in turns with the live session
        # (live, loaded, loaded, live) on one warm card
        prog = load_exported(os.path.join(tmp, "gcn.pt2"))
    with torch.no_grad():
        if _digest(prog(requests[0], ei)) != live[0]:
            fail("the artifact loaded here differs from the live session")
        turns = {"live": [], "loaded": []}
        for who in ("live", "loaded", "loaded", "live"):
            run = sess if who == "live" else prog
            turns[who].append(cuda_ms(lambda: run(x, ei), iters=20))
    out["events_ms_in_turns"] = turns
    if res.returncode != 0:
        fail(f"the exported GCN's process failed:\n{res.stderr[-3000:]}")
    child = json.loads(res.stdout.strip().splitlines()[-1])
    if child["imported"]:
        fail(f"loading the artifact imported {child['imported']}")
    if child["launches"] != [N_LAYERS] * N_REQUESTS:
        fail(f"the loaded program launched {child['launches']} spmm_csr")
    if child["digests"] != live:
        fail("the loaded program's logits differ from the live session's")
    out.update(load_s=child["load_s"], loaded_request_ms=child["lat_ms"],
               live_request_ms=live_lat,
               loaded_p50_ms=float(np.median(child["lat_ms"])),
               live_p50_ms=float(np.median(live_lat)),
               loaded_events_ms=child["events_ms"])
    print(f"  exported GCN: {out['artifact_bytes']} bytes, export "
          f"{out['export_s']:.2f} s, load {child['load_s']:.2f} s in a fresh "
          f"process ({out['child_s']:.1f} s in all); requests p50 "
          f"{out['loaded_p50_ms']:.3f} ms loaded, {out['live_p50_ms']:.3f} "
          f"ms live (host clock); there on CUDA events "
          f"{out['loaded_events_ms']:.3f} ms; here in turns live "
          f"{turns['live']} ms, loaded {turns['loaded']} ms (20 requests "
          f"each); logits bitwise equal, {N_LAYERS} spmm_csr a request")
    counts = every_kernel({})
    counts["spmm_csr"] = sum(child["launches"])
    return counts, out


def llm_twins():
    """(c) The graph-LLM twins at their defaults, on the card and on the
    CPU from the same host-drawn init: each step's loss at rtol
    W58_LOSS_RTOL, the forwards (graph tokens, spliced inputs) at
    W58_OUT_TOL of max |out|, the losses falling by MIN_FALL."""
    from gammagl_tpu_torch.examples import (graphgpt_trainer, llaga_trainer,
                                            llmrec_trainer, nlgraph_trainer,
                                            walklm_trainer)
    os.environ["GGL_TPU_OFFLINE"] = "1"
    out = {}
    for label, module, flags in (
            ("graphgpt_stage1", graphgpt_trainer, []),
            ("graphgpt_stage2", graphgpt_trainer, ["--stage", "2"]),
            ("llaga_nd", llaga_trainer, ["--template", "nd"]),
            ("llaga_ho", llaga_trainer, ["--template", "ho"])):
        res = {dev: module.main(module.parser().parse_args(
            ["--device", dev, *flags])) for dev in ("cuda", "cpu")}
        card, cpu = res["cuda"]["losses"], res["cpu"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        if not (np.isfinite(card).all() and rel <= W58_LOSS_RTOL):
            fail(f"{label}: losses on the card {card} vs the CPU {cpu}")
        if not card[-1] < (1 - MIN_FALL) * card[0]:
            fail(f"{label}: loss did not fall by {MIN_FALL:.0%}: {card}")
        if "graph_tokens" in res["cuda"]:
            check_close(f"{label} graph tokens vs the CPU",
                        res["cuda"]["graph_tokens"].cpu(),
                        res["cpu"]["graph_tokens"], 0.0, atol=W58_OUT_TOL)
        steps = res["cuda"]["step_ms"]
        print(f"  {label}: {len(card)} steps, losses {card[0]:.5f} -> "
              f"{card[-1]:.5f} (worst rel. gap to the CPU {rel:.2e}); step "
              f"ms {[round(t, 2) for t in steps]}")
        out[label] = {"losses": card, "cpu_losses": cpu, "loss_rel_err": rel,
                      "step_ms": steps, "cpu_step_ms": res["cpu"]["step_ms"]}
    for label, module in (("llmrec", llmrec_trainer),
                          ("nlgraph", nlgraph_trainer),
                          ("walklm", walklm_trainer)):
        got = {dev: module.main(module.parser().parse_args(["--device", dev]))
               for dev in ("cuda", "cpu")}
        out[label] = {"max_abs_err": check_close(
            f"{label} spliced input vs the CPU", got["cuda"].cpu(),
            got["cpu"], 0.0, atol=W58_OUT_TOL)}
    return out


def compat_models():
    """(d) The thin models of `models/compat.py` at Cora's shape (the
    graph of phase 35) and their twins' widths, each built on the CPU,
    its forward there, then on a copy on the card: every output at
    W58_OUT_TOL of max |out|."""
    from gammagl_tpu_torch.models import compat as C
    rng = np.random.default_rng(SEED + 39)
    cora = cora_shape(rng)
    x, ei = (torch.from_numpy(cora[key]) for key in ("x", "edge_index"))
    n, f, c = CORA_NODES, CORA_FEAT, CORA_CLASSES
    g = torch.Generator().manual_seed(SEED + 39)
    walks = torch.randint(0, n, (64, 6), generator=g)
    u, v = torch.randint(0, n, (256,), generator=g), torch.randint(
        0, n, (256,), generator=g)
    evecs, evals = torch.randn(n, 16, generator=g), torch.linspace(0, 2, 16)
    cases = {
        "AGNNModel": (lambda: C.AGNNModel(c, in_channels=f), (x, ei)),
        "FILMModel": (lambda: C.FILMModel(c, in_channels=f), (x, ei)),
        "GMMModel": (lambda: C.GMMModel(c, in_channels=f), (x, ei)),
        "DNAModel": (lambda: C.DNAModel(c, in_channels=f), (x, ei)),
        "HCHA": (lambda: C.HCHA(c, in_channels=f), (x, ei, None, n, n)),
        "MGNNI_m_att": (lambda: C.MGNNI_m_att(c, in_channels=f), (x, ei)),
        "DFADModel": (lambda: C.DFADModel(c), (x, ei)),
        "GNN": (lambda: C.GNN(c, use_mlp_in=True, in_channels=f), (x, ei)),
        "LogReg": (lambda: C.LogReg(c, in_channels=f), (x,)),
        "EdgePromptNodeClassifier": (
            lambda: C.EdgePromptNodeClassifier(c, in_channels=f), (x,)),
        "ReModel": (lambda: C.ReModel(3), (torch.rand(n, 3, generator=g),)),
        "SkipGramModel": (lambda: C.SkipGramModel(n),
                          (walks, walks.flip(0))),
        "Generator": (lambda: C.Generator(n), (u, v, torch.rand(256))),
        "Discriminator": (lambda: C.Discriminator(n),
                          (u, v, (torch.arange(256) % 2).float())),
        "Encoder": (lambda: C.Encoder(in_channels=f), (x, ei)),
        "EigenMLP": (lambda: C.EigenMLP(), (evecs, evals)),
        "SpaSpeNode": (lambda: C.SpaSpeNode(in_channels=f),
                       (x, ei, evecs, evals)),
        "DFADGenerator": (lambda: C.DFADGenerator(32, f, in_channels=32),
                          (torch.randn(8, 32, generator=g),)),
    }
    out = {}

    def leaves(o):
        return [o] if isinstance(o, torch.Tensor) else [
            t for part in o for t in leaves(part)]

    def on(dev, args):
        return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                     for a in args)

    for label, (make, args) in cases.items():
        torch.manual_seed(SEED + 39)
        cpu = make().eval()
        with torch.no_grad():
            want = leaves(cpu(*args))
            card = copy.deepcopy(cpu).to("cuda")
            sync()
            t0 = time.perf_counter()
            got = leaves(card(*on("cuda", args)))
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        err = max(check_close(f"{label} forward vs the CPU", a.cpu(), b, 0.0,
                              atol=W58_OUT_TOL) for a, b in zip(got, want))
        out[label] = {"max_abs_err": err, "request_ms": ms}
    a = (torch.randn(64, 3, 2, generator=g), torch.randn(64, 2, generator=g),
         *torch.randn(3, 1, 3, generator=g), torch.tensor(0.3),
         torch.softmax(torch.randn(1, 3, generator=g), 1), 64.0)
    want = C.amp_elbo_regression_loss(*a)
    got = C.amp_elbo_regression_loss(*on("cuda", a))
    out["amp_elbo_regression_loss"] = {"max_abs_err": check_close(
        "amp_elbo_regression_loss vs the CPU", got.cpu()[None], want[None],
        W58_LOSS_RTOL, atol=0.0)}
    return out


def phase_slice22(k, smi, twin, GATModel, GCNModel, InferenceSession,
                  load_jax_params, plan, x, ei):
    """Phase 39: (a) the exported GCN run from a file in a fresh process,
    the GCN request through the op and the direct launch; (b)
    FusedGATModel (phase 7's shape and parameters) on the flash kernels;
    (c) the graph-LLM twins and (d) the thin models of `models/compat.py`
    against the CPU (COO: no kernel)."""
    phase_start("phase 39: the exported GCN from a file, FusedGATModel, the "
                "graph-LLM twins and the compat models against the CPU")
    t_phase = time.perf_counter()
    export_counts, export = export_path(k, GCNModel, InferenceSession,
                                        load_jax_params, plan, x, ei)
    fgat_counts, fgat_t_counts, fgat = fused_gat_path(
        k, twin, GATModel, load_jax_params, x, ei)
    sync()
    reset_counts(k)
    llm = llm_twins()
    compat = compat_models()
    coo_counts = read_counts(k)
    if any(coo_counts.values()):
        fail(f"the COO models of phase 39 launched kernels: {coo_counts}")
    out = {"export": export, "fused_gat_model": fgat, "llm_twins": llm,
           "compat": compat, "seconds": time.perf_counter() - t_phase}
    print(f"  ({smi}) phase 39 in {out['seconds']:.1f} s")
    return export_counts, fgat_counts, fgat_t_counts, coo_counts, out


def hier_part_launches(part, r):
    """Kernel launches of one call of the planned two-level tier on part
    r: the interior class is `spmm_csr`, each later class with edges
    `spmm_csr_acc`, and each of those plans with cut rows one fold."""
    run = [part.interior[r]] + [c[r] for c in (part.intra, part.inter)
                                if c[r].num_edges]
    return {"spmm_csr": 1, "spmm_csr_acc": len(run) - 1,
            "csr_fold": sum(1 for p in run if p.row_split().cut_row.size)}


def hier_rank_share(part, r):
    """Part r's share of a planned two-level partition, for its process:
    its own plans (the others None) and no COO edge lists, which the
    planned tier never reads."""
    fields = ("interior", "interior_w", "intra", "intra_w", "inter",
              "inter_w")
    share = part._replace(
        base=part.base._replace(edge_index=None, edge_weight=None),
        **{f: tuple(v if i == r else None
                    for i, v in enumerate(getattr(part, f)))
           for f in fields})
    if part.transpose is not None:
        share = share._replace(transpose=hier_rank_share(part.transpose, r))
    return share


def hier_worker(tmp, rank):
    """One process of phase 40 (a), ``chip_smoke.py --hier-worker DIR
    RANK``: joins the gloo group of the HIER_GRID processes (a file store
    in DIR), loads its share of the partition, runs both directions of the
    tier on its block of the inputs once with its launches checked (its
    output saved as bf16 bits) and 3 times timed, then HIER_STEPS staged
    GCN steps with their launches checked; writes result<RANK>.json."""
    import datetime
    import pickle
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gammagl_tpu_torch.ops import cuda as k
    from gammagl_tpu_torch.parallel import (
        hier_world, make_hier_halo_spmm_planned_pair,
        make_partitioned_gcn_train_staged, shard_nodes)
    torch.backends.cuda.matmul.allow_tf32 = False
    S, D = HIER_GRID
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=S * D,
                            timeout=datetime.timedelta(seconds=600))
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    with open(os.path.join(tmp, f"part{rank}.pkl"), "rb") as f:
        part = pickle.load(f)
    with open(os.path.join(tmp, "meta.json")) as f:
        meta = json.load(f)
    inp = {name: np.load(os.path.join(tmp, f"{name}.npy"), mmap_mode="r")
           for name in ("x_bits", "g_bits", "feat", "y", "train")}
    grid = hier_world(S, D)
    spmm, spmm_t = make_hier_halo_spmm_planned_pair(part, grid)
    res = {"rank": rank, "launches": {}, "ms": {}}
    for label, fn, bits, p in (("forward", spmm, "x_bits", part),
                               ("transpose", spmm_t, "g_bits",
                                part.transpose)):
        blk = shard_nodes(inp[bits], part, rank=rank,
                          device=dev).view(bf16)
        want = every_kernel(hier_part_launches(p, rank))
        dist.barrier()
        sync()
        reset_counts(k)
        out = fn(blk)
        sync()
        counts = read_counts(k)
        if counts != want:
            fail(f"hier tier {label} rank {rank}: expected launches {want}, "
                 f"counted {counts}")
        res["launches"][label] = counts
        np.save(os.path.join(tmp, f"{label}{rank}.npy"),
                out.view(torch.int16).cpu().numpy())
        times = []
        for _ in range(3):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            fn(blk)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        res["ms"][label] = times
        dist.barrier()
        np.save(os.path.join(tmp, f"{label}_f32_{rank}.npy"),
                fn(blk.float()).cpu().numpy())
    per_step = {name: PAPERS_LAYERS * n for name, n in
                hier_part_launches(part, rank).items()}
    for name, n in hier_part_launches(part.transpose, rank).items():
        per_step[name] += (PAPERS_LAYERS - 1) * n
    xs = shard_nodes(inp["feat"], part, rank=rank, device=dev, dtype=bf16)
    ys = shard_nodes(inp["y"], part, rank=rank, device=dev)
    ms = shard_nodes(inp["train"], part, rank=rank, device=dev)
    params, opt, step, _ = make_partitioned_gcn_train_staged(
        part, meta["f"], HIDDEN, meta["c"], num_layers=PAPERS_LAYERS,
        compute_dtype=bf16, learning_rate=PAPERS_LR, device=dev,
        group=grid)
    res.update(losses=[], step_ms=[], step_launches=every_kernel({}))
    for i in range(HIER_STEPS):
        dist.barrier()
        sync()
        reset_counts(k)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, xs, ys, ms)
        res["losses"].append(float(loss))
        sync()
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(k)
        if counts != every_kernel(per_step):
            fail(f"hier GCN step {i} rank {rank}: expected launches "
                 f"{per_step}, counted {counts}")
        for name in counts:
            res["step_launches"][name] += counts[name]
    res["gat"] = hier_gat_check(k, rank)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"result{rank}.json"), "w") as f:
        json.dump(res, f)


def hier_gat_check(k, rank):
    """In `hier_worker`: the partitioned GAT layer over every process of
    the group on a random graph of HIER_GAT_SHAPE (the same in each, f32),
    forward and backward twice from one input by one layer: output and
    the gradients in h, a_src and a_dst bitwise equal (a sent row's
    gradient comes back through the exchange and is summed into its owner
    by `spmm_csr` on the scatter plan, never by atomics); each run 1 flash
    forward, 1 flash backward and 3 `spmm_csr`; the own rows of the output
    and of dh, and a_src's and a_dst's gradients summed over the
    processes, against the layer at one part within 1e-4 of max |ref|."""
    import torch.distributed as dist
    from gammagl_tpu_torch.parallel import (build_halo_partition_attn,
                                            make_partitioned_gat_layer,
                                            shard_nodes)
    dev = torch.device("cuda")
    n, e, heads, fh = HIER_GAT_SHAPE
    rng = np.random.default_rng(SEED + 41)
    ei = rng.integers(0, n, (2, e))
    h = rng.normal(size=(n, heads * fh)).astype(np.float32)
    a_s, a_d = (rng.normal(size=(heads, fh)).astype(np.float32) * 0.3
                for _ in range(2))
    part = build_halo_partition_attn(ei, n, dist.get_world_size())
    one = build_halo_partition_attn(ei, n, 1)
    want = {"flash_forward": 1, "flash_backward": 1, "spmm_csr": 3}

    def run(p, layer, r):
        hb = shard_nodes(h, p, rank=r, device=dev).requires_grad_()
        st = torch.tensor(a_s, device=dev, requires_grad=True)
        at = torch.tensor(a_d, device=dev, requires_grad=True)
        dist.barrier()
        sync()
        reset_counts(k)
        out = layer(hb, st, at)
        (out ** 2).sum().backward()
        sync()
        return (out.detach(), hb.grad, st.grad, at.grad), read_counts(k)

    layer = make_partitioned_gat_layer(part, heads)
    runs = [run(part, layer, rank) for _ in range(2)]
    for i, (_, counts) in enumerate(runs):
        if {name: counts[name] for name in want} != want:
            fail(f"partitioned GAT at {part.num_parts} parts, rank {rank}, "
                 f"run {i}: expected launches {want}, counted {counts}")
    (a, _), (b, _) = runs
    for name, x, y in zip(("out", "dh", "da_src", "da_dst"), a, b):
        if not torch.equal(x, y):
            fail(f"partitioned GAT at {part.num_parts} parts, rank {rank}: "
                 f"two runs from one input differ in {name}")
    ref, _ = run(one, make_partitioned_gat_layer(one, heads), 0)
    lo = rank * part.rows_per
    hi = min(lo + part.rows_per, n)
    err = 0.0
    for name, got, full in (("out", a[0], ref[0]), ("dh", a[1], ref[1])):
        err = max(err, check_close(
            f"rank {rank}: partitioned GAT {name} vs one part",
            got[:hi - lo], full[lo:hi], 0.0, atol=1e-4,
            scale=float(full[:n].abs().max())))
    for name, got, full in (("da_src", a[2], ref[2]),
                            ("da_dst", a[3], ref[3])):
        got = got.clone()
        dist.all_reduce(got)
        err = max(err, check_close(
            f"rank {rank}: partitioned GAT {name}, summed over the parts, "
            "vs one part", got, full, 0.0, atol=1e-4))
    return {"parts": part.num_parts, "launches": runs[0][1],
            "max_abs_err": err, "bitwise_repeat": True}


def phase_hier_tier(k, shard, tier_calls, papers_losses, smi):
    """Phase 40 (a): the planned two-level tier at HIER_GRID on phase 24's
    papers shard in HIER_GRID processes on the one card (`hier_worker`),
    bf16 F = 256: forward and transpose against phase 24's single plan
    within 3e-2 of max |out|, each rank's launches exact, both directions
    timed beside phase 24's one-part tier; then HIER_STEPS staged GCN
    steps, the loss the same on every rank, the first within LOSS_TOL of
    phase 25's. Returns (tier launches, step launches, the figures)."""
    import pickle
    import shutil
    import tempfile
    from gammagl_tpu_torch.parallel import (build_hier_halo_partition_planned,
                                            traffic_report)
    S, D = HIER_GRID
    phase_start(f"phase 40 (a): the planned two-level tier at ({S}, {D}) on "
                f"the papers shard, {S * D} processes on the one card")
    t_phase = time.perf_counter()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    ei, w, n = shard["ei"], shard["w"], shard["x"].shape[0]
    t0 = time.perf_counter()
    part = build_hier_halo_partition_planned(ei, n, S, D, w)
    t_part = time.perf_counter() - t0
    base = part.base
    rep = traffic_report(base, HIDDEN, bf16)
    classes = {name: [p.num_edges for p in getattr(part, name)]
               for name in ("interior", "intra", "inter")}
    print(f"  partition in {t_part:.2f} s: rows_per {base.rows_per}, H1 "
          f"{base.h_intra}, H2 {base.h_inter}; edges by rank {classes}; "
          f"a layer at F={HIDDEN} bf16: {rep}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hier_")
    try:
        t0 = time.perf_counter()
        for r in range(S * D):
            with open(os.path.join(tmp, f"part{r}.pkl"), "wb") as f:
                pickle.dump(hier_rank_share(part, r), f, protocol=5)
        gen = torch.Generator().manual_seed(SEED + 40)
        x = torch.randn(n, HIDDEN, generator=gen).to(bf16)
        g = torch.randn(n, HIDDEN, generator=gen).to(bf16)
        for name, arr in (("x_bits", x.view(torch.int16).numpy()),
                          ("g_bits", g.view(torch.int16).numpy()),
                          ("feat", shard["x"]), ("y", shard["y"]),
                          ("train", shard["train"].astype(np.float32))):
            np.save(os.path.join(tmp, f"{name}.npy"), arr)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"f": int(shard["x"].shape[1]), "c": int(shard["c"])},
                      f)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--hier-worker", tmp,
             str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(S * D)]
        # the references meanwhile: phase 24's plan of the whole graph
        # (its rows padded to the one-part partition's rows_per)
        single = shard["single"]
        w_single = torch.from_numpy(w[single.perm]).to(dev)
        tp = single.transpose()
        pad = torch.zeros(single.num_src - n, HIDDEN, dtype=bf16)
        refs = {"forward": k.spmm_csr(torch.cat([x, pad]).to(dev), w_single,
                                      single, weights_padded=True)[:n],
                "transpose": k.spmm_csr(torch.cat([g, pad]).to(dev),
                                        w_single[tp.arrays(dev)[2]], tp,
                                        weights_padded=True)[:n]}

        def plain(v, wv, plan):
            # the plain version in f32, 64 columns at a time (its per-edge
            # messages of the whole width would take 17 GB)
            v = torch.cat([v, pad]).float().to(dev)
            return torch.cat([k.spmm_csr_reference(
                v[:, c:c + 64].contiguous(), wv, plan, weights_padded=True)
                for c in range(0, HIDDEN, 64)], 1)[:n]

        plain32 = {"forward": lambda: plain(x, w_single, single),
                   "transpose": lambda: plain(g, w_single[tp.arrays(dev)[2]],
                                              tp)}
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=900)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        t_workers = time.perf_counter() - t0
        for r, (proc, log) in enumerate(zip(procs, logs)):
            if proc.returncode != 0:
                fail(f"hier worker {r} exited {proc.returncode}:\n"
                     f"{log[-4000:]}")
        results = []
        for r in range(S * D):
            with open(os.path.join(tmp, f"result{r}.json")) as f:
                results.append(json.load(f))
        inv = torch.from_numpy(part.node_inv).to(dev)
        err, err32 = 0.0, 0.0
        for label in ("forward", "transpose"):
            out = torch.cat([torch.from_numpy(np.load(os.path.join(
                tmp, f"{label}{r}.npy"))) for r in range(S * D)]).view(bf16)
            out = out[:n].to(dev)[inv]
            err = max(err, check_rows(
                f"two-level tier {label} vs one plan bf16 F={HIDDEN}", out,
                refs[label], HIER_ROW_TOL["bf16"]))
            del out
            out = torch.cat([torch.from_numpy(np.load(os.path.join(
                tmp, f"{label}_f32_{r}.npy"))) for r in range(S * D)])
            out = out[:n].to(dev)[inv]
            err32 = max(err32, check_rows(
                f"two-level tier {label} f32 vs the plain version F={HIDDEN}",
                out, plain32[label](), HIER_ROW_TOL["f32"]))
            del out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tier_launches_all = every_kernel({})
    step_launches_all = every_kernel({})
    for res in results:
        for name in tier_launches_all:
            tier_launches_all[name] += (res["launches"]["forward"][name]
                                        + res["launches"]["transpose"][name])
            step_launches_all[name] += res["step_launches"][name]
        print(f"  rank {res['rank']}: launches forward "
              f"{ {n_: c for n_, c in res['launches']['forward'].items() if c} }"
              f", transpose "
              f"{ {n_: c for n_, c in res['launches']['transpose'].items() if c} }"
              f"; losses {res['losses']}, step ms {res['step_ms']}")
        gat = res["gat"]
        print(f"  rank {res['rank']}: the GAT layer at {gat['parts']} parts "
              f"(random graph {HIER_GAT_SHAPE}, f32): two runs bitwise "
              f"equal, launches a run "
              f"{ {n_: c for n_, c in gat['launches'].items() if c} }, "
              f"max_abs_err {gat['max_abs_err']:.3e} vs one part")
    losses = results[0]["losses"]
    if any(res["losses"] != losses for res in results):
        fail(f"hier GCN: the ranks' losses differ: "
             f"{[res['losses'] for res in results]}")
    want = papers_losses["kernel"][0]
    if not np.isfinite(losses).all() or abs(losses[0] - want) > (
            LOSS_TOL * abs(want)):
        fail(f"hier GCN step-0 loss {losses[0]} vs phase 25's {want}")
    # a call's time: the slowest rank's wall clock, median of 3
    ms = {label: float(np.median(np.max([res["ms"][label] for res in
                                         results], axis=0)))
          for label in ("forward", "transpose")}
    step_ms = [max(res["step_ms"][i] for res in results)
               for i in range(HIER_STEPS)]
    out = {"grid": [S, D], "partition_s": t_part,
           "write_s": t_write, "workers_s": t_workers,
           "rows_per": int(base.rows_per), "h_intra": int(base.h_intra),
           "h_inter": int(base.h_inter), "class_edges": classes,
           "traffic_bf16_f256": rep, "vs_one_plan_max_abs_err": err,
           "f32_vs_plain_max_abs_err": err32,
           "gat_4_parts": [res["gat"] for res in results],
           "tier_forward_ms": ms["forward"],
           "tier_transpose_ms": ms["transpose"],
           "one_part_tier_forward_ms": tier_calls["tier_forward_ms"],
           "one_part_tier_transpose_ms": tier_calls["tier_transpose_ms"],
           "gcn_losses": losses, "gcn_step_ms": step_ms,
           "phase25_step0_loss": want,
           "seconds": time.perf_counter() - t_phase}
    print(f"  ({smi}) a call, slowest rank, median of 3: forward "
          f"{ms['forward']:.3f} ms, transpose {ms['transpose']:.3f} ms "
          f"(phase 24's one part: {tier_calls['tier_forward_ms']:.3f} / "
          f"{tier_calls['tier_transpose_ms']:.3f} ms); GCN steps "
          f"{[round(t, 2) for t in step_ms]} ms; workers {t_workers:.1f} s, "
          f"inputs written in {t_write:.1f} s")
    return tier_launches_all, step_launches_all, out


def copy_rate_gbps(dev):
    """Bytes read plus bytes written a second by a device-to-device copy of
    1 GiB (bf16), CUDA events, mean of 20: the memory rate HwModel()
    takes."""
    src = torch.empty(2 ** 29, dtype=torch.bfloat16, device=dev).normal_()
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src))
    del src, dst
    return 2 * 2 ** 30 / (ms * 1e-3) / 1e9


def phase_partitioned_gat(k, x, ei, smi):
    """Phase 40 (b): `make_partitioned_gat_train` at one part on the
    arxiv-shape graph (phases 6-7's widths, bf16, phase 30's planted
    labels): step-0 gradients against the same recipe on the CPU within
    GRAD_TOL of each parameter's max |grad|, two loss_and_grads from one
    state bitwise equal, PGAT_STEPS steps with launches checked (remat:
    each layer's flash forward runs twice; 2 flash backward and 4 SpMM)
    and the loss falling MIN_FALL, PGAT_REQUESTS eval forwards (2 flash
    forward each). Returns (request launches, step launches, figures)."""
    from gammagl_tpu_torch.parallel import (build_halo_partition_attn,
                                            make_partitioned_gat_train,
                                            shard_nodes)
    phase_start("phase 40 (b): the partitioned GAT (make_partitioned_gat_"
                "train) at one part on the arxiv shape")
    t_phase = time.perf_counter()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    ei_np = ei.cpu().numpy()
    t0 = time.perf_counter()
    part = build_halo_partition_attn(ei_np, N_NODES, 1)
    t_part = time.perf_counter() - t0
    _, x_dir, y, mask = zoo_inputs(x, ei)
    arrays = {"x": x_dir.cpu().numpy(), "y": y.cpu().numpy(),
              "m": mask.float().cpu().numpy()}
    plan = part.plans[0]
    fold = int(bool(plan.row_split().cut_row.size))
    sfold = int(bool(plan.edge_scatter_plan().row_split().cut_row.size))
    per_step = {"flash_forward": 4, "flash_fwd_fold": 4 * fold,
                "flash_backward": 2, "spmm_csr": 4, "csr_fold": 4 * sfold}
    per_request = {"flash_forward": 2, "flash_fwd_fold": 2 * fold}

    def build(device, remat=True):
        params, opt, step, ev = make_partitioned_gat_train(
            part, N_FEAT, GAT_HIDDEN, N_CLASS, heads=GAT_HEADS, num_layers=2,
            compute_dtype=bf16, learning_rate=GAT_LR, remat=remat,
            device=device)
        xs, ys, ms = (shard_nodes(arrays[key], part, device=device)
                      for key in ("x", "y", "m"))
        return params, opt, step, ev, xs, ys, ms

    t0 = time.perf_counter()
    cparams, _, cstep, _, cx, cy, cm = build("cpu", remat=False)
    cpu_loss, cpu_grads = cstep.loss_and_grads(cparams, cx, cy, cm)
    t_cpu = time.perf_counter() - t0
    params, opt, step, ev, xs, ys, ms = build(dev)
    runs = []
    for i in range(2):
        sync()
        reset_counts(k)
        runs.append(step.loss_and_grads(params, xs, ys, ms))
        sync()
        counts = read_counts(k)
        if counts != every_kernel(per_step):
            fail(f"partitioned GAT loss_and_grads {i}: expected launches "
                 f"{per_step}, counted {counts}")
    (l0, g0), (l1, g1) = runs
    if not torch.equal(l0, l1) or any(not torch.equal(g0[n_], g1[n_])
                                      for n_ in g0):
        fail("partitioned GAT: two loss_and_grads from one state differ")
    print(f"  two loss_and_grads from one state bitwise equal (loss "
          f"{float(l0):.6f}); the CPU's {float(cpu_loss):.6f} in "
          f"{t_cpu:.1f} s")
    grad_err = 0.0
    for name, want in cpu_grads.items():
        grad_err = max(grad_err, check_close(
            f"partitioned GAT step-0 grad {name} vs the CPU", g0[name],
            want.to(dev), 0.0, atol=GRAD_TOL))
    losses, step_ms = [], []
    step_launches = every_kernel({})
    for i in range(PGAT_STEPS):
        sync()
        reset_counts(k)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, xs, ys, ms)
        losses.append(float(loss))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(k)
        if counts != every_kernel(per_step):
            fail(f"partitioned GAT step {i}: expected launches {per_step}, "
                 f"counted {counts}")
        for name in counts:
            step_launches[name] += counts[name]
    if not (np.isfinite(losses).all()
            and losses[-1] < (1 - MIN_FALL) * losses[0]):
        fail(f"partitioned GAT: loss did not fall by {MIN_FALL:.0%}: "
             f"{losses}")
    req_launches = every_kernel({})
    lat = []
    for _ in range(PGAT_REQUESTS):
        sync()
        reset_counts(k)
        t0 = time.perf_counter()
        logits = ev(params, xs)
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(k)
        if counts != every_kernel(per_request):
            fail(f"partitioned GAT request: expected launches {per_request}"
                 f", counted {counts}")
        for name in counts:
            req_launches[name] += counts[name]
    if logits.shape != (part.rows_per, N_CLASS) or not bool(
            torch.isfinite(logits).all()):
        fail(f"partitioned GAT logits {tuple(logits.shape)}")
    out = {"partition_s": t_part, "cpu_step0_s": t_cpu,
           "step0_grad_max_abs_err": grad_err, "losses": losses,
           "step_ms": float(np.median(step_ms[1:])),
           "request_ms": float(np.median(lat)),
           "launches_a_step": per_step, "launches_a_request": per_request,
           "seconds": time.perf_counter() - t_phase}
    print(f"  ({smi}) step median {out['step_ms']:.3f} ms (steps "
          f"1-{PGAT_STEPS - 1}), request {out['request_ms']:.3f} ms; losses "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; launches a step {per_step}")
    return req_launches, step_launches, out


def phase_partitioned(k, shard, tier_calls, papers_losses, x, ei, smi):
    """Phase 40: (a) `phase_hier_tier`, (b) `phase_partitioned_gat`, and
    the figures of `parallel.scaling.HwModel()`: the copy rate and phase
    24's one-part tier forward in edges a second."""
    t_phase = time.perf_counter()
    hier_t, hier_s, hier = phase_hier_tier(k, shard, tier_calls,
                                           papers_losses, smi)
    pgat, pgat_t, gat = phase_partitioned_gat(k, x, ei, smi)
    E = int(shard["ei"].shape[1])
    hw = {"hbm_gbps": copy_rate_gbps(torch.device("cuda")),
          "spmm_edges_per_s": E / (tier_calls["tier_forward_ms"] * 1e-3),
          "edges": E}
    print(f"  ({smi}) HwModel figures: copy {hw['hbm_gbps']:.1f} GB/s "
          f"(read + write), the one-part planned tier's forward on the "
          f"papers shard (bf16 F={HIDDEN}, {E} edges) "
          f"{hw['spmm_edges_per_s']:.4e} edges/s")
    out = {"hier_tier": hier, "partitioned_gat": gat, "hw_model": hw,
           "seconds": time.perf_counter() - t_phase}
    print(f"  ({smi}) phase 40 in {out['seconds']:.1f} s")
    return hier_t, hier_s, pgat, pgat_t, out


# -- phase 41: the last of parallel/, sharded serving and checkpoints -------
# (a) one process: `make_sharded_spmm` on the arxiv shape's uniform
# partition at one part (the GCN weights, F = 128 f32), bitwise equal to
# `spmm_csr` on the graph's plan; `make_relation_expert_spmm` at one part on
# phase 26's flattened typed graph at RGCN's widths (128 -> 64 -> 349 f32,
# a full map a relation) against the per-edge COO plain version within
# EXPERT_TOL of max |out| and of each max |grad|; the hetero_rgcn twin's
# --ep path at its defaults for EP_STEPS steps. (b) P41_PROCS processes on
# the one card under gloo (`parallel_worker`): the sharded SpMM by
# destination (bitwise one plan) and uniform, the feature-sharded and the
# expert SpMMs (P41_RELATIONS relations on the arxiv shape, a padding block
# on the last process), the pipeline at P41_PROCS stages (P41_PIPE: micro-
# batches, rows, width), `ShardedInferenceSession` on phase 5's GCN (the
# graph padded by one isolated node to a multiple of P41_PROCS rows)
# bitwise equal to `InferenceSession`'s logits, `ShardedFeatureStore`
# gathers bitwise, a `MultiHostNodeLoader` epoch (P41_LOADER: every k-th
# node a seed, batch, fanouts), and the hetero_rgcn twin's --ep P41_PROCS
# for EP_STEPS steps with a sharded checkpoint after step EP_CKPT and a
# resume that repeats the rest bitwise
EXPERT_TOL, EP_STEPS, EP_CKPT = 1e-5, 5, 3
P41_PROCS, P41_RELATIONS, P41_EXPERT_OUT = 4, 7, 64
P41_PIPE = (8, 4096, 256)
P41_LOADER = (8, 1024, (10, 5))
P41_GATHER = 20_000


def csr_launches(plan, n=1):
    """Launches of n `spmm_csr` calls on ``plan``: the kernel, and a fold
    each where the plan has cut rows."""
    cut = int(plan.row_split().cut_row.size > 0)
    return {"spmm_csr": n, "csr_fold": cut * n}


def add_launches(*dicts):
    out = {}
    for d in dicts:
        for name, n in d.items():
            out[name] = out.get(name, 0) + n
    return out


def expert_plain(x, ei, et, W):
    """The per-edge COO plain version of the expert SpMM: each relation's
    edges' messages ``x[src] @ W_r``, summed into their destinations with
    ``index_add`` (differentiable)."""
    out = x.new_zeros(x.shape[0], W.shape[2])
    for r in range(W.shape[0]):
        m = et == r
        out = out.index_add(0, ei[1][m], x[ei[0][m]] @ W[r])
    return out


def expert_check(k, label, run, x, ei, et, W, w_local, tol=EXPERT_TOL):
    """One expert layer forward and backward (a random cotangent) against
    `expert_plain` on the same inputs: out, dx and this process's dW block
    within ``tol`` of each max |ref|. Returns (max abs err, launches)."""
    gen = torch.Generator(device=x.device).manual_seed(SEED + 41)
    per = w_local.shape[0]
    lo = dist_rank() * per
    xk = x.detach().clone().requires_grad_()
    wk = w_local.detach().clone().requires_grad_()
    sync()
    reset_counts(k)
    out = run(ei, et, xk, wk)
    g = torch.randn(out.shape, generator=gen, device=x.device)
    out.backward(g)
    sync()
    counts = read_counts(k)
    xp = x.detach().clone().requires_grad_()
    wp = W.detach().clone().requires_grad_()
    want = expert_plain(xp, ei, et, wp)
    want.backward(g)
    err = check_close(f"{label} out", out.detach(), want.detach(), 0.0,
                      atol=tol)
    err = max(err, check_close(f"{label} dx", xk.grad, xp.grad, 0.0,
                               atol=tol))
    hi = min(lo + per, W.shape[0])
    dw = wp.grad[lo:hi]
    err = max(err, check_close(f"{label} dW (this block)", wk.grad[:hi - lo],
                               dw, 0.0, atol=tol,
                               scale=float(wp.grad.abs().max())))
    if hi - lo < per and bool(wk.grad[hi - lo:].any()):
        fail(f"{label}: a padding relation's gradient is not zero")
    return err, counts


def dist_rank():
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def ep_args(ep, device="cuda"):
    from gammagl_tpu_torch.examples import hetero_rgcn_trainer as het
    return het.parser().parse_args(["--device", device, "--n_epoch",
                                    str(EP_STEPS), "--ep", str(ep)])


def phase_slice24_one(k, simplehgn_trainer, hg, graph, x, ei, smi):
    """Phase 41 (a): the sharded SpMM at one part on the arxiv shape, the
    expert SpMM at one part on the flattened typed graph at RGCN's widths,
    and the hetero_rgcn twin's --ep path; each with its launches. Returns
    (launches by path, figures)."""
    from gammagl_tpu_torch.examples import hetero_rgcn_trainer as het
    from gammagl_tpu_torch.parallel import (make_relation_expert_spmm,
                                            make_sharded_spmm,
                                            partition_edges_uniform,
                                            shard_expert_weights)
    phase_start("phase 41 (a): the sharded and expert SpMMs at one part, "
                "the hetero_rgcn twin's --ep path")
    dev = torch.device("cuda")
    out, runs = {}, {}
    plan = graph.csr_plan()
    w = gcn_weights(ei, graph.num_nodes)
    t0 = time.perf_counter()
    part = partition_edges_uniform(graph.edge_index, graph.num_nodes, 1,
                                   w.cpu().numpy())
    t_part = time.perf_counter() - t0
    spmm = make_sharded_spmm(graph.num_nodes)
    ws = torch.from_numpy(part.edge_weight).to(dev)
    xg = x.detach().clone().requires_grad_()
    sync()
    reset_counts(k)
    t0 = time.perf_counter()
    got = spmm(part.edge_index, ws, xg)
    sync()
    t_first = time.perf_counter() - t0
    got.backward(torch.ones_like(got))
    sync()
    counts = read_counts(k)
    want_counts = every_kernel(add_launches(csr_launches(plan),
                                            csr_launches(plan.transpose())))
    if counts != want_counts:
        fail(f"sharded SpMM at one part: expected launches {want_counts}, "
             f"counted {counts}")
    runs["shard-1"] = counts
    ref = k.spmm_csr(x, w, plan)
    if not torch.equal(got.detach(), ref):
        fail("sharded SpMM at one part: not bitwise equal to spmm_csr on "
             "the graph's plan")
    # row 1 at this shape (its plain version and cuSPARSE beside it), then
    # the sharded call, which adds the weights' gather into CSR order
    wp = k.pad_edge_weights(plan, w)
    rowptr, col, _ = plan.arrays(dev)
    N, E, F = plan.num_nodes, plan.num_edges, x.shape[1]
    A = torch.sparse_csr_tensor(rowptr, col.long(), wp, size=(N, N))
    row = timing(f"spmm_csr F={F} f32, arxiv shape",
                 lambda: k.spmm_csr(x, wp, plan, weights_padded=True),
                 lambda: k.spmm_csr_reference(x, wp, plan,
                                              weights_padded=True),
                 # x, col, rowptr and w in, out
                 nbytes=N * F * 4 + E * 4 + (N + 1) * 8 + E * 4 + N * F * 4,
                 flops=2 * E * F, library=lambda: A @ x)
    del A
    ms_shard = cuda_ms(lambda: spmm(part.edge_index, ws, x))
    print(f"  ({smi}) sharded SpMM at one part, F={F} f32: bitwise "
          f"spmm_csr on the graph's plan; {ms_shard:.4f} ms a call against "
          f"{row['ms']:.4f} ms for spmm_csr alone; the partition "
          f"{t_part:.2f} s, the first call with its plan {t_first:.2f} s "
          f"(host); launches {nonzero(counts)}")
    out["sharded_one_part"] = {"ms": ms_shard, "spmm_csr": row,
                               "partition_s": t_part,
                               "first_call_s": t_first}

    tg, _ = flat_typed_graph(k, simplehgn_trainer, hg, dev)
    xt, eit, ett, R = tg["x"], tg["ei"], tg["fkw"]["edge_type"], tg["R"]
    rng = np.random.default_rng(SEED + 41)
    widths = [(HGT_FEAT, RGCN_HIDDEN), (RGCN_HIDDEN, HGT_CLASSES)]
    Ws = [torch.from_numpy((rng.normal(size=(R, a, b)) / np.sqrt(a))
                           .astype(np.float32)).to(dev) for a, b in widths]
    run = make_relation_expert_spmm(tg["n"])
    # the plan the expert SpMM builds (one process: every relation)
    et_np, ei_np = ett.cpu().numpy(), eit.cpu().numpy()
    eplan = k.build_csr_plan(et_np * tg["n"] + ei_np[0], ei_np[1], tg["n"],
                             num_src=R * tg["n"])
    want_layer = every_kernel(add_launches(csr_launches(eplan),
                                           csr_launches(eplan.transpose())))
    del et_np, ei_np, eplan
    t0 = time.perf_counter()
    with torch.no_grad():
        run(eit, ett, xt, shard_expert_weights(Ws[0]))
    sync()
    t_plan = time.perf_counter() - t0
    err, lay_counts, lay_ms = 0.0, [], []
    h = xt
    for i, W in enumerate(Ws):
        e, c = expert_check(k, f"expert SpMM layer {i + 1} "
                            f"({W.shape[1]} -> {W.shape[2]}) f32", run, h,
                            eit, ett, W, shard_expert_weights(W))
        err = max(err, e)
        lay_counts.append(c)
        wl = shard_expert_weights(W)
        hk = h.detach()
        k_ms, p_ms, _ = paired_ms(lambda: run(eit, ett, hk, wl),
                                  lambda: expert_plain(hk, eit, ett, W),
                                  plain_iters=2)
        lay_ms.append({"ms": k_ms, "plain_ms": p_ms})
        print(f"  ({smi}) expert layer {i + 1}: {k_ms:.4f} ms a forward "
              f"(dense transforms + spmm_csr), per-edge plain {p_ms:.4f} "
              f"ms; launches fwd + bwd {nonzero(c)}")
        with torch.no_grad():
            h = torch.relu(run(eit, ett, hk, wl))
    for i, c in enumerate(lay_counts):
        if c != want_layer:
            fail(f"expert layer {i + 1}: expected launches {want_layer}, "
                 f"counted {c}")
    runs["expert-1"] = {name: sum(c[name] for c in lay_counts)
                        for name in lay_counts[0]}
    out["expert_one_part"] = {"first_call_s": t_plan, "max_abs_err": err,
                              "layers": lay_ms, "relations": R,
                              "edges": int(eit.shape[1])}
    del tg, xt, eit, ett, h, Ws
    torch.cuda.empty_cache()

    sync()
    reset_counts(k)
    t0 = time.perf_counter()
    res = het.main_ep(ep_args(1))
    sync()
    t_twin = time.perf_counter() - t0
    counts = read_counts(k)
    # 4 a step (2 layers, forward and backward) and 2 an accuracy forward
    # (after the first step and at the end)
    want = every_kernel({"spmm_csr": 4 * EP_STEPS + 4})
    if counts != want:
        fail(f"hetero_rgcn --ep 1: expected launches {want}, counted "
             f"{counts}")
    losses = res["losses"]
    if not np.isfinite(losses).all() or losses[-1] > losses[0] * (
            1 - MIN_FALL):
        fail(f"hetero_rgcn --ep 1: losses {losses} do not fall")
    runs["ep-t"] = counts
    print(f"  ({smi}) hetero_rgcn --ep 1, {EP_STEPS} steps: losses "
          f"{losses}, {t_twin:.2f} s; launches {nonzero(counts)}")
    out["hetero_rgcn_ep1"] = {"losses": losses, "seconds": t_twin}
    return runs, out


def nonzero(counts):
    return {name: n for name, n in counts.items() if n}


def parallel_worker(tmp, rank):
    """One process of phase 41 (b), ``chip_smoke.py --parallel-worker DIR
    RANK``: joins the gloo group of P41_PROCS processes (a file store in
    DIR), reads the arxiv shape from DIR, runs each parallel path with its
    launches counted and checked, and writes result<RANK>.json (and its
    seeds, rows and losses as npy files for the parent)."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gammagl_tpu_torch.data import Graph
    from gammagl_tpu_torch.examples import common
    from gammagl_tpu_torch.examples import hetero_rgcn_trainer as het
    from gammagl_tpu_torch.loader import (MultiHostNodeLoader,
                                          ShardedFeatureStore)
    from gammagl_tpu_torch.models import GCNModel
    from gammagl_tpu_torch.ops import cuda as k
    from gammagl_tpu_torch import parallel as par
    from gammagl_tpu_torch.sampler import NeighborSampler
    from gammagl_tpu_torch.serve import (InferenceSession,
                                         ShardedInferenceSession)
    from gammagl_tpu_torch.train import (load_checkpoint_sharded,
                                         save_checkpoint_sharded)
    from gammagl_tpu_torch.utils import load_jax_params
    torch.backends.cuda.matmul.allow_tf32 = False
    P = P41_PROCS
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=600))
    dev = torch.device("cuda")
    ei_np = np.load(os.path.join(tmp, "ei.npy"))
    x_np = np.load(os.path.join(tmp, "x.npy"))
    w_np = np.load(os.path.join(tmp, "w.npy"))
    n = x_np.shape[0]
    x, w = torch.from_numpy(x_np).to(dev), torch.from_numpy(w_np).to(dev)
    ei = torch.from_numpy(ei_np).to(dev)
    res = {"rank": rank, "launches": {}, "ms": {}, "err": {}}

    def counted(label, fn, want):
        dist.barrier()
        sync()
        reset_counts(k)
        t0 = time.perf_counter()
        value = fn()
        sync()
        res["ms"][label] = (time.perf_counter() - t0) * 1e3
        counts = read_counts(k)
        if counts != every_kernel(want):
            fail(f"{label}, rank {rank}: expected launches {want}, counted "
                 f"{counts}")
        res["launches"][label] = counts
        return value

    t0 = time.perf_counter()
    plan = k.build_csr_plan(ei_np[0], ei_np[1], n)
    one = k.spmm_csr(x, w, plan)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    g = torch.randn(one.shape, generator=gen, device=dev)
    xr = x.detach().clone().requires_grad_()
    k.spmm_csr(xr, w, plan).backward(g)
    one_dx = xr.grad
    res["host_s"] = {"plan": time.perf_counter() - t0}

    # the sharded SpMM, by destination (bitwise one plan) and uniform
    for kind, build in (("dst", par.partition_edges_by_dst),
                        ("uniform", par.partition_edges_uniform)):
        t0 = time.perf_counter()
        part = build(ei_np, n, P, w_np)
        spmm = par.make_sharded_spmm(n)
        own = part.edge_index[rank]
        keep = own[1] < n
        splan = k.build_csr_plan(own[0][keep], own[1][keep], n)
        res["host_s"][f"partition_{kind}"] = time.perf_counter() - t0
        ws = torch.from_numpy(part.edge_weight).to(dev)
        xs = x.detach().clone().requires_grad_()

        def fwd_bwd():
            o = spmm(part.edge_index, ws, xs)
            o.backward(g)
            return o

        got = counted(f"sharded_{kind}", fwd_bwd, add_launches(
            csr_launches(splan), csr_launches(splan.transpose())))
        if kind == "dst":
            if not torch.equal(got.detach(), one):
                fail(f"rank {rank}: the sharded SpMM by destination is not "
                     "bitwise one plan's spmm_csr")
            res["err"]["sharded_dst"] = 0.0
        else:
            res["err"]["sharded_uniform"] = check_close(
                f"rank {rank}: sharded SpMM uniform vs one plan",
                got.detach(), one, 0.0, atol=1e-5)
        res["err"][f"sharded_{kind}_dx"] = check_close(
            f"rank {rank}: sharded SpMM {kind} dx vs one plan", xs.grad,
            one_dx, 0.0, atol=1e-5)
        times = []
        for _ in range(3):
            dist.barrier()
            sync()
            t1 = time.perf_counter()
            spmm(part.edge_index, ws, x)
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
        res["ms"][f"sharded_{kind}_calls"] = times
        del part, ws, xs, got

    # the feature-sharded SpMM: this process's block of the columns
    c = x.shape[1] // P
    run = par.make_feature_sharded_spmm(n)
    xb = x[:, rank * c:(rank + 1) * c].contiguous()
    got = counted("feature", lambda: run(ei, w, xb), csr_launches(plan))
    res["err"]["feature"] = check_close(
        f"rank {rank}: feature-sharded SpMM vs one plan's columns", got,
        one[:, rank * c:(rank + 1) * c], 0.0, atol=1e-5)
    del got, one, one_dx, g

    # the expert SpMM: P41_RELATIONS random relations, the last block padded
    rng = np.random.default_rng(SEED + 42)
    et = torch.from_numpy(rng.integers(0, P41_RELATIONS, ei_np.shape[1])
                          ).to(dev)
    W = torch.from_numpy((rng.normal(size=(P41_RELATIONS, N_FEAT,
                                           P41_EXPERT_OUT))
                          / np.sqrt(N_FEAT)).astype(np.float32)).to(dev)
    run = par.make_relation_expert_spmm(n)
    wl = par.shard_expert_weights(W)
    per = wl.shape[0]
    local = et.cpu().numpy() - rank * per
    mine = (local >= 0) & (local < per)
    eplan = k.build_csr_plan(
        local[mine] * n + ei_np[0][mine], ei_np[1][mine], n,
        num_src=per * n)
    want = add_launches(csr_launches(eplan), csr_launches(eplan.transpose()))
    dist.barrier()
    e, counts = expert_check(k, f"rank {rank}: expert SpMM "
                             f"({P41_RELATIONS} relations, {per} a process)",
                             run, x, ei, et, W, wl)
    if counts != every_kernel(want):
        fail(f"expert SpMM, rank {rank}: expected launches {want}, counted "
             f"{counts}")
    res["launches"]["expert"] = counts
    res["err"]["expert"] = e
    del et, W, wl, eplan

    # the pipeline at P stages: tanh(h @ p_s)
    M, B, Fp = P41_PIPE
    rng = np.random.default_rng(SEED + 43)
    params = (rng.normal(size=(P, Fp, Fp)) * 0.05).astype(np.float32)
    xm = torch.from_numpy(rng.normal(size=(M, B, Fp)).astype(np.float32)
                          ).to(dev)
    coef = torch.from_numpy(rng.normal(size=(M, B, Fp)).astype(np.float32)
                            ).to(dev)
    p = par.shard_pipeline_params(params).requires_grad_()
    pipe = par.make_pipeline_apply(lambda p_, h: torch.tanh(h @ p_), M)
    got = counted("pipeline", lambda: pipe(p, xm), {})
    (got * coef).sum().backward()
    full = torch.from_numpy(params).to(dev).requires_grad_()
    h = xm
    for s in range(P):
        h = torch.tanh(h @ full[s])
    (h * coef).sum().backward()
    res["err"]["pipeline"] = max(
        check_close(f"rank {rank}: pipeline out vs sequential", got.detach(),
                    h.detach(), 0.0, atol=1e-5),
        check_close(f"rank {rank}: pipeline dp vs sequential", p.grad,
                    full.grad[rank], 0.0, atol=1e-5,
                    scale=float(full.grad.abs().max())))
    del xm, coef, p, full, h, got

    # ShardedInferenceSession on phase 5's GCN, the graph padded by one
    # isolated node to a multiple of P rows
    pad = (-n) % P
    xp = torch.cat([x, x.new_zeros(pad, x.shape[1])])
    gplan = k.build_csr_plan(ei_np[0], ei_np[1], n + pad)

    def gcn():
        model = GCNModel(hidden_dim=HIDDEN, num_class=N_CLASS,
                         num_layers=N_LAYERS, drop_rate=GCN_DROP,
                         dtype=torch.bfloat16)
        return load_jax_params(model, random_params())

    b = (n + pad) // P
    sess = ShardedInferenceSession(gcn(), (xp, ei), in_specs=("dp", None),
                                   out_specs="dp",
                                   compute_dtype=torch.bfloat16, plan=gplan)
    plain = InferenceSession(gcn(), (xp, ei), compute_dtype=torch.bfloat16,
                             plan=gplan)
    for r_ in range(2):
        xr_ = xp + r_ * 1e-3
        got = counted(f"session_{r_}", lambda: sess(
            xr_[rank * b:(rank + 1) * b], ei),
            {"spmm_csr": N_LAYERS})
        if got.shape != (b, N_CLASS) or not torch.equal(
                got, plain(xr_, ei)[rank * b:(rank + 1) * b]):
            fail(f"rank {rank}: ShardedInferenceSession request {r_} is not "
                 "bitwise InferenceSession's rows")
    del sess, plain, xp, gplan

    # ShardedFeatureStore: P41_GATHER ids, some past either end (clipped)
    st = ShardedFeatureStore()
    st.put_tensor(x_np, group_name="node", attr_name="x")
    idx = np.random.default_rng(SEED + 44).integers(-5, n + 10, P41_GATHER)
    got = counted("store", lambda: st.get_tensor("node", "x", idx), {})
    padded = np.concatenate([x_np, np.zeros((pad, x_np.shape[1]),
                                            np.float32)])
    want = torch.from_numpy(np.take(padded, idx, axis=0, mode="clip"))
    if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
        fail(f"rank {rank}: ShardedFeatureStore rows are not the stored "
             "rows bit for bit")
    del st, got

    # a MultiHostNodeLoader epoch on the arxiv shape
    every, bs, fan = P41_LOADER
    graph = Graph(x=x_np, edge_index=ei_np)
    t0 = time.perf_counter()
    sampler = NeighborSampler(ei_np, n, list(fan), seed=SEED)
    res["host_s"]["sampler"] = time.perf_counter() - t0
    loader = MultiHostNodeLoader(graph, sampler,
                                 input_nodes=np.arange(0, n, every),
                                 batch_size=bs)
    seeds, batch_ms = [], []
    t0 = time.perf_counter()
    for batch in loader:
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        if batch["x"].device.type != dev.type or int(
                batch["seed_mask"].sum()) != bs:
            fail(f"rank {rank}: a loader batch is not on the card or not "
                 f"{bs} seeds")
        seeds.append(batch["n_id"][0, :bs].cpu().numpy())
        t0 = time.perf_counter()
    if len(seeds) != len(loader) or not seeds:
        fail(f"rank {rank}: {len(seeds)} loader batches, len {len(loader)}")
    np.save(os.path.join(tmp, f"seeds{rank}.npy"), np.concatenate(seeds))
    res["ms"]["loader_batches"] = batch_ms

    # the hetero_rgcn twin's --ep P: a checkpoint after EP_CKPT steps, then
    # a fresh trainer resumed from it repeats the rest bitwise
    args = ep_args(P)
    data = het.typed_graph()
    tr = het.ExpertRGCN(args, data)

    def steps(t, n_):
        return [t.step() for _ in range(n_)]

    first = counted("ep_steps", lambda: steps(tr, EP_CKPT),
                    {"spmm_csr": 4 * EP_CKPT})
    ckpt = os.path.join(tmp, "ep_ckpt")
    t0 = time.perf_counter()
    save_checkpoint_sharded(ckpt, common.checkpoint_tree(tr.params, tr.opt),
                            step=EP_CKPT)
    res["ms"]["ckpt_save"] = (time.perf_counter() - t0) * 1e3
    rest = steps(tr, EP_STEPS - EP_CKPT)
    tr2 = het.ExpertRGCN(args, data)
    t0 = time.perf_counter()
    tree, step = load_checkpoint_sharded(
        ckpt, common.checkpoint_tree(tr2.params, tr2.opt))
    res["ms"]["ckpt_load"] = (time.perf_counter() - t0) * 1e3
    common.restore_checkpoint_tree(tr2.params, tr2.opt, tree)
    again = counted("ep_resume", lambda: steps(tr2, EP_STEPS - EP_CKPT),
                    {"spmm_csr": 4 * (EP_STEPS - EP_CKPT)})
    if step != EP_CKPT or again != rest or not all(
            torch.equal(tr.params[name], tr2.params[name])
            for name in tr.params):
        fail(f"rank {rank}: the resumed --ep run does not repeat steps "
             f"{EP_CKPT + 1}-{EP_STEPS} bitwise ({rest} vs {again})")
    res["ep_losses"] = first + rest
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"result{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_slice24_procs(k, graph, x, ei, ep1_losses, smi):
    """Phase 41 (b): `parallel_worker` in P41_PROCS processes on the one
    card; the ranks' results gathered and held: the --ep losses equal on
    every rank and within 1e-4 relative of (a)'s one process, the loader's
    seeds disjoint across ranks. Returns (launches by path, figures)."""
    import shutil
    import tempfile
    phase_start(f"phase 41 (b): the parallel paths in {P41_PROCS} "
                "processes on the one card")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_par_")
    try:
        np.save(os.path.join(tmp, "ei.npy"), graph.edge_index)
        np.save(os.path.join(tmp, "x.npy"), graph.x)
        np.save(os.path.join(tmp, "w.npy"),
                gcn_weights(ei, graph.num_nodes).cpu().numpy())
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker",
             tmp, str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(P41_PROCS)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=600)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        t_workers = time.perf_counter() - t0
        for r, (proc, log) in enumerate(zip(procs, logs)):
            if proc.returncode != 0:
                fail(f"parallel worker {r} exited {proc.returncode}:\n"
                     f"{log[-4000:]}")
        print("\n".join("  " + line for line in logs[0].splitlines()
                        if line.strip()))
        results = []
        for r in range(P41_PROCS):
            with open(os.path.join(tmp, f"result{r}.json")) as f:
                results.append(json.load(f))
        seeds = [np.load(os.path.join(tmp, f"seeds{r}.npy"))
                 for r in range(P41_PROCS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    allseeds = np.concatenate(seeds)
    if np.unique(allseeds).size != allseeds.size:
        fail("the ranks' loader seeds overlap")
    losses = results[0]["ep_losses"]
    if any(res["ep_losses"] != losses for res in results) or not np.allclose(
            losses, ep1_losses, rtol=1e-4, atol=0):
        fail(f"hetero_rgcn --ep {P41_PROCS}: losses "
             f"{[res['ep_losses'] for res in results]} vs one process "
             f"{ep1_losses}")
    runs = {}
    for label in results[0]["launches"]:
        runs[f"p41-{label}"] = {name: sum(res["launches"][label][name]
                                          for res in results)
                                for name in COUNTED}
    # the slowest rank's time; over repeated calls, the median of those
    ms = {}
    for label in results[0]["ms"]:
        slowest = np.max([res["ms"][label] for res in results], axis=0)
        ms[label] = float(np.median(slowest))
    errs = {label: max(res["err"][label] for res in results)
            for label in results[0]["err"]}
    out = {"procs": P41_PROCS, "workers_s": t_workers, "ms": ms,
           "max_abs_err": errs, "ep_losses": losses,
           "host_s": results[0]["host_s"],
           "loader_batches": len(seeds[0]) // P41_LOADER[1],
           "seconds": time.perf_counter() - t_phase}
    print(f"  ({smi}) {P41_PROCS} processes in {t_workers:.1f} s; the "
          f"slowest rank's ms: {ms}; max errors {errs}; --ep "
          f"{P41_PROCS} losses {losses} (one process {ep1_losses}); "
          f"{out['loader_batches']} loader batches a rank")
    return runs, out


def phase_slice24(k, simplehgn_trainer, hg, graph, x, ei, smi):
    """Phase 41: (a) `phase_slice24_one`, (b) `phase_slice24_procs`."""
    t_phase = time.perf_counter()
    runs, one = phase_slice24_one(k, simplehgn_trainer, hg, graph, x, ei,
                                  smi)
    runs_b, procs = phase_slice24_procs(
        k, graph, x, ei, one["hetero_rgcn_ep1"]["losses"], smi)
    runs.update(runs_b)
    out = {"one_process": one, "processes": procs,
           "seconds": time.perf_counter() - t_phase}
    print(f"  ({smi}) phase 41 in {out['seconds']:.1f} s")
    return runs, out


# -- phase 42: every kernel of rows 5-15 as a torch.library op

# the fresh process of phase 42 (a): it imports only `serve`, then for each
# artifact of a directory times `torch.export.load`, `.module()` and
# `load_exported`, moves the model's inputs to the card, times the first
# call, and runs the requests, each input's float leaves + r * 1e-3, as
# the parent ran them (argv: the directory, the request count, the names)
OPS_CHILD = r"""
import hashlib, json, sys, time
t0 = time.perf_counter()
import torch
torch_s = time.perf_counter() - t0
t0 = time.perf_counter()
from gammagl_tpu_torch.serve import load_exported
import_s = time.perf_counter() - t0
k = sys.modules["gammagl_tpu_torch.ops.cuda"]
d, n_req, names = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
counted = json.load(open(d + "/counted.json"))
files = json.load(open(d + "/inputs.json"))


def tree(fn, a):
    if isinstance(a, dict):
        return {key: tree(fn, v) for key, v in a.items()}
    if isinstance(a, (tuple, list)):
        return type(a)(tree(fn, v) for v in a)
    return fn(a)


def counts():
    return {group: sum(getattr(k, fn).launches for fn in fns)
            for group, fns in counted.items()}


out = {"torch_import_s": torch_s, "serve_import_s": import_s, "models": {}}
for name in names:
    path = d + "/" + name + ".pt2"
    before = set(sys.modules)
    t0 = time.perf_counter()
    ep = torch.export.load(path)
    t1 = time.perf_counter()
    if "first_load_imports" not in out:  # what the first load imported
        groups = {}
        for m in set(sys.modules) - before:
            parts = m.split(".")
            key = ".".join(parts[:2] if parts[0] == "torch" else parts[:1])
            groups[key] = groups.get(key, 0) + 1
        out["first_load_imports"] = dict(sorted(
            groups.items(), key=lambda kv: -kv[1])[:10])
    ep.module()
    t2 = time.perf_counter()
    prog = load_exported(path)
    t3 = time.perf_counter()
    inputs = tree(lambda a: a.cuda(), torch.load(d + "/" + files[name]))
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    with torch.no_grad():
        prog(*inputs)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        digests, launches = [], []
        for r in range(n_req):
            xr = tree(lambda a: a + r * 1e-3 if a.is_floating_point()
                      else a, inputs)
            torch.cuda.synchronize()
            before = counts()
            res = prog(*xr)
            torch.cuda.synchronize()
            after = counts()
            launches.append({n: after[n] - before[n] for n in counted
                             if after[n] != before[n]})
            digests.append(hashlib.sha256(res.contiguous().view(
                torch.uint8).cpu().numpy().tobytes()).hexdigest())
    out["models"][name] = {
        "export_load_s": t1 - t0, "module_s": t2 - t1,
        "load_exported_s": t3 - t2, "inputs_to_card_s": t4 - t3,
        "first_call_s": t5 - t4, "digests": digests, "launches": launches}
out["imported"] = [m for m in sys.modules if m == "gammagl_tpu" or
                   m.startswith(("gammagl_tpu.", "gammagl_tpu_torch.models",
                                 "gammagl_tpu_torch.layers", "jax"))]
print(json.dumps(out))
"""


def _tree(fn, a):
    if isinstance(a, dict):
        return {key: _tree(fn, v) for key, v in a.items()}
    if isinstance(a, (tuple, list)):
        return type(a)(_tree(fn, v) for v in a)
    return fn(a)


def _request(inputs, r):
    """Request r of an export path: each float leaf + r * 1e-3 (the fresh
    process makes the same requests from the same inputs)."""
    return _tree(lambda a: a + r * 1e-3 if a.is_floating_point() else a,
                 inputs)


def export_paths(k, models, common, simplehgn_trainer, HeteroGraph,
                 load_jax_params, plan, x, ei, hg, hgt_plans, x_dict,
                 ei_dict, bp_plan, bx, bei, clustered, hy_plan):
    """The models of phase 42 (a) at their earlier phases' widths, on the
    same graphs: {name: (model, inputs, forward keywords, the session's
    compute dtype, the process default compute dtype, launches a
    request)}."""
    from gammagl_tpu_torch.models import FusedGATModel
    dev = x.device
    H = SHGN_HEADS
    han_hg = han_graph(HeteroGraph)
    han_x, han_ei, _, _, _ = common.hetero_tensors(han_hg, "paper", dev)
    tg, typed_plan = flat_typed_graph(k, simplehgn_trainer, hg, dev)
    torch.manual_seed(SEED + 31)
    shgn = models.SimpleHGNModel(tg["R"], SHGN_HIDDEN, HGT_CLASSES,
                                 heads=SHGN_HEADS, drop_rate=SHGN_DROP,
                                 in_channels=HGT_FEAT)
    sage = models.GraphSAGEModel(
        hidden_dim=HIDDEN, num_class=N_CLASS, num_layers=N_LAYERS,
        aggr="max", drop_rate=SAGE_DROP, dtype=torch.bfloat16,
        in_channels=N_FEAT)
    cx = torch.from_numpy(clustered.x).to(dev)
    cei = torch.from_numpy(clustered.edge_index).to(dev)
    bf = torch.bfloat16
    return {
        "gat": (gat_model(models.GATModel, load_jax_params), (x, ei),
                {"plan": plan}, bf, None, {"flash_forward": 2}),
        "fused_gat": (fused_gat_model(load_jax_params), (x, ei),
                      {"plan": FusedGATModel.to_graph_format(
                          ei.cpu().numpy(), N_NODES)}, bf, bf,
                      {"flash_forward": 2}),
        "gatv2": (gatv2_model(models.GATV2Model, load_jax_params), (x, ei),
                  {"plan": plan}, bf, bf,
                  {"expand_dst_csr": 2, "flash_forward": 2}),
        "sage_max": (load_jax_params(sage, sage_params()), (x, ei),
                     {"plan": plan}, bf, None, {"spmm_max_csr": N_LAYERS}),
        "han": (han_model(models.HANModel, han_hg), (han_x, han_ei),
                {"plan_dict": han_hg.csr_plans()}, None, bf,
                {"flash_forward": 2}),
        "hgt": (hgt_model(models.HGTModel, hg), (x_dict, ei_dict),
                {"plan_dict": hgt_plans}, None, None, {"hgt_forward": 6}),
        "simplehgn": (shgn, (tg["x"], tg["ei"], tg["fkw"]["edge_type"]),
                      {"plan": typed_plan}, None, None,
                      {"expand_dst_csr": 6, "segment_sum_csr": 2,
                       "spmm_max_csr": 2, "spmm_csr": 2 * H}),
        "gcn_block_pair": (gcn_model(models.GCNModel, load_jax_params),
                           (bx, bei), {"plan": bp_plan}, bf, None,
                           {"spmm_block_pair": N_LAYERS}),
        "gcn_hybrid": (gcn_model(models.GCNModel, load_jax_params),
                       (cx, cei), {"plan": hy_plan}, bf, None,
                       {"spmm_block_pair": N_LAYERS, "spmm_csr": N_LAYERS}),
    }


def exports_from_a_file(k, paths, smi):
    """(a) Each path served live (`InferenceSession`, N_REQUESTS requests,
    the launches a request exact), exported on the card, saved; then one
    fresh process that imports only `serve` loads every artifact and runs
    the same requests: logits bitwise the live session's, the launches a
    request the live path's. The fresh process's load time split into
    the imports, `torch.export.load`, `.module()`, `load_exported`, the
    inputs' copy to the card and the first call."""
    import tempfile
    from gammagl_tpu_torch.serve import (InferenceSession, export_forward,
                                         save_exported)
    from gammagl_tpu_torch.utils import compute_dtype
    live, out, files, saved = {}, {"models": {}}, {}, {}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "counted.json"), "w") as f:
            json.dump({group: [fn.__name__ for fn in fns]
                       for group, fns in counters(k).items()}, f)
        for name, (model, inputs, kw, cdt, default, per_request) in \
                paths.items():
            with compute_dtype(default):
                sess = InferenceSession(model, inputs, device="cuda",
                                        compute_dtype=cdt, **kw)
                sync()
                reset_counts(k)
                digests = []
                for r in range(N_REQUESTS):
                    digests.append(_digest(sess(*_request(inputs, r))))
                sync()
                counts = read_counts(k)
                if counts != every_kernel(per_request, N_REQUESTS):
                    fail(f"{name} live session launches {counts}")
                t0 = time.perf_counter()
                ep = export_forward(model, inputs, device="cuda",
                                    compute_dtype=cdt, **kw)
                export_s = time.perf_counter() - t0
            ops = sorted({str(n.target) for n in ep.graph.nodes
                          if str(n.target).startswith("gammagl.")})
            path = os.path.join(tmp, f"{name}.pt2")
            save_exported(ep, path)
            # the inputs as the session is given them, each set saved once
            # (the program casts them as the session does)
            if id(inputs[0]) not in saved:
                saved[id(inputs[0])] = f"{name}.in.pt"
                torch.save(_tree(lambda a: a.cpu(), inputs),
                           os.path.join(tmp, saved[id(inputs[0])]))
            files[name] = saved[id(inputs[0])]
            live[name] = (digests, counts)
            out["models"][name] = {"export_s": export_s, "ops": ops,
                                   "artifact_bytes": os.path.getsize(path)}
            del ep, sess
        with open(os.path.join(tmp, "inputs.json"), "w") as f:
            json.dump(files, f)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", OPS_CHILD, tmp, str(N_REQUESTS),
             *paths], capture_output=True, text=True, timeout=600,
            cwd=root, env=dict(os.environ, PYTHONPATH=root))
        out["child_s"] = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"phase 42's fresh process failed:\n{res.stderr[-3000:]}")
    child = json.loads(res.stdout.strip().splitlines()[-1])
    if child["imported"]:
        fail(f"loading the artifacts imported {child['imported']}")
    loaded = every_kernel({})
    for name, (digests, counts) in live.items():
        got = child["models"][name]
        per = {kn: n // N_REQUESTS for kn, n in counts.items() if n}
        if got["digests"] != digests:
            fail(f"{name}: the loaded program's logits differ from the live "
                 "session's")
        if any(c != per for c in got["launches"]):
            fail(f"{name}: the loaded program launched {got['launches']}, "
                 f"the live path {per} a request")
        for kn, n in per.items():
            loaded[kn] += n * N_REQUESTS
        row = out["models"][name]
        row.update({key: got[key] for key in (
            "export_load_s", "module_s", "load_exported_s",
            "inputs_to_card_s", "first_call_s")})
        print(f"  {name}: {row['ops']}, {row['artifact_bytes']} bytes; "
              f"export {row['export_s']:.2f} s; fresh process: "
              f"torch.export.load {row['export_load_s']:.3f} s, .module() "
              f"{row['module_s']:.3f} s, load_exported "
              f"{row['load_exported_s']:.3f} s, inputs to the card "
              f"{row['inputs_to_card_s']:.3f} s, first call "
              f"{row['first_call_s']:.3f} s; {N_REQUESTS} requests bitwise "
              f"the live session's, {per} each")
    out.update(torch_import_s=child["torch_import_s"],
               serve_import_s=child["serve_import_s"],
               first_load_imports=child["first_load_imports"])
    print(f"  ({smi}) fresh process {out['child_s']:.1f} s in all: import "
          f"torch {child['torch_import_s']:.2f} s, serve "
          f"{child['serve_import_s']:.2f} s; the first torch.export.load "
          f"imported {child['first_load_imports']} (modules by package)")
    live_counts = every_kernel({})
    for _, counts in live.values():
        for kn, n in counts.items():
            live_counts[kn] += n
    return live_counts, loaded, out


def _card_op_cases(k):
    """(b) One small hub-row case of each op of rows 5-15 on the card:
    {op name: its arguments}, bf16 rows."""
    from gammagl_tpu_torch.ops.cuda.flash_attention import _plan_args
    from gammagl_tpu_torch.ops.cuda.sddmm_csr import _edge_items
    from gammagl_tpu_torch.ops.cuda.segment_matmul import _op_args
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 42)
    n, e, hub = 300, 3000, k.ROW_SPLIT + 77
    dst = np.concatenate([rng.integers(0, n - 20, e), np.zeros(hub, int)])
    plan = k.build_csr_plan(rng.integers(0, n, e + hub), dst, n)
    g = torch.Generator(device=dev).manual_seed(SEED + 42)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)
    E, f32 = plan.num_edges, torch.float32
    w = torch.rand(E, generator=g, device=dev)
    keep = (torch.rand(E, 2, generator=g, device=dev) < 0.7).float()
    x_max = torch.randint(-3, 4, (n, 16), generator=g, device=dev).to(
        torch.bfloat16)
    w_max = torch.randint(1, 3, (E,), generator=g, device=dev).float()
    score, a_dst, msg = rand(n, 2, dtype=f32), rand(n, 2, dtype=f32), rand(
        n, 16)
    out, m, l = k.flash_forward(score, a_dst, msg, keep, plan, 0.2, True)
    kv, q = rand(n, 64), rand(n, 2, 16)
    h_out, h_m, h_l = k.hgt_forward(kv, q, plan)
    rowptr, col, perm = plan.arrays(dev)
    bdst = rng.integers(0, n, 4000)
    bsrc = np.clip(bdst + rng.integers(-40, 41, 4000), 0, n - 1)
    bp = k.build_block_pair_plan(bsrc, bdst, n, R=64, S=64)
    row, bcol, w_perm, block_ptr, pair_src, row_ptr, _ = bp.arrays(dev)
    prev = rand(n, 16)
    return {
        "spmm_csr_acc": (rand(n, 16), w, prev, *_op_args(plan, dev)),
        "spmm_csr_acc_out": (rand(n, 16), w, prev, torch.empty_like(prev),
                             *_op_args(plan, dev)),
        "sddmm_csr": (rand(n, 16), rand(n, 16), *_edge_items(plan, dev), 2,
                      True),
        "expand_dst_csr": (rand(n, 16), torch.rand(E, 2, generator=g,
                                                   device=dev),
                           *_edge_items(plan, dev)),
        "flash_forward": (score, a_dst, msg, keep, *_plan_args(plan, dev),
                          0.2, True),
        "flash_backward": (score, a_dst, msg, keep, m, l, out, rand(n, 16),
                           rowptr, col, perm, 0.2, True),
        "segment_extreme": (x_max, w_max, *_op_args(plan, dev), False,
                            False),
        "segment_max_bwd": (x_max, w_max, k.spmm_max_csr(
            x_max, w_max, plan, weights_padded=True), rand(n, 16),
            *_op_args(plan, dev), False, True),
        "hgt_forward": (kv, q, rowptr, col),
        "hgt_backward": (kv, q, h_out, rand(n, 32), h_m, h_l, rowptr, col),
        "spmm_block_pair": (rand(n, 16), torch.rand(
            bp.num_edges, generator=g, device=dev), w_perm, row, bcol,
            block_ptr, pair_src, row_ptr, bp.num_nodes, bp.num_src, bp.R,
            bp.S),
        "block_pair_dw": (rand(n, 16), rand(n, 16), row, bcol, w_perm,
                          bp.num_edges),
    }


def ops_opcheck(k):
    """(b) ``torch.library.opcheck`` of every op of rows 5-15 on the
    card; returns {op: seconds}."""
    out = {}
    for name, args in _card_op_cases(k).items():
        t0 = time.perf_counter()
        torch.library.opcheck(getattr(torch.ops.gammagl, name).default,
                              args)
        sync()
        out[name] = time.perf_counter() - t0
    print(f"  opcheck on the card: {', '.join(out)} pass "
          f"({sum(out.values()):.1f} s)")
    return out


def _direct_impls():
    """Each op's CUDA implementation, called without the dispatcher: the
    route of the launches before they were ops."""
    import importlib

    # the modules by name: the package exports functions of the same names
    bpm, fa, hf, sd, sm, mx = (importlib.import_module(
        f"gammagl_tpu_torch.ops.cuda.{name}") for name in (
            "block_pair", "flash_attention", "hetero_flash", "sddmm_csr",
            "segment_matmul", "segment_max"))
    return {"spmm_csr": sm._spmm_csr_cuda,
            "spmm_csr_acc": sm._spmm_csr_acc_cuda,
            "spmm_csr_acc_out": sm._spmm_csr_acc_out_cuda,
            "expand_dst_csr": sd._expand_cuda, "sddmm_csr": sd._sddmm_cuda,
            "flash_forward": fa._flash_forward_cuda,
            "flash_backward": fa._flash_backward_cuda,
            "segment_extreme": mx._extreme_cuda,
            "segment_max_bwd": mx._segment_max_bwd_cuda,
            "hgt_forward": hf._hgt_forward_cuda,
            "hgt_backward": hf._hgt_backward_cuda,
            "spmm_block_pair": bpm._spmm_block_pair_cuda,
            "block_pair_dw": bpm._block_pair_dw_cuda}


@contextlib.contextmanager
def direct_launches():
    """Within the block each ``torch.ops.gammagl`` entry is its op's CUDA
    implementation, called without the dispatcher: the route of the
    launches before they were ops."""
    ns = torch.ops.gammagl
    impls = _direct_impls()
    packets = {name: getattr(ns, name) for name in impls}
    for name, impl in impls.items():
        setattr(ns, name, impl)
    try:
        yield
    finally:
        for name, packet in packets.items():
            setattr(ns, name, packet)


def op_routes(label, fn):
    """``fn`` timed through the ops and through `direct_launches`, in
    turns op, direct, direct, op, 20 calls each on CUDA events; returns
    {route: [ms, ms]}."""
    ms = {"op": [], "direct": []}
    for route in ("op", "direct", "direct", "op"):
        with (direct_launches() if route == "direct"
              else contextlib.nullcontext()):
            ms[route].append(cuda_ms(fn, iters=20, warmup=3))
    print(f"  {label}: through the ops {ms['op']} ms, direct "
          f"{ms['direct']} ms (20 calls each, CUDA events)")
    return ms


def dispatch_us(k, calls=2000):
    """The host's cost of one op call: `spmm_max_csr` on a 64-node graph
    (its kernel takes a few microseconds), ``calls`` calls on the host
    clock, synchronized at the end, in turns op, direct, direct, op;
    returns {route: [us a call, us a call]}."""
    rng = np.random.default_rng(SEED + 43)
    tiny = k.build_csr_plan(rng.integers(0, 64, 256), rng.integers(0, 64, 256),
                            64)
    xt = torch.randn(64, 8, device="cuda")
    us = {"op": [], "direct": []}
    with torch.no_grad():
        for route in ("op", "direct", "direct", "op"):
            with (direct_launches() if route == "direct"
                  else contextlib.nullcontext()):
                for _ in range(50):
                    k.spmm_max_csr(xt, None, tiny)
                sync()
                t0 = time.perf_counter()
                for _ in range(calls):
                    k.spmm_max_csr(xt, None, tiny)
                sync()
                us[route].append((time.perf_counter() - t0) / calls * 1e6)
    print(f"  one spmm_max_csr call on the host: through the op {us['op']} "
          f"us, direct {us['direct']} us ({calls} calls each)")
    return us


def eager_routes(k, models, common, load_jax_params, plan, x, ei, hg,
                 hgt_plans, x_dict, ei_dict):
    """(c) The GAT request and step, the GraphSAGE-max step and the HGT
    step through the ops and without them (`op_routes`), and one op
    call's host cost (`dispatch_us`)."""
    from gammagl_tpu_torch.serve import InferenceSession
    from gammagl_tpu_torch.train import TrainState
    y, mask = train_labels(x)
    sess = InferenceSession(gat_model(models.GATModel, load_jax_params),
                            (x, ei), device="cuda",
                            compute_dtype=torch.bfloat16, plan=plan)
    out = {"gat_request": op_routes("GAT request", lambda: sess(x, ei))}
    gat = TrainState(gat_model(models.GATModel, load_jax_params).to(x.device),
                     GAT_LR, 0.0)
    gen = dropout_rng(gat.model, SEED + 420)
    out["gat_step"] = op_routes("GAT step", lambda: common.train_step(
        gat, x, ei, y, mask, plan=plan, **gen))
    sage = models.GraphSAGEModel(
        hidden_dim=HIDDEN, num_class=N_CLASS, num_layers=N_LAYERS,
        aggr="max", drop_rate=SAGE_DROP, dtype=torch.bfloat16,
        in_channels=N_FEAT)
    sage = TrainState(load_jax_params(sage, sage_params()).to(x.device),
                      SAGE_LR, 0.0)
    gen = dropout_rng(sage.model, SEED + 421)
    out["sage_max_step"] = op_routes("GraphSAGE-max step", lambda: (
        common.train_step(sage, x, ei, y, mask, plan=plan, **gen)))
    hgt = TrainState(hgt_model(models.HGTModel, hg).to(x.device), HGT_LR,
                     0.0)
    hy = torch.from_numpy(np.asarray(hg["paper"].y)).to(x.device)
    hmask = torch.from_numpy(np.asarray(hg["paper"].train_mask)).to(x.device)
    gen = dropout_rng(hgt.model, SEED + 422)
    out["hgt_step"] = op_routes("HGT step", lambda: common.train_step(
        hgt, x_dict, ei_dict, hy, hmask, plan_dict=hgt_plans, **gen))
    out["dispatch_us"] = dispatch_us(k)
    return out


def phase_slice25(k, smi, **graphs):
    """Phase 42: (a) `exports_from_a_file`, (b) `ops_opcheck`, (c)
    `eager_routes`."""
    phase_start("phase 42: the models of rows 5-15 exported and run from a "
                "file, opcheck of their ops on the card, eager times "
                "through the ops")
    t_phase = time.perf_counter()
    live, loaded, exports = exports_from_a_file(k, export_paths(
        k, **graphs), smi)
    torch.cuda.empty_cache()
    opcheck_s = ops_opcheck(k)
    routes = eager_routes(k, **{key: graphs[key] for key in (
        "models", "common", "load_jax_params", "plan", "x", "ei", "hg",
        "hgt_plans", "x_dict", "ei_dict")})
    out = {"exports": exports, "opcheck_s": opcheck_s, "routes_ms": routes,
           "seconds": time.perf_counter() - t_phase}
    print(f"  ({smi}) phase 42 in {out['seconds']:.1f} s")
    return live, loaded, out


def main():
    # the run uses one card: show it only the first, whatever the machine
    # holds (before CUDA starts, which reads this once)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        "0" if visible is None else visible.split(",")[0])
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this smoke run needs the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gammagl_tpu_torch import models
    from gammagl_tpu_torch.data import Graph, HeteroGraph
    from gammagl_tpu_torch.examples import agnn_trainer, common
    from gammagl_tpu_torch.examples import fusedgat_trainer as twin
    from gammagl_tpu_torch.examples import gcn_trainer
    from gammagl_tpu_torch.examples import simplehgn_trainer
    from gammagl_tpu_torch.layers.conv import HANConv
    from gammagl_tpu_torch.models import (GATModel, GATV2Model, GCNModel,
                                          GraphSAGEModel, HANModel, HGTModel,
                                          RGCNModel, SimpleHGNModel)
    from gammagl_tpu_torch.ops import cuda as k
    from gammagl_tpu_torch.ops.cuda._build import load_library
    from gammagl_tpu_torch.serve import InferenceSession
    from gammagl_tpu_torch.utils import compute_dtype, load_jax_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    phase_start("phase 1: build")
    t0 = time.perf_counter()
    lib = load_library()
    print(f"  kernel library ready in {time.perf_counter() - t0:.2f} s: "
          f"{os.path.relpath(lib._name)}")
    log = os.path.splitext(lib._name)[0] + ".log"
    for line in open(log).read().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())

    t0 = time.perf_counter()
    graph = arxiv_graph(Graph)
    plan = graph.csr_plan()
    print(f"  graph: {graph.num_nodes} nodes, {graph.num_edges} edges with "
          f"self-loops, CSR plan in {time.perf_counter() - t0:.2f} s")
    if (graph.num_nodes, graph.num_edges) != (N_NODES, N_EDGES + N_NODES):
        fail("slice graph has the wrong size")
    x = torch.from_numpy(graph.x).to(dev)
    ei = torch.from_numpy(graph.edge_index).to(dev)
    spmm_err, spmm_ms = phase_spmm_checks(
        k, plan, k.pad_edge_weights(plan, gcn_weights(ei, N_NODES)))
    flash_err, flash_ms, flash_fold_ms = phase_flash_checks(k, plan)
    edge_err, edge_ms = phase_edge_checks(k, plan)
    gcn_counts, gcn_lat = phase_gcn_serve(k, GCNModel, InferenceSession,
                                          load_jax_params, plan, x, ei)
    gat_counts, gat_lat = phase_gat_serve(k, GATModel, InferenceSession,
                                          load_jax_params, plan, x, ei)
    train_counts, losses, step_ms, grad_err = phase_gat_train(
        k, twin, GATModel, load_jax_params, plan, x, ei)
    with compute_dtype(torch.bfloat16):
        v2_counts, v2_lat, v2_serve_prof = phase_gatv2_serve(
            k, GATV2Model, InferenceSession, load_jax_params, plan, x, ei)
        (v2_train_counts, v2_losses, v2_step_ms, v2_grad_err, v2_bf16_err,
         v2_train_prof) = phase_gatv2_train(k, common, GATV2Model,
                                            load_jax_params, compute_dtype,
                                            plan, x, ei)
    sddmm_counts, sddmm_prof = phase_sddmm_path(k, plan)
    max_err, max_ms, max_fold_ms = phase_max_checks(k, plan)
    (hgt_err, hgt_ms, hgt_plan, (hgt_flash_err, hgt_flash_ms),
     spills) = phase_hgt_checks(k)
    for row in max_ms.values():
        row[0]["spill_bytes"] = spills["segment_max"]
    flash_ms["flash_forward"][0]["spill_bytes"] = spills["flash_fwd_kernel"]
    for name, row in hgt_flash_ms.items():
        flash_ms[name].append(row)
        flash_err[name] = max(flash_err[name], hgt_flash_err[name])
    sage_counts, sage_lat = phase_sage_serve(
        k, GraphSAGEModel, InferenceSession, load_jax_params, plan, x, ei)
    (sage_train_counts, sage_losses, sage_step_ms,
     sage_grad_err) = phase_sage_train(k, common, GraphSAGEModel,
                                       load_jax_params, plan, x, ei)
    t0 = time.perf_counter()
    hg = hgt_graph(HeteroGraph)
    hgt_plans = hg.csr_plans()
    x_dict, ei_dict, _, _, _ = common.hetero_tensors(hg, "paper", dev)
    print(f"  typed graph: {hg.num_nodes} nodes, {hg.num_edges} edges, "
          f"{len(hgt_plans)} relation plans in "
          f"{time.perf_counter() - t0:.2f} s")
    hgt_counts, hgt_lat, hgt_serve_prof = phase_hgt_serve(
        k, common, hgt_model(HGTModel, hg), x_dict, ei_dict, hgt_plans)
    (hgt_train_counts, hgt_losses, hgt_step_ms, hgt_grad_err,
     hgt_train_prof) = phase_hgt_train(k, common, HGTModel, hg, x_dict,
                                       ei_dict, hgt_plans)
    hgt_entry_counts, hgt_entry_err = phase_hgt_entry(k, hgt_plan)

    t0 = time.perf_counter()
    banded = banded_graph(Graph)
    fill_scrambled = banded.block_pair_fill()
    t1 = time.perf_counter()
    banded, _ = banded.reorder_rcm()
    t_rcm = time.perf_counter() - t1
    t1 = time.perf_counter()
    bp_plan = banded.auto_plan()
    t_plan = time.perf_counter() - t1
    print(f"  banded graph: {banded.num_nodes} nodes, {banded.num_edges} "
          f"edges with self-loops; block-pair fill {fill_scrambled:.4f} "
          f"scrambled; reorder_rcm {t_rcm:.2f} s; auto_plan {t_plan:.2f} s: "
          f"{bp_plan!r}; built in {time.perf_counter() - t0:.2f} s")
    if not (isinstance(bp_plan, k.BlockPairPlan)
            and bp_plan.fill_ratio >= 0.8):
        fail(f"auto_plan on the RCM-ordered banded graph gave {bp_plan!r}")
    bx = torch.from_numpy(banded.x).to(dev)
    bei = torch.from_numpy(banded.edge_index).to(dev)
    bw = gcn_weights(bei, N_NODES)
    t0 = time.perf_counter()
    clustered = clustered_graph(Graph)
    hy_plan = clustered.auto_plan()
    print(f"  clustered graph: {clustered.num_edges} edges with self-loops; "
          f"auto_plan {hy_plan!r} in {time.perf_counter() - t0:.2f} s")
    if not isinstance(hy_plan, k.HybridPlan):
        fail(f"auto_plan on the clustered graph gave {hy_plan!r}")
    bp_err, bp_ms = phase_block_pair_checks(k, bp_plan, banded.csr_plan(), bw,
                                            hy_plan)
    bserve_counts, bserve_lat, bserve_prof, bcsr_lat = phase_gcn_plan_serve(
        k, "phase 19: serve GCN on the banded graph (reorder_rcm, "
        "auto_plan: block pair)", "GCN banded", GCNModel, InferenceSession,
        load_jax_params, bp_plan, bx, bei, {"spmm_block_pair": N_LAYERS},
        csr_plan=banded.csr_plan())
    (btrain_counts, btrain_losses, btrain_step_ms, btrain_grad_err,
     btrain_prof) = phase_gcn_banded_train(
        k, common, GCNModel, load_jax_params, bp_plan, bx, bei,
        torch.from_numpy(banded.y).to(dev))
    cserve_counts, cserve_lat, cserve_prof, _ = phase_gcn_plan_serve(
        k, "phase 21: serve GCN on the clustered graph (auto_plan: hybrid)",
        "GCN clustered", GCNModel, InferenceSession, load_jax_params,
        hy_plan, torch.from_numpy(clustered.x).to(dev),
        torch.from_numpy(clustered.edge_index).to(dev),
        {"spmm_block_pair": N_LAYERS, "spmm_csr": N_LAYERS})
    bp_entry_counts, bp_entry_err = phase_block_pair_entry(k, bp_plan, bw)
    acc_err = phase_acc_checks(k)
    shard = papers_shard(k)
    (tier_counts, tier_err, acc_ms, tier_calls,
     fold_ms) = phase_papers_tier(k, shard)
    (papers_counts, papers_losses, papers_step_ms, papers_grad_err,
     papers_prof, papers_edges) = phase_papers_train(k, shard)
    torch.cuda.empty_cache()

    tg, typed_plan = flat_typed_graph(k, simplehgn_trainer, hg, dev)
    typed_err, typed_ms = typed_kernel_timings(k, typed_plan)
    rgcn = phase_rgcn(k, common, RGCNModel, tg, typed_plan)
    han = phase_han(k, common, HANModel, HANConv, HeteroGraph, compute_dtype,
                    dev)
    shgn = phase_simplehgn(k, common, SimpleHGNModel, tg, typed_plan)
    del tg, typed_plan
    torch.cuda.empty_cache()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    data = phase_data_paths(k, common, gcn_trainer, GCNModel, shard,
                            smi.splitlines()[0])
    zoo = phase_zoo(k, common, models, agnn_trainer, plan, x, ei)
    gin = phase_gin_pools(k, dev)
    rest = phase_hetero_rest(k, models, han_graph(HeteroGraph), hg, x, ei,
                             dev)
    wave2 = phase_wave2(k, models, hg, x, ei, dev)
    sampled = phase_sampled(k, smi.splitlines()[0])
    ssl_counts, ssl = phase_ssl(k, smi.splitlines()[0], x, ei)
    w58_counts, w58 = phase_wave5_8(k, smi.splitlines()[0], x, ei)
    w3_counts, w3 = phase_wave3(k, smi.splitlines()[0], x, ei)
    c39_counts, prof_counts, a6e_counts, s21 = phase_slice21(
        k, smi.splitlines()[0], twin, GATModel, GCNModel, load_jax_params,
        plan, x, ei)
    export_counts, fgat_counts, fgat_t_counts, s22_counts, s22 = \
        phase_slice22(k, smi.splitlines()[0], twin, GATModel, GCNModel,
                      InferenceSession, load_jax_params, plan, x, ei)
    hier_t, hier_s, pgat, pgat_t, parted = phase_partitioned(
        k, shard, tier_calls, papers_losses, x, ei, smi.splitlines()[0])
    p41_runs, p41 = phase_slice24(k, simplehgn_trainer, hg, graph, x, ei,
                                  smi.splitlines()[0])
    x42_live, x42_loaded, s25 = phase_slice25(
        k, smi.splitlines()[0], models=models, common=common,
        simplehgn_trainer=simplehgn_trainer, HeteroGraph=HeteroGraph,
        load_jax_params=load_jax_params, plan=plan, x=x, ei=ei, hg=hg, hgt_plans=hgt_plans, x_dict=x_dict, ei_dict=ei_dict,
        bp_plan=bp_plan, bx=bx, bei=bei, clustered=clustered,
        hy_plan=hy_plan)
    if "jax" in sys.modules or "gammagl_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")
    runs = {"gcn_serve": gcn_counts, "gat_serve": gat_counts,
            "gat_train": train_counts, "gatv2_serve": v2_counts,
            "gatv2_train": v2_train_counts, "sddmm": sddmm_counts,
            "sage_serve": sage_counts, "sage_train": sage_train_counts,
            "hgt_serve": hgt_counts, "hgt_train": hgt_train_counts,
            "hgt_entry": hgt_entry_counts, "gcn_banded_serve": bserve_counts,
            "gcn_banded_train": btrain_counts,
            "gcn_clustered_serve": cserve_counts,
            "block_pair_entry": bp_entry_counts,
            "papers_tier": tier_counts, "papers_train": papers_counts,
            "gcn_planetoid_train": data["planetoid"]["counts"],
            "papers_staged_train": data["staged"]["counts"],
            "tu_batch": data["tu"]["counts"],
            "imdb_han_twin": data["imdb"]["counts"]}
    for name, path in (("rgcn", rgcn), ("han", han), ("simplehgn", shgn),
                       *((f"zoo_{m}", p) for m, p in zoo.items())):
        runs[f"{name}_serve"], runs[f"{name}_train"] = (path["serve"],
                                                        path["train"])
    runs["gin_tu"] = gin["counts"]
    runs.update({f"{name}_coo": path["counts"]
                 for name, path in rest.items()})
    runs.update({f"wave2_{name}": path["counts"]
                 for name, path in wave2.items()})
    runs["sampled"] = sampled["counts"]
    runs["ssl"] = ssl_counts
    runs["wave5_8"] = w58_counts
    runs["fgat"], runs["fgat-t"] = fgat_counts, fgat_t_counts
    runs["wave3"] = w3_counts
    runs["gat-c39"], runs["profiling"] = c39_counts, prof_counts
    runs["a6e"] = a6e_counts
    runs["gcn-x"], runs["slice22_coo"] = export_counts, s22_counts
    runs["hier-t"], runs["hier-s"] = hier_t, hier_s
    runs["pgat"], runs["pgat-t"] = pgat, pgat_t
    runs.update(p41_runs)
    runs["ops-x-live"], runs["ops-x-loaded"] = x42_live, x42_loaded
    errs = {"spmm_csr": spmm_err, **flash_err, **edge_err, **max_err,
            **hgt_err, "spmm_csr_acc": acc_err}
    for name, err in typed_err.items():
        errs[name] = max(errs[name], err)
    errs["hgt_backward"] = max(errs["hgt_backward"], hgt_entry_err)
    for name in bp_err:
        errs[name] = max(bp_err[name], bp_entry_err[name])
    # each kernel's headline shape: the widest its main path runs
    shapes = {"spmm_csr": [spmm_ms[HIDDEN], spmm_ms[N_CLASS]], **flash_ms,
              **edge_ms, **max_ms, **hgt_ms, **bp_ms, "spmm_csr_acc": acc_ms}
    for name, typed_rows in typed_ms.items():
        shapes[name] = shapes[name] + typed_rows
    entries = []
    for name, (source, replaces, also) in KERNELS.items():
        head = shapes[name][0]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(c[name] for c in runs.values()),
                 "launches_by_path": {p: c[name] for p, c in runs.items()},
                 "max_abs_err": errs[name], "ms": head["ms"],
                 "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                 "bound_by": head["bound_by"],
                 "library_ms": head["library_ms"], "by_shape": shapes[name]}
        if also:
            entry["also_replaces"] = also
        if name in NOTES:
            entry["note"] = NOTES[name]
        # its passes over cut rows (the CSR fold under all three forms)
        for key, cut in CUT_PASSES.get(name, {}).items():
            entry[key] = {
                "name": cut, "source": source,
                "launches": sum(c[cut] for c in runs.values()),
                "launches_by_path": {p: c[cut] for p, c in runs.items()},
                **{"csr_fold": fold_ms, "segment_max_fold": max_fold_ms,
                   "flash_fwd_fold": flash_fold_ms}.get(cut, {})}
        if entry["launches"] == 0:
            fail(f"{name} was launched on no path")
        entries.append(entry)
    t_end = time.perf_counter()
    print(f"  whole run {t_end - t_start:.1f} s; by phase: " + ", ".join(
        f"{name} {end - begin:.1f} s" for (name, begin), (_, end) in zip(
            _PHASES, _PHASES[1:] + [("end", t_end)])))
    print(smi.splitlines()[0])
    print(json.dumps({
        "kernels": entries,
        "gcn_request_p50_ms": float(np.median(gcn_lat)),
        "gcn_request_max_ms": float(gcn_lat.max()),
        "gat_request_p50_ms": float(np.median(gat_lat)),
        "gat_request_max_ms": float(gat_lat.max()),
        "gat_train_step_ms": float(np.median(step_ms["kernel"][1:])),
        "gat_train_step_plain_ms": float(np.median(step_ms["plain"][1:])),
        "gat_train_losses": losses["kernel"],
        "gat_step0_grad_max_abs_err": grad_err,
        "gatv2_request_p50_ms": float(np.median(v2_lat)),
        "gatv2_request_max_ms": float(v2_lat.max()),
        "gatv2_train_step_ms": float(np.median(v2_step_ms["kernel"][1:])),
        "gatv2_train_step_plain_ms": float(
            np.median(v2_step_ms["plain"][1:])),
        "gatv2_train_losses": v2_losses["kernel"],
        "gatv2_step0_f32_grad_max_abs_err": v2_grad_err,
        "gatv2_step0_bf16_grad_rel_err_vs_f32": v2_bf16_err,
        "gatv2_profile": {"serve": v2_serve_prof, "train": v2_train_prof},
        "sddmm_pair_profile": sddmm_prof,
        "sage_request_p50_ms": float(np.median(sage_lat)),
        "sage_request_max_ms": float(sage_lat.max()),
        "sage_train_step_ms": float(np.median(sage_step_ms["kernel"][1:])),
        "sage_train_step_plain_ms": float(
            np.median(sage_step_ms["plain"][1:])),
        "sage_train_losses": sage_losses["kernel"],
        "sage_step0_f32_grad_max_abs_err": sage_grad_err,
        "hgt_request_p50_ms": float(np.median(hgt_lat)),
        "hgt_request_max_ms": float(hgt_lat.max()),
        "hgt_train_step_ms": float(np.median(hgt_step_ms["kernel"][1:])),
        "hgt_train_step_plain_ms": float(
            np.median(hgt_step_ms["plain"][1:])),
        "hgt_train_losses": hgt_losses["kernel"],
        "hgt_step0_f32_grad_max_abs_err": hgt_grad_err,
        "hgt_profile": {"serve": hgt_serve_prof, "train": hgt_train_prof},
        "banded_fill_scrambled": fill_scrambled,
        "banded_fill": bp_plan.fill_ratio, "banded_reorder_rcm_s": t_rcm,
        "banded_auto_plan_s": t_plan,
        "clustered_dense_frac": hy_plan.dense_frac,
        "gcn_banded_request_p50_ms": float(np.median(bserve_lat)),
        "gcn_banded_request_max_ms": float(bserve_lat.max()),
        "gcn_banded_csr_plan_request_p50_ms": float(np.median(bcsr_lat)),
        "gcn_clustered_request_p50_ms": float(np.median(cserve_lat)),
        "gcn_clustered_request_max_ms": float(cserve_lat.max()),
        "gcn_banded_train_step_ms": float(np.median(
            btrain_step_ms["kernel"][1:])),
        "gcn_banded_train_step_plain_ms": float(np.median(
            btrain_step_ms["plain"][1:])),
        "gcn_banded_train_losses": btrain_losses["kernel"],
        "gcn_banded_step0_f32_grad_max_abs_err": btrain_grad_err,
        "gcn_profile": {"banded_serve": bserve_prof,
                        "clustered_serve": cserve_prof,
                        "banded_train": btrain_prof},
        "papers_partition_s": shard["t_part"],
        "papers_tier": {**tier_calls,
                        "vs_one_plan_max_abs_err": tier_err},
        "papers_src_blocks": shard["nsb"],
        "papers_train_step_ms": float(np.median(
            papers_step_ms["kernel"][1:])),
        "papers_train_step_plain_ms": float(np.median(
            papers_step_ms["plain"][1:])),
        "papers_train_losses": papers_losses["kernel"],
        "papers_edges_per_s": papers_edges / float(np.median(
            papers_step_ms["kernel"][1:])) * 1e3,
        "papers_step0_f32_grad_max_abs_err": papers_grad_err,
        "papers_profile": papers_prof,
        **{f"{name}_{key}": value for name, path in (
            ("rgcn", rgcn), ("han", han), ("simplehgn", shgn))
           for key, value in (
               ("request_p50_ms", float(np.median(path["lat"]))),
               ("request_max_ms", float(path["lat"].max())),
               ("train_step_ms", float(np.median(
                   path["step_ms"]["kernel"][1:]))),
               ("train_step_plain_ms", float(np.median(
                   path["step_ms"]["plain"][1:]))),
               ("train_losses", path["losses"]["kernel"]),
               ("step0_f32_grad_max_abs_err", path["grad_err"]),
               ("profile", path["profile"]))},
        "han_cross_type_max_abs_err": han["cross_type_err"],
        "zoo": {name: {
            "request_p50_ms": float(np.median(path["lat"])),
            "request_max_ms": float(path["lat"].max()),
            "train_step_ms": float(np.median(path["step_ms"]["kernel"][1:])),
            "train_step_plain_ms": float(np.median(
                path["step_ms"]["plain"][1:])),
            "train_losses": path["losses"]["kernel"],
            "step0_f32_grad_max_abs_err": path["grad_err"],
            "profile": path["profile"]} for name, path in zoo.items()},
        "gin_tu": {"max_abs_err": gin["max_abs_err"],
                   "seconds": gin["seconds"]},
        "hetero_wave2": {name: {
            "request_p50_ms": float(np.median(path["lat"])),
            "step_ms": path["step_ms"], "losses": path["losses"],
            "vs_float64_max_abs_err": path["max_abs_err"]}
            for name, path in rest.items()},
        "wave2": {name: {
            "request_p50_ms": float(np.median(path["lat"])),
            "request_max_ms": float(path["lat"].max()),
            "step_ms": path["step_ms"], "losses": path["losses"],
            "vs_float64_max_abs_err": path["max_abs_err"]}
            for name, path in wave2.items()},
        "data_paths": {name: {key: value for key, value in path.items()
                              if key != "counts"}
                       for name, path in data.items()},
        "sampled": {key: value for key, value in sampled.items()
                    if key != "counts"},
        "ssl": ssl, "wave5_8": w58, "wave3": w3, "slice21": s21,
        "slice22": s22, "partitioned": parted, "slice24": p41,
        "slice25": s25, "whole_run_s": t_end - t_start}))
    # the run used one card, the only one it was shown
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--hier-worker"]:
        hier_worker(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(sys.argv[2], int(sys.argv[3]))
    else:
        main()
