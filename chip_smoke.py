#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ATLAS on one GPU and check it.

    python3 chip_smoke.py [--vertices 200000]

Phases, in order; any failure exits non-zero:

1. build   — compile every kernel in src/repro_torch/csrc with nvcc for
             sm_90a (one nvcc per source, in parallel); print nvcc's
             version, the build time, the card and its power limit, ptxas's
             registers and spills of the backward's tensor-core and
             resident kernels, of K6, of K3's head-dim-256 kernels and of
             K5's resident kernels at 3584, 4096 and 7168 (forward and
             backward in f32 and bf16, twelve instances; none may spill),
             and the TF32 switches (both off).
2. K1      — chunk aggregation at the e2e path's widths and source counts,
             with uniform destinations: n=8192 source rows at d=256
             (layers 1-2), n=16384 at d=128 (layer 0), both f32 with ~12
             edges per source, and d=256 in bf16; each takes the "rows"
             route (its counter must grow) and must equal the general
             kernel bitwise, itself bitwise, and its plain PyTorch version
             within 1e-4/1e-5; the first also the host oracle
             chunk_aggregate_numpy and, bitwise, an exact chunk.  Median
             times of the rows kernel, the general kernel, the plain
             version and torch.sparse.mm (f32); at the first, fill_ of the
             output (the write floor), the d2h of partial into pinned and
             into pageable memory (host clock and CUDA events, each with
             its allocation), and the whole aggregation stage per chunk
             (host clock) with the pinned d2h and with the pageable one.
3. K2      — the graduation transform at the e2e path's shapes:
             [n,256]@[256,256] relu, [n,512]@[512,256] relu and
             [n,512]@[512,172] none (GraphSAGE's), [n,128]@[128,256] relu
             and [n,256]@[256,172] none (GCN's and GIN's; GIN's MLP falls
             on the same shapes), each at n = graduation_rows (8192)
             and at the e2e graph's tail chunk (vertices %
             graduation_rows: 3392 at the default), f32 and bf16, vs the
             plain version and bitwise vs itself; each case prints its
             route (f32 and m % 8 != 0 on the CUDA cores, bf16 on the
             tensor cores); median times of kernel, plain and
             torch.addmm; the bound at the peak of the input type.
4. e2e     — GraphStore.create + AtlasSession.infer of GraphSAGE
             [128,256,256,172] (seed 3) on powerlaw_graph(V, 12) with a
             64 MiB hot store on the card; per-layer LayerMetrics as JSON
             lines and the traced time per span category; both kernels'
             launch counts must grow during infer, every K1 launch must
             take the rows route and every K2 launch the CUDA-core route;
             K1's shapes per layer (n, d, m, segments and the longest
             segment: min / median / max, recorded from the host arrays the
             aggregator is given and returns), the aggregation stage per
             chunk, the pipeline stall, the pinned d2h of partial and the
             pinned bytes held; after the run, both K1 routes checked and
             timed as in phase 2 on the run's first chunk of each width
             (its power-law hubs included): the width with the most
             launches gives K1's kernels entry.  Evictions must occur, and
             the mean-max-abs error against the in-memory dense reference
             (computed on the card with the plain versions) must stay
             below 1e-5.  Then GCN and GIN (eps 0.1) at the same widths
             (seed 3) through the same store and config, one run each: its
             LayerMetrics, wall, traced seconds and K1's shapes; every K1
             launch on the rows route and every K2 launch on the CUDA
             cores, tallied by (n, k, m, activation), each shape one [K2]
             checked; GIN's K2 launches twice its transform calls;
             evictions; GCN's mean-max-abs error below 1e-5, GIN (whose
             weight-1 sums over the hubs grow layer by layer) allclose
             with rtol 1e-5 and atol 1e-5 x max(1, max|ref|).
5. publish — after infer's timed window, on e2e's own store (order "at")
             and final layer (V x 172 f32: one servable file of blocks of
             4096 rows): AtlasSession.publish, then three readers — the
             page-cache path with a 32 MiB cache (blocks miss and evict),
             fast_path=True (file mmaps) and fast_path="auto" at 256 MiB
             (must choose the mmap path) — each looks up 100,000 seeded
             external ids with duplicates twice (cold, warm), bitwise equal
             to spills_to_dense's rows at new_of_old[ids]; a re-publish
             under the open readers leaves their version serving the same
             bits, and gc after they close collects it; a ServingFrontend
             over a fresh reader serves 8 threads x 200 requests of 64 ids,
             each future bitwise equal to the direct lookup.  Prints the
             publish wall, bytes, files, blocks and rate, each reader's
             ids/s and blocks_read, the front end's waves and ids/s (all
             host clock: this is host code), and a {"publish_phase"} line.
6. dist    — sharded inference (repro_torch.dist) on e2e's store, specs
             and AtlasConfig: DistSession with 2 thread shards and the
             file-backed exchange, the 64 MiB hot store split between
             them; K1 runs inline in every shard worker and K2 in every
             shard's graduation (both counters must grow, every K1 launch
             on the rows route), evictions must occur, both shards must
             send and receive records, the error against e2e's dense
             reference must stay below 1e-5, and the published final
             layer must serve 100,000 seeded ids bitwise equal to the run's
             own spills.  Then, on exact_graph_and_specs(20000, 16) for
             gcn and sage, and for gin on pow_degree_graph(20000, (4, 16))
             with integer features of 8 and integer MLP weights at dims
             [8, 8, 4] (its one-machine run bitwise the dense reference on
             the card): 1, 2 and 4 thread shards on the local exchange
             and 2 on the mesh exchange over ["cuda:0"] * 2, each bitwise
             equal to the single-machine run on the card; and the
             process-worker launcher (python -m repro_torch.launch.infer_dist
             --workers process) must report bit_identical and
             served_identical.  Prints the infer wall beside e2e's, the
             max |dist - e2e|, each shard's exchange records and bytes, the
             traced barrier seconds, the pinned bytes held, the process
             run's wall and each worker's startup, and a {"dist_phase"}
             line.
7. mesh    — the GNN device mesh (repro_torch.dist.mesh): GCN at e2e's
             widths on powerlaw_graph(V, 12, seed=1, self_loops=True) on a
             (4, 2) mesh over ["cuda:0"] * 8 in f32, three layers of the
             combined step and of the baseline step, and SAGE mean with
             has_self on the combined step; prints the plan's bucket, slots
             and reuse, both steps' message slabs before allocating, each
             layer's host-clock wall after a warm-up (synchronized), the
             second layer's device busy time and K1's and K2's shares of
             it (torch.profiler), its
             wire bytes (each equal to dist.mesh.wire_bytes' formula) and
             the baseline / combined ratio, and each run's peak memory;
             each run's mean-max-abs error against the dense reference
             (plain versions, on the card) must stay below 1e-5, every K1
             launch must take the rows route and every K2 launch the CUDA
             cores; then exact_graph_and_specs(20000, 16) graphs (gcn,
             sage) at meshes (1, 1), (2, 1), (4, 2) and (2, 2, 2), both
             steps (the baseline at 1 and 3 chunks), each bitwise the dense
             reference.  Prints a {"mesh_phase"} line; no time is compared.
8. gather  — the gather baselines (repro_torch.core.gather_ref) on the
             card: layerwise_gather on e2e's graph and features at full
             width (batch 4096) and vertexwise_gather on
             powerlaw_graph(5000, 12) at the same widths (its k-hop
             expansion grows every batch's computation graph toward the
             whole graph, which makes 200,000 vertices impractical), each
             within 1e-5 of the dense reference, with K1 and K2 launching;
             prints each wall (host clock), its GatherStats beside e2e's
             bytes read by layer (the read amplification of the paper's
             Fig. 1), and a {"gather_phase"} line.  Then e2e's trace must
             pass obs_report.validate_trace with no violation, and
             obs_report.reconcile against e2e's LayerMetrics must find no
             mismatch.
9. K5      — the timing floor (an empty kernel between the events), then
             RMSNorm at every row shape lm-serve gives it, taken from its
             traffic (bf16): qwen3-14b's prefill rows B·S x 5120 and
             qk-norm rows B·S·40 and B·S·8 x 128 of each wave, its decode
             rows B x 5120, B·40 and B·8 x 128, mamba2-2.7b's B·S x 2560
             and x 5120 and its decode rows, the MoE models' rows and
             recurrentgemma-9b's B·S x 4096 and B x 4096, deepseek-7b's
             x 4096, pixtral-12b's x 5120, musicgen-medium's x 1536 and
             starcoder2-3b's x 3072 (the last two on the general route);
             then
             [1024,5120], [40960,128], [2048,2560] and recurrentgemma's
             [train] rows [4096,4096] in bf16 and f32, [train-mesh]'s
             qwen2-7b rows x 3584 (B·1024 for B 4, 2, 1; bf16) and
             [serve-mesh]'s (B·504 and B for B 4 and 2; bf16) and its
             [4096,3584] and arctic's prefill rows x 7168 in f32; vs the
             plain version and bitwise vs itself; each shape prints its
             route (every width here, 128, 2048, 2560, 3584, 4096, 5120
             and 7168, on the resident route, 1536 and 3072 on the general
             one) and asserts its counter; median times of kernel, plain
             version and F.rms_norm, and on the resident route the general
             kernel's on the same inputs.
10. K3     — flash attention at each lm-serve wave's prefill shape (each
             model's heads, head dim and window, B and the padded S from
             the traffic; bf16, and f32 at the first), then S=256 and a
             ragged S=200 at B=4 (f32 and bf16) and B=1, S=4096 bf16 at
             Hq=40, Hkv=8, D=128, then recurrentgemma's [train] forward
             (B=1, S=4096, 16/1 heads of 256, window 2048, bf16) and a
             ragged S=200 with window 64 at its heads (f32 and bf16),
             then [train-mesh]'s qwen2-7b calls at S=1024 (B=4 and 1 at
             28/4 heads, B=1 and 2 at 14/2: one model position's) and
             [serve-mesh]'s at S=504 (B=4 at 28/4, B=4 and 2 at 14/2); vs
             the plain version (f32 2e-5, bf16 5e-2) and bitwise vs
             itself; each case prints its route (bf16 at D 64/128/256,
             with or without a window, on the tensor cores, which every
             bf16 case of recurrentgemma's must take; f32 on the CUDA
             cores); a window of S or more must give the no-window
             result bitwise; median times of kernel, plain and
             scaled_dot_product_attention (with the band as attn_mask
             where there is a window), the bound from the band's (query,
             key) pairs, and at recurrentgemma's tensor-core cases the
             CUDA-core kernel's on the same inputs (cuda_core=, checked
             against the plain version too).
11. K4     — the SSD scan at lm-serve's mamba2-2.7b wave (BH=4·80, S=512,
             P=64, N=128, chunk 256, b/c shared by the 80 heads) in bf16
             and f32, and at BH=1·80, S=4096 (16 chunks) in bf16, with its
             final state, vs the plain version (y: f32 2e-4, bf16 2e-2;
             the state 2e-4 in both) and bitwise vs itself; each case
             prints its route (bf16 on the tensor cores, f32 on the CUDA
             cores) and asserts its counter; median times (also with the
             final state, the prefill's call) and TFLOP/s, beside the
             CUDA-core kernel on the same bf16 inputs, and on the tensor
             cores each of the three launches' device time
             (torch.profiler).
12. K6     — the RG-LRU scan (rglru_scan, a chunked scan across
             blocks, CHUNK steps a chunk) and its backward at
             recurrentgemma's lm-serve wave (B=4, the wave's S, R=4096)
             and its [train] sequence (B=1, S=4096, R=4096), each without
             and with a carried state h0: h, da, dw and dh0 bitwise the
             chunked plain versions and themselves, both counters grown,
             within 1e-6 (relative to the largest magnitude) of the
             sequential loop, whose max abs and rel errors are printed;
             the sequential kernels K6 replaced bitwise the loop; median
             times of kernel, sequential kernel and plain version,
             forward and backward, beside the bound (12 and 20 B per
             element) and the kernel's GB/s; without h0 also both kernels
             on views one float off 16-byte alignment (4-byte copies,
             bitwise the 16-byte ones) and at chunk 32, 64 and 128, each
             bitwise its plain version (the measurement behind CHUNK).
13. lm-check — qwen3-14b (B=2, S=256), mamba2-2.7b (B=2, S=512),
             deepseek-moe-16b (B=2, S=256, capacity factor 64/6: drop-free),
             recurrentgemma-9b (B=1, S=2304: the window of 2048 cuts
             the first keys of the last 256 rows, and the replay's ring
             wraps), and deepseek-7b, musicgen-medium, pixtral-12b and
             starcoder2-3b (B=2, S=256; the two stubs on [B, S, d_model]
             embeddings) at full width, 4 layers, f32: the prefill's last-token
             logits (K3/K4/K6 + K5) must match a teacher-forced
             decode_step replay within 2e-3.
14. lm-serve — the LM serving path: ServingEngine on qwen3-14b (40 layers,
             bf16; 5 requests, max_batch 4, prompts of 64–128 tokens, 16
             new tokens), mamba2-2.7b (64 layers, bf16; 4 requests,
             prompts of 300–512 tokens padded to 512), deepseek-moe-16b
             (28 layers, 16.4 B parameters, bf16; 4 requests of 64–128
             tokens, 8 new), arctic-480b (cut to 1 of 35 layers, 14.07 B
             parameters; 2 requests of 64–128 tokens, 8 new) and
             recurrentgemma-9b (38 layers, 9.63 B parameters, bf16; 4
             requests of 64–128 tokens from a generator of its own, 8
             new), then deepseek-7b, musicgen-medium, pixtral-12b and
             starcoder2-3b at published width and depth (bf16; one wave
             of 4 requests of 64–128 tokens, lengths from a generator of
             their own, 8 new; the two stubs take [S, d_model] f32
             embeddings, standard normal, and decode on lm_head's row of
             each new token).  Weights are random from a seeded torch.Generator on
             the card.  K3 and K5 must launch on qwen3 and both MoE
             models, K3 on its tensor-core route once per layer per wave,
             K4 and K5 on mamba, K4 on its tensor-core route once per
             layer per wave, on recurrentgemma the windowed K3 on the
             tensor-core route once per attention layer (12) and K6 once
             per RG-LRU layer (26) per wave, each K6 call at a shape [K6]
             checked;
             every K5 launch takes the route rms_norm.route names for its
             width (resident everywhere, arctic's 7168 included, but
             musicgen's 1536 and starcoder2's 3072, which take the general
             kernel), and K5's launches are tallied by row shape; every
             attention model's K3 launches all on the tensor cores; every
             request finishes with 1 to
             its max tokens
             and every logit is finite.  Prints each
             wave's bf16 max |prefill - replay| on the last prompt token,
             and for mamba the same with the plain SSD scan in place of K4;
             each model's first wave is prefilled once more under
             torch.profiler: wall, device busy and the K3/K4/K5 shares.

15. K5-bwd — K5's backward (rms_norm_bwd) at [train]'s rows: B·S x 5120
             (ln1, ln2, the final norm) and B·S·40, B·S·8 x 128 (q- and
             k-norm), mamba's B·S x 2560 and x 5120, deepseek-moe's
             B·S x 2048 and recurrentgemma's B·S x 4096 in bf16, and
             x 5120 and B·S·8 x 128 in f32, [train-mesh]'s rows x 3584
             (bf16, and its [4096,3584] in f32) and arctic's width at
             [4096,7168] in bf16 and f32; dx vs
             the plain backward (f32 1e-5, bf16 2e-2), dscale (a sum over
             the rows) within the same bar of its largest magnitude,
             bitwise vs itself; each case prints its route (all these
             widths take the resident route) and asserts its counter;
             median times of kernel, plain version and the backward of
             F.rms_norm, and on the resident route the general kernel's on
             the same inputs (general=, checked against the plain version
             too).
16. K3-bwd — K3's backward (flash_attention_bwd) at [train]'s shapes (B=2,
             S=2048, D=128, bf16 at qwen3's 40/8 and deepseek-moe's 16/16
             heads, lse from the tensor-core forward; recurrentgemma's
             B=1, S=4096, 16/1 heads of 256, window 2048, in bf16 on the
             tensor cores and f32 on the CUDA cores), and at S=256 f32 and
             S=200 (ragged) in f32 and bf16, and [train-mesh]'s calls as in
             K3;
             the forward writing lse must equal the forward without it
             bitwise, lse the plain log-sum-exp within 1e-5; dq, dk, dv vs
             the plain backward (f32 1e-5, bf16 2e-2) and bitwise vs
             themselves; a window of S or more bitwise no window (forward
             and backward, at recurrentgemma's heads); each case prints
             its route (bf16 on the tensor cores, f32 on the CUDA cores)
             and asserts its counter; each pass's
             device time; median times of kernel, plain version and the
             backward of scaled_dot_product_attention (banded where there
             is a window), and on the tensor-core route the CUDA-core
             kernel's on the same inputs (cuda_core=, checked too).
17. K4-bwd — K4's backward (ssd_scan_bwd) at [train]'s mamba2-2.7b shape
             (BH=2·80, S=2048, P=64, N=128, chunk 256, b/c shared by the 80
             heads) in bf16 and f32, with decays near 1 and near 0.05 in
             bf16, and one chunk (S=256) with a b/c row per sequence in
             f32; dx, da, db, dc vs the plain backward within f32 2e-4 and
             bf16 2e-2 of each one's largest magnitude, bitwise vs itself;
             each case prints its route (bf16 on the tensor cores, f32 on
             the CUDA cores) and asserts its counter; median times of
             kernel and plain backward, each launch's device time, the
             bound from the backward's operations and bytes, and at the
             first (bf16) case the CUDA-core kernel's time on the same
             inputs (cuda_core=, checked against the plain backward too).
18. train-check — the smoke configs of qwen3-14b, mamba2-2.7b,
             deepseek-moe-16b and recurrentgemma-9b in f32: 3 steps of
             make_train_step on the card
             and the same 3 on the CPU from one init_train_state (losses
             within 1e-5 relative, parameters within 1e-5); then a
             checkpoint after step 2, restored on the card, must give step
             3 bitwise equal to the uninterrupted step 3 (parameters,
             moments, step); one more step under
             torch.use_deterministic_algorithms(True, warn_only=True) must
             flag no op.
19. train  — four models at their published widths, bf16 parameters,
             f32 AdamW moments, remat: 5 steps each on the batch
             make_global_batch(seed=0, step=0), lr 1e-3, warmup 1:
             qwen3-14b cut to 4 of its 40 layers, mamba2-2.7b at its 64
             layers, deepseek-moe-16b cut to 4 of 28 (its dense first
             layer and 3 MoE layers), each at B=2, S=2048, and
             recurrentgemma-9b cut to 5 of 38 (one superblock and the
             2-layer RG-LRU tail) at B=1, S=4096.  Every loss and grad norm
             finite, the last loss below the first, K5's backward counter
             grown on every step; K3's on every step of the attention
             models, each call on the tensor-core route; K4's backward once
             per layer on every mamba step, each call on the tensor-core
             route, with every K4 forward on the tensor-core route; every
             K3 forward on the tensor-core route; on recurrentgemma the
             windowed K3's backward once per step on the tensor-core route
             and K6's once per RG-LRU layer per step; every K5
             backward call of every model on the resident route; every
             backward call at a shape its phase checked.  Prints each
             run's step walls, tokens/s, peak device
             memory, launches per step and one step's device-busy share
             with K3's, K4's, K5's and K6's forward and backward shares
             (torch.profiler).
20. train-mesh — the training substrate (repro_torch.distributed) on
             qwen2-7b at its published width (d_model 3584, 28/4 heads of
             128, d_ff 18944, vocab 152064, QKV bias) cut to 2 of 28
             layers, bf16 parameters, f32 moments, remat, one batch of
             B=4, S=1024: the sharded train step (distributed.spmd) on the
             (4, 2) mesh over cuda:0 repeated, FSDP over data, heads and
             MLP columns over model, held to the one-device
             make_train_step: (a) step 1 from the same state, the loss and
             every gradient leaf within ||dg||/||g|| <= 2e-2; (b) AdamW on
             the one-device gradients sliced to the placements with the
             one-device clip scale, every block of params, m and v bitwise
             adamw_update's; (c) free-running losses of steps 1-3 within
             2e-2; (d) a checkpoint after step 2 restored onto (2, 2)
             through shardings= (every block bitwise the (4, 2) state's
             region), its step 3 within 1e-4 of (4, 2)'s; (e) every K3
             call of the sharded steps, forward and backward, at 14/2
             heads (none at 28) on the tensor cores, every K5 call,
             forward and backward, on the resident route, every K3 and K5
             call at a shape its phase checked; (f) the GPipe pipeline
             (distributed.pipeline), its 2 blocks over 2 stages, 4
             microbatches of B=1, forward and gradients within 2e-2 of
             sequential_forward; (g) launch/{compression,pipeline,
             elastic}_check on cuda as processes of their own, each to
             OK.  Prints the walls, the sharded steps' split (gather /
             forward_backward / reduce / optimizer), the state held over
             the positions and the peaks by run.
21. serve-mesh — the sharded serving step (distributed.spmd:
             ShardedServeStep) on [train-mesh]'s qwen2-7b cut (2 of 28
             layers at published width, bf16) on the (1, 2) and (2, 2)
             meshes over cuda:0 repeated, against the one-device
             make_serve_prefill / make_serve_step: a global batch of 4
             prompts of 504 tokens, the logits and every cache block (keys
             and values split by sequence over model) within
             ||d||/||ref|| <= 2e-2, every K3 launch on the tensor cores
             at 14/2 heads (layers x data shards x tp of them), every K5
             launch resident; then 16 decode steps from 504 in a cache of
             1024 slots, teacher-forced by the one-device step's greedy
             tokens (504-511 leave model position 1's block empty,
             512-519 write into it), each step's logits within 2e-2 and
             its greedy tokens equal wherever the one-device top-two gap
             exceeds twice the step's max |d|; every K3 and K5 call at a
             shape its phase checked.  Prints the walls beside the one
             device's, the copy bytes between positions by kind (one more
             prefill and decode step counted live), and its own wall.
21a. train-mesh-rec — the ssm and hybrid families' sharded train step,
             split over model (Mamba-2 by heads, RG-LRU by channels, the
             hybrid's local attention by sequence, its MLPs by columns), at
             their published widths: mamba2-2.7b cut to 4 of 64 layers at
             B=4, S=1024, recurrentgemma-9b to 5 of 38 at B=1, S=4096 (bf16
             moments), on the (1, 2) and (2, 2) meshes over cuda:0 repeated,
             held to the one-device make_train_step: (a) step 1's loss and
             every gradient leaf within 2e-2; (b) on (2, 2), the sharded
             AdamW on the one-device gradients bitwise adamw_update's
             arithmetic, leaf by leaf; (c) losses of steps 1-3 within 2e-2;
             (d) every K3, K4 and K5 call, forward and backward, on the
             tensor cores or resident, K4 at 40 heads a B/C row, K6 at 2048
             channels, K3 at 16/1 heads on recurrentgemma's sequence blocks
             (2048 and 4095 query rows: the window of 2048 starts position
             1's keys at 1), every call at a shape its phase checked.
             Prints walls, the steps' split and peaks.
21b. serve-mesh-rec — the same two cuts served by the sharded serving
             step on (1, 2) and (2, 2): mamba2-2.7b 4 prompts of 512 in a
             cache of 1024, recurrentgemma-9b 2 prompts of 2040 in a ring
             of 2048 slots; the prefill's logits and every cache block
             (SSM state by heads, conv windows and RG-LRU h by channels,
             the ring by slots) within 2e-2; 16 decode steps
             teacher-forced by the one-device greedy tokens (the ring wraps
             from position 1's block into position 0's at 2048), each
             step's logits within 2e-2, its greedy tokens equal wherever
             the one-device top-two gap exceeds twice the step's max |d|,
             the cache after them within 2e-2; K4 on the tensor cores at 40
             heads, K6 at 2048 channels and the windowed K3 on the tensor
             cores once per layer, data shard and position in each
             prefill, every K5 resident, every call at a checked shape.
             Prints walls and the copy bytes between positions by kind.
21c. train-mesh-moe — the moe family's sharded train step, its experts
             split over model (E/tp a position, the routing once at a data
             shard's first position), attention by heads, the MLPs by
             columns: deepseek-moe-16b at published width cut to 4 of 28
             layers (1 dense, 3 moe), B=4, S=1024, bf16, f32 moments, on
             (1, 2) and (2, 2) over cuda:0 repeated: (a) one moe block's FFN
             alone on the same rows, split at tp 2 and on one device: the
             routing (fwd, slot_gate) bitwise, the output and the
             gradients of the rows, router, experts and shared experts
             within 2e-2 in bf16 and 1e-5 in f32; (b') the step in f32 on
             (2, 2) against one device in f32: its routing's differing
             (token, expert) assignments counted, every gradient leaf within
             1e-4; (b) the bf16 step 1: the routing of every moe layer
             compared with one device's (each differing assignment counted,
             its experts listed with their gradients' error, held by (a)),
             every other leaf within 2e-2 of one device where no routing
             differs and elsewhere adding at most 2e-2 to one device's
             distance from an f32 step on the same parameter values; losses
             of steps 1-3 within 2e-2; on (2, 2) the sharded AdamW bitwise
             adamw_update's arithmetic, leaf by leaf; (d) every K3 call,
             forward and backward, on the tensor cores at 8/8 heads, every
             K5 resident, every call at a shape its phase checked.  Prints
             walls, the steps' split, the state held and the peaks.
21d. serve-mesh-moe — the split moe family served: deepseek-moe-16b (the
             same cut) on (1, 2) and (2, 2), 4 prompts of 504, 16 decode
             steps from 504 in 1,024 slots; arctic-480b at 1 of 35 layers
             (128 experts top-2, its dense residual, 56/8 heads) on (1, 2),
             2 prompts, its one-device parameters freed once sharded (made
             again from the seed for (c)): (a) one moe block's FFN alone,
             routing bitwise, output within 2e-2; decode teacher-forced by
             the one-device greedy tokens, greedy tokens equal wherever the
             one-device top-two gap exceeds twice the step's max |d|, no
             decode through the one-device step and no cache tensor
             gathered; (c) the rows whose routing differs from one device's
             counted, then the prefill and the decode steps replayed on one
             device with its routing set to the split's (attention, experts,
             combine and cache its own): the prefill's logits and cache
             blocks, each decode step's logits and the cache's written
             slots after the last step within 2e-2 of the replay (its other
             slots bitwise), and the rows routed alike within 2e-2 of the
             plain one-device run; K3 on the tensor cores at 8/8 and 28/4 heads once per
             layer, data shard and position, K5 resident, every call at a
             checked shape.  Prints walls and the copy bytes by kind.
22. dryrun — the planner (repro_torch.launch.dryrun,
             repro_torch.perf.hlo_cost) against the card: (a) one more
             step of each [train] model, counted live on the card by the
             op counter (after its 5 steps), and qwen2-7b's one-device and
             (4, 2) steps (2 of 28 layers, B=4, S=1024, a step after one
             to warm), and [serve-mesh]'s (2, 2) prefill and decode step:
             FLOPs, bytes and copy bytes equal to the count of the same
             step on meta, exactly (the (4, 2) and (2, 2) ones counted on
             meta one shard per row count, and for training one position
             per signature), and the same for [train-mesh-rec]'s (2, 2)
             step and [serve-mesh-rec]'s (2, 2) prefill and decode step of
             both models, and [train-mesh-moe]'s and [serve-mesh-moe]'s of
             deepseek-moe-16b (its decode's copy bytes planned in twice the
             cache equal to the live ones: no cache block gathered); (b) the
             (4, 2) plan's argument bytes over the positions equal to
             [train-mesh]'s state held over the positions plus the
             batch's blocks; (c) each one-device step's
             max_memory_allocated within 0.90-1.10x of the planned
             peak_bytes; (d) each step's roofline bound_s, its dominant
             term and the measured step wall, as a ratio; (e) the
             production sweep (--mesh single --no-hlo, 10 architectures x
             4 shapes on 16x16, in a process started before [train]):
             no cell fails, and only long_500k of the full-attention
             architectures skips.
23. examples — the examples on the card, each a process of its own:
             examples/torch_distributed_gnn.py (the (4, 2) mesh on the
             card), examples/torch_serve_lm.py on recurrentgemma-9b's smoke config
             (B=2, prompts of 16, 4 new tokens; the K3, K5 and K6 launches
             it prints must be > 0) and examples/torch_train_lm.py (3 steps
             at B=2, S=16, a checkpoint after the third); each must exit 0
             and end with "== OK".

Then a {"kernels": [...]} JSON line (``route`` is the source language,
"cuda"; ``cores`` names the kernel that ran at the entry's shape:
"rows" or "general" for K1, "tensor_core" or "cuda_core" for K2, K3 and
K4, "resident" for K5's "rms_norm" and "general" for "rms_norm_general"
(K5's general kernel, with its lm-serve launches), "cuda_core" for K6;
K1's and K2's launches are [e2e]'s three models' (``launches_by_model``);
K1's entry is
measured on the e2e run's own chunk, named in ``shape``, and also carries
the general kernel's time, ``general_ms``; K1's and K2's entries carry
[mesh]'s launches as ``mesh_launches`` beside e2e's ``launches``; the
backward entries,
"flash_attention_bwd", "ssd_chunk_bwd", "rms_norm_bwd" and
"rglru_scan_bwd", carry [train]'s launches and their phase's first case,
named in ``shape``, with ``cores`` "tensor_core" / "cuda_core" /
"resident" there; "flash_attention_windowed" and
"flash_attention_windowed_bwd" are K3 at recurrentgemma's windowed head
dim 256 on the tensor cores, with recurrentgemma's launches in lm-serve
and [train] and the CUDA-core kernel's time on the same inputs,
``cuda_core_ms``; "flash_attention", "flash_attention_bwd", "rms_norm"
and "rms_norm_bwd" also carry [train-mesh]'s sharded steps' launches,
``train_mesh_launches``, and "flash_attention" and "rms_norm"
[serve-mesh]'s, ``serve_mesh_launches``; the windowed K3's entries, K4's,
K5's and K6's, forward and backward, carry [train-mesh-rec]'s
``train_mesh_rec_launches`` and the forward ones [serve-mesh-rec]'s
``serve_mesh_rec_launches``; K3's and K5's, forward and backward, carry
[train-mesh-moe]'s ``train_mesh_moe_launches`` and the forward ones
[serve-mesh-moe]'s ``serve_mesh_moe_launches``), the card's name and
power limit,
and, last, {"ok": true, "device": {...}}.
Bounds use published H100 SXM peaks: 3.35 TB/s HBM, 67 TFLOP/s f32 on
the CUDA cores and 989 TFLOP/s bf16 on the tensor cores, each for work
of its type; each kernel call's bytes and operations are
``repro_torch.perf.hlo_cost.kernel_cost``'s, the count the dry-run's
planner uses.

Exits non-zero, printing no result, without a CUDA device or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))


K1_RTOL, K1_ATOL = 1e-4, 1e-5  # summation order differs from reduceat
K2_F32_TOL = 1e-5
K2_BF16_TOL = 2e-2
E2E_ERR = 1e-5
E2E_WIDTHS = [128, 256, 256, 172]  # [e2e]'s GraphSAGE, GCN and GIN
GIN_EPS = 0.1  # [e2e]'s GIN: a non-zero eps makes the self coefficient matter
GIN_RTOL = 1e-5  # and atol GIN_RTOL * max(1, max|ref|): weight-1 sums over hubs grow unbounded
K3_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}  # tests/test_kernels.py's bars
K4_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
K5_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LM_CHECK_TOL = 2e-3  # tests/test_archs_smoke.py: decode replay vs prefill
K5_GENERAL_WIDTHS = (1536, 3072)  # musicgen's and starcoder2's d_model: no resident instance


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


HOLD_CYCLES = 2_000_000  # ~1 ms of SM clock: longer than the host takes to enqueue one call


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` between CUDA events.  Each
    rep first holds the stream with a spin kernel, so the host has
    enqueued all of ``fn``'s launches before the first event fires: the
    events time the card, not the Python wrapper's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _host_median_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _bound(name: str, tensors, **attrs) -> tuple[int, int, tuple[float, str]]:
    """(bytes, FLOPs, (bound ms, what bounds it)) of one call of kernel
    ``name`` on ``tensors`` (inputs, then outputs): ``kernel_cost``, the
    count the dry-run's planner uses too."""
    from repro_torch.perf.hlo_cost import bound_ms, kernel_cost

    cost = kernel_cost(name, [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                              for t in tensors], **attrs)
    return cost["bytes"], cost["flops"], bound_ms(cost)


# --------------------------------------------------------------------- phases


def phase_build():
    from repro_torch.kernels import _build

    nvcc = _build.nvcc_path()
    log(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       check=True).stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {built or 'cached'} in {time.perf_counter() - t0:.2f}s "
        f"({', '.join(_build.SIGNATURES)})")
    log(f"[build] card: {smi()}")
    usage = {k: v for name in ("flash_attention", "rms_norm", "ssd_chunk")
             for k, v in _build.resource_usage(name).items()
             if any(tag in k for tag in ("bwd_tc", "rms_bwd_resident", "rms_bwd_partial_sum"))}
    # (K3's D=256 backward on the tensor cores, bwd_tc::dq_tc_kernel<256> and
    # dkdv_tc_wide_kernel, is among them)
    log("[build] ptxas -v, the backward's tensor-core and resident kernels (registers, spill "
        "stores/loads B): "
        + ("; ".join(f"{k} {r} regs {st}/{ld}" for k, (r, st, ld) in sorted(usage.items()))
           or "not kept (libraries built before the report was written)"))
    # K6 (the chunked kernels, forward and backward, at both copy widths:
    # template argument true/false, and the sequential kernels they
    # replaced), and K3's kernels at head dim 256 (template argument 256,
    # mangled "Li256E", or the D=256 dK/dV kernel): the tensor-core forward,
    # dQ and two-warpgroup dK/dV, and the CUDA-core kernels, whose backward
    # stages its tiles through one buffer
    new = {k: v for name in ("rglru_scan", "flash_attention")
           for k, v in _build.resource_usage(name).items()
           if name == "rglru_scan" or "Li256E" in k or "wide" in k}
    log("[build] ptxas -v, K6 and K3's head-dim-256 kernels (registers, spill stores/loads B): "
        + ("; ".join(f"{k} {r} regs {st}/{ld}" for k, (r, st, ld) in sorted(new.items()))
           or "not kept (libraries built before the report was written)"))
    # K5's resident kernels at 3584, 4096 and 7168 (template argument D,
    # mangled "Li<D>E"): the forward and the backward in f32 and bf16, none
    # may spill
    usage = _build.resource_usage("rms_norm")
    if not usage:
        log("[build] WARNING: ptxas's report for rms_norm was not kept (library built before "
            "the report was written): K5's spill check NOT MADE")
    else:
        k5 = {k: v for k, v in usage.items()
              if "Li3584E" in k or "Li4096E" in k or "Li7168E" in k}
        log("[build] ptxas -v, K5's resident kernels at 3584, 4096 and 7168 (registers, spill "
            "stores/loads B): "
            + "; ".join(f"{k} {r} regs {st}/{ld}" for k, (r, st, ld) in sorted(k5.items())))
        assert len(k5) == 12, f"K5's instances at 3584, 4096 and 7168: {sorted(k5)}"
        assert all(st == ld == 0 for _, st, ld in k5.values()), f"K5's resident kernels spill: {k5}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[build] torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")


def _chunk(rng, n, d, edges_per_src, num_vertices, exact):
    m = n * edges_per_src
    src_local = rng.integers(0, n, m).astype(np.int64)
    dst = rng.integers(0, num_vertices, m).astype(np.int64)
    if exact:
        feats = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        w = (2.0 ** -rng.integers(0, 4, m)).astype(np.float32)
    else:
        feats = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
        w = (1.0 / rng.integers(1, 40, m)).astype(np.float32)
    return feats, src_local, dst, w


def _sorted_operands(feats, src_local, dst, w, dev):
    order = np.argsort(dst, kind="stable")
    sdst = dst[order]
    starts = np.nonzero(np.r_[True, sdst[1:] != sdst[:-1]])[0]
    return (
        torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(dev),
        torch.from_numpy(src_local[order].astype(np.int32)).to(dev),
        torch.from_numpy(w[order].astype(np.float32)).to(dev),
        torch.from_numpy(np.r_[starts, len(dst)].astype(np.int32)).to(dev),
    )


# (n, d, dtype, what): K1 at the e2e path's widths and source counts (8 MiB
# of f32 source rows), ~12 edges per source to uniform destinations, and
# in bf16; the first also carries the oracle checks, the d2h and the stage
K1_CASES = (
    (8192, 256, torch.float32, "layers 1-2 chunk"),
    (16384, 128, torch.float32, "layer-0 chunk"),
    (8192, 256, torch.bfloat16, "bf16"),
)


def _k1_general(ops):
    """K1's general kernel on sorted operands (not a launch of the main
    path): the route every call took before the rows kernel existed."""
    from repro_torch.kernels import _build

    feats, src, w, offsets = ops
    out = torch.empty((offsets.numel() - 1, feats.shape[1]), dtype=torch.float32,
                      device=feats.device)
    lib = _build.load("edge_block_spmm")
    rc = lib.atlas_segment_reduce(
        _build.ptr(feats), int(feats.dtype == torch.bfloat16), _build.ptr(src), _build.ptr(w),
        _build.ptr(offsets), _build.ptr(out), out.shape[0], feats.shape[0], src.numel(),
        feats.shape[1], _build.stream_handle(feats.device),
    )
    _build.check(rc, lib, "edge_block_spmm")
    return out


def _k1_measure(ops) -> dict:
    """Both K1 routes on sorted operands: the rows route (the wrapper, which
    must take it) bitwise against the general kernel and itself, and within
    1e-4/1e-5 of the plain version; median times of the rows route, the
    general kernel, the plain version and torch.sparse.mm (f32), and the
    bound for this input."""
    from repro_torch.kernels import edge_block_spmm as ebs
    from repro_torch.kernels.edge_block_spmm import segment_reduce_sorted
    from repro_torch.kernels.ref import segment_reduce_sorted_ref

    feats, src, w, offsets = ops
    n, d = feats.shape
    m, num_seg = src.numel(), offsets.numel() - 1
    route = ebs.route(feats.dtype, d, feats.data_ptr() % 16 == 0)
    assert route == "rows", f"K1 at the e2e width {d} takes {route}"
    before, split0 = ebs.rows_launches.value, ebs.split_counts.value
    got = segment_reduce_sorted(*ops)
    assert ebs.rows_launches.value == before + 1, "K1 did not take its rows route"
    split = tuple(v - v0 for v, v0 in zip(ebs.split_counts.value, split0))
    again = segment_reduce_sorted(*ops)
    general = _k1_general(ops)
    plain = segment_reduce_sorted_ref(*ops)
    torch.cuda.synchronize()
    max_err = float((got - plain).abs().max())
    torch.testing.assert_close(got, plain, rtol=K1_RTOL, atol=K1_ATOL)
    assert torch.equal(got, again), "K1 is not bitwise deterministic"
    assert torch.equal(got, general), "K1's rows route differs from its general route"
    t_rows = median_ms(lambda: segment_reduce_sorted(*ops))
    t_general = median_ms(lambda: _k1_general(ops))
    t_plain = median_ms(lambda: segment_reduce_sorted_ref(*ops))
    t_lib, lib = None, "sparse.mm=n/a (bf16 rows, f32 weights)"
    if feats.dtype == torch.float32:
        csr = torch.sparse_csr_tensor(offsets.long(), src.long(), w, size=(num_seg, n))
        t_lib = median_ms(lambda: torch.sparse.mm(csr, feats))
        lib_err = float((torch.sparse.mm(csr, feats) - plain).abs().max())
        lib = f"sparse.mm={t_lib:.4f}ms (max|sparse-plain|={lib_err:.3g})"
    nbytes, _, (b_ms, b_by) = _bound("edge_block_spmm", (*ops, got))
    return dict(
        out=got, route=route, max_err=max_err, rows_ms=t_rows, general_ms=t_general,
        plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms, bound_by=b_by, split=split,
        shape=f"n={n} d={d} {str(feats.dtype)[6:]} m={m} segments={num_seg}",
        line=(f"route={route}: split {split[0]} segments into {split[1]} slabs of "
              f"{ebs.slab_edges()} edges; max|kernel-plain|={max_err:.3g} bitwise-repeat=ok "
              f"rows==general bitwise kernel={t_rows:.4f}ms general={t_general:.4f}ms "
              f"plain={t_plain:.4f}ms {lib} bound={b_ms:.4f}ms ({b_by}, {nbytes} B) -> "
              f"{nbytes / t_rows / 1e6:.0f} GB/s ({t_rows / b_ms:.1f}x the bound)"),
    )


def _pageable_aggregator():
    """The cuda aggregator with the d2h it had before ``partial`` went
    through pinned memory: a synchronous copy into a fresh pageable array,
    which the driver stages through its own buffer."""
    from repro_torch.core.broadcast import ChunkAggregator

    class PageableD2H(ChunkAggregator):
        def _fetch(self, out):
            partial = np.empty(tuple(out.shape), np.float32)
            with torch.cuda.stream(self._stream):
                torch.from_numpy(partial).copy_(out)
            return partial

    return PageableD2H("cuda")


def phase_k1(num_vertices: int) -> None:
    from repro_torch.core.broadcast import chunk_aggregate, chunk_aggregate_numpy
    from repro_torch.kernels.edge_block_spmm import segment_reduce_sorted
    from repro_torch.kernels.ref import segment_reduce_sorted_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    for i, (n, d, dtype, what) in enumerate(K1_CASES):
        feats, src_local, dst, w = _chunk(rng, n, d, 12, num_vertices, exact=False)
        ops = list(_sorted_operands(feats, src_local, dst, w, dev))
        ops[0] = ops[0].to(dtype)
        k1 = _k1_measure(ops)
        got = k1["out"]
        log(f"[K1] {what} (uniform destinations) {k1['shape']} {k1['line']}")
        if i:
            continue
        ref_u, ref_p, ref_c = chunk_aggregate_numpy(feats, src_local, dst, w)
        u, p, c = chunk_aggregate("cuda")(feats, src_local, dst, w)
        np.testing.assert_array_equal(u, ref_u)
        np.testing.assert_array_equal(c, ref_c)
        np.testing.assert_allclose(p, ref_p, rtol=K1_RTOL, atol=K1_ATOL)
        xf, xs, xd, xw = _chunk(rng, n, d, 12, num_vertices, exact=True)
        xops = _sorted_operands(xf, xs, xd, xw, dev)
        xk = segment_reduce_sorted(*xops).cpu().numpy()
        xp = segment_reduce_sorted_ref(*xops).cpu().numpy()
        _, xn, _ = chunk_aggregate_numpy(xf, xs, xd, xw)
        assert np.array_equal(xk, xp) and np.array_equal(xk, xn), "K1 exact chunk"
        out_bytes = got.numel() * 4
        # what bounds it: fill_ of the output alone, a write-only floor
        t_fill = median_ms(lambda: got.fill_(0.0))
        log(f"[K1] {what}: numpy-oracle=ok exact-chunk=ok; fill_ of the {out_bytes} B output "
            f"{t_fill:.4f}ms ({out_bytes / t_fill / 1e6:.0f} GB/s)")

        # the d2h of partial, pinned (the aggregator's) and pageable (as
        # before), each with its host buffer's allocation, on both clocks
        def pinned_d2h():
            torch.empty(got.shape, dtype=torch.float32, pin_memory=True).copy_(
                got, non_blocking=True)

        def pageable_d2h():
            torch.from_numpy(np.empty(tuple(got.shape), np.float32)).copy_(got)

        d2h = {name: (_host_median_ms(fn), median_ms(fn, reps=7, warmup=1))
               for name, fn in (("pinned", pinned_d2h), ("pageable", pageable_d2h))}
        log("[K1] d2h of partial (" + str(out_bytes) + " B), host clock (copy + synchronize) / "
            "CUDA events: " + ", ".join(
                f"{name} {h:.3f} / {e:.3f}ms ({out_bytes / h / 1e6:.0f} GB/s host clock)"
                for name, (h, e) in d2h.items()))
        # the whole aggregation stage for this chunk on the host clock (host
        # dictionary + pinned h2d + K1 + d2h of partial), with either d2h
        stage = {}
        for name, agg in (("pinned", chunk_aggregate("cuda")), ("pageable", _pageable_aggregator()),
                          ("pinned again", chunk_aggregate("cuda"))):
            stage[name] = _host_median_ms(lambda agg=agg: agg(feats, src_local, dst, w))
        log("[K1] aggregation stage per chunk (host clock), by d2h: " + ", ".join(
            f"{name} {t:.3f}ms" for name, t in stage.items()))


def _k2_cases(num_vertices: int) -> list[tuple[int, int, int, str]]:
    """(n, k, m, activation) of K2's checks: the e2e path's transforms at
    a full graduation buffer and at the graph's last, partial one.
    GraphSAGE's three (its layers see [self, neighbours] rows of 2x the
    input width) come first, then the two more that GCN and GIN add at
    E2E_WIDTHS: GCN's layers see rows of the input width, and GIN's MLP
    (hidden width max(d_in, d_out)) falls on the same shapes."""
    from repro_torch.core.atlas import AtlasConfig

    rows = AtlasConfig.graduation_rows
    shapes = ((512, 256, "relu"), (256, 256, "relu"), (512, 172, "none"),
              (128, 256, "relu"), (256, 172, "none"))
    return [(n, k, m, act) for n in (rows, num_vertices % rows) if n for k, m, act in shapes]


def phase_k2(num_vertices: int) -> dict:
    from repro_torch.kernels import fused_graduate as fg
    from repro_torch.kernels.ref import fused_graduate_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    entry = None
    # the first f32 case is the reported one
    for n, k, m, act in _k2_cases(num_vertices):
        x = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)
        lim = np.sqrt(6.0 / (k + m))
        w = torch.from_numpy(rng.uniform(-lim, lim, (k, m)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.uniform(-0.1, 0.1, m).astype(np.float32)).to(dev)
        for dtype, tol in ((torch.float32, K2_F32_TOL), (torch.bfloat16, K2_BF16_TOL)):
            xa, wa, ba = x.to(dtype), w.to(dtype), b.to(dtype)
            route = fg.route(dtype, k, m)
            counter = fg.route_launches[route]
            before = counter.value
            got = fg.fused_graduate(xa, wa, ba, act)
            assert counter.value == before + 1, f"K2 did not take its {route} route"
            err = _check("K2", got, fused_graduate_ref(xa, wa, ba, act), tol)
            assert torch.equal(got, fg.fused_graduate(xa, wa, ba, act)), \
                "K2 is not bitwise repeatable"
            relu = act == "relu"

            def lib(xa=xa, wa=wa, ba=ba, relu=relu):
                y = torch.addmm(ba, xa, wa)
                return torch.relu(y) if relu else y

            t_kernel = median_ms(lambda: fg.fused_graduate(xa, wa, ba, act))
            t_plain = median_ms(lambda: fused_graduate_ref(xa, wa, ba, act))
            t_lib = median_ms(lib)
            nbytes, _, (b_ms, b_by) = _bound("fused_graduate", (xa, wa, ba, got),
                                             activation=act)
            peak = _peak(dtype)
            log(f"[K2] [{n},{k}]@[{k},{m}] {act} {str(dtype)[6:]} route={route}: "
                f"max|kernel-plain|={err:.3g} bitwise-repeat=ok kernel={t_kernel:.4f}ms "
                f"plain={t_plain:.4f}ms addmm={t_lib:.4f}ms bound={b_ms:.4f}ms ({b_by}; "
                f"peak {peak / 1e12:g} TFLOP/s {str(dtype)[6:]}) -> "
                f"{2 * n * k * m / t_kernel / 1e9:.1f} TFLOP/s")
            if entry is None:
                entry = dict(name="fused_graduate", route="cuda",
                             source="src/repro_torch/csrc/fused_graduate.cu",
                             replaces="src/repro/kernels/fused_graduate.py:23 (_graduate_kernel)",
                             cores=route, max_abs_err=err, ms=t_kernel,
                             kernel_ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms,
                             bound_by=b_by, library_ms=t_lib)
    return entry


def _recording_aggregators(shapes: list, first: dict):
    """``chunk_aggregate`` whose cuda aggregators also record, from the host
    arrays they are given and return, each K1 call's (n, d, m, segments,
    longest segment) into ``shapes`` and the first chunk's inputs at each
    width into ``first`` (references, no copy).  Nothing of this runs on
    the card."""
    from repro_torch.core.broadcast import ChunkAggregator

    class Recording(ChunkAggregator):
        def __call__(self, feats, src_local, dst, weights):
            result = super().__call__(feats, src_local, dst, weights)
            counts = result[2]
            if len(counts) and feats.shape[1]:  # K1 launched
                shapes.append((feats.shape[0], feats.shape[1], len(dst), len(counts),
                               int(counts.max())))
                first.setdefault(feats.shape[1], (feats, src_local, dst, weights))
            return result

    def recording(backend: str = "cuda"):
        return Recording(backend)

    return recording


def _time_k1_chunks(first: dict, shapes: list) -> dict:
    """Both K1 routes on the first chunk of each width the e2e run gave
    K1 (its real segment structure, power-law hubs included), after the
    run, checked against the plain version: not its launches.  Returns
    K1's kernels entry, from the width with the most launches."""
    dev = torch.device("cuda")
    widths = [shape[1] for shape in shapes]
    entry = None
    for d in sorted(first, key=lambda d: -widths.count(d)):
        ops = _sorted_operands(*first[d], dev)
        longest = int(torch.diff(ops[3]).max())
        assert any(shape[2:] == (ops[1].numel(), ops[3].numel() - 1, longest)
                   for shape in shapes), f"the first d={d} chunk changed after infer"
        k1 = _k1_measure(ops)
        log(f"[e2e] K1 on this run's first d={d} chunk ({widths.count(d)} launches at this "
            f"width; {k1['shape']}, the longest segment {longest}) {k1['line']}")
        if entry is None:
            entry = dict(name="edge_block_spmm", route="cuda",
                         source="src/repro_torch/csrc/edge_block_spmm.cu",
                         replaces="src/repro/kernels/edge_block_spmm.py:76 (_spmm_kernel)",
                         cores=k1["route"], max_abs_err=k1["max_err"], ms=k1["rows_ms"],
                         kernel_ms=k1["rows_ms"], general_ms=k1["general_ms"],
                         plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
                         bound_by=k1["bound_by"], library_ms=k1["library_ms"],
                         split_segments=k1["split"][0], split_slabs=k1["split"][1],
                         shape=f"e2e first d={d} chunk: {k1['shape']}, longest segment {longest}")
    return entry


def _log_k1_shapes(metrics, shapes) -> None:
    """K1's shapes per layer (min / median / max of n, d, m, segments and
    the longest segment); each chunk of a layer is one K1 call, in layer
    order."""
    if sum(m.chunks for m in metrics) != len(shapes):
        log(f"[e2e] K1 shapes, all layers ({len(shapes)} calls): {_spread(shapes)}")
        return
    start = 0
    for m in metrics:
        layer = shapes[start:start + m.chunks]
        start += m.chunks
        log(f"[e2e] K1 shapes, layer {m.layer} ({m.chunks} calls): {_spread(layer)}")


def _spread(shapes) -> str:
    cols = np.array(shapes, dtype=np.int64).T
    return ", ".join(
        f"{name} {c.min()} / {int(np.median(c))} / {c.max()}"
        for name, c in zip(("n", "d", "m", "segments", "longest segment"), cols)
    )


def _pinned_held() -> str:
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return "pinned bytes held: not reported by this torch"
    st = stats()
    return (f"pinned bytes held by PyTorch's caching host allocator: "
            f"{st.get('allocated_bytes.current')} now, {st.get('allocated_bytes.peak')} at peak")


def phase_e2e(num_vertices: int, workdir: str) -> tuple[dict[str, dict[str, int]], dict, dict]:
    from unittest import mock

    from repro_torch.core import atlas
    from repro_torch.core.atlas import AtlasConfig, spills_to_dense
    from repro_torch.graphs.synth import make_features, powerlaw_graph
    from repro_torch.kernels import edge_block_spmm, fused_graduate
    from repro_torch.models.gnn import dense_reference, init_gnn_params
    from repro_torch.session import AtlasSession
    from repro_torch.storage.layout import GraphStore

    t0 = time.perf_counter()
    csr = powerlaw_graph(num_vertices, 12, seed=1)
    feats = make_features(num_vertices, 128, seed=2)
    store = GraphStore.create(os.path.join(workdir, "store"), csr, feats, order="at")
    log(f"[e2e] store: V={store.num_vertices} E={store.num_edges} order="
        f"{store.ordering_name} built in {time.perf_counter() - t0:.2f}s")
    specs = init_gnn_params("sage", E2E_WIDTHS, seed=3)
    cfg = AtlasConfig(hot_bytes=64 << 20, backend="cuda", trace=True)

    for counter in (edge_block_spmm.launches, edge_block_spmm.rows_launches,
                    fused_graduate.launches, fused_graduate.cuda_core_launches,
                    edge_block_spmm.split_counts):
        counter.reset()
    k1_shapes: list[tuple] = []  # (n, d, m, segments, longest segment) per K1 call
    k1_first: dict[int, tuple] = {}
    recording = _recording_aggregators(k1_shapes, k1_first)
    t0 = time.perf_counter()
    with mock.patch.object(atlas, "chunk_aggregate", recording), \
            AtlasSession(store, config=cfg, workdir=os.path.join(workdir, "run")) as s:
        result = s.infer(specs)
    wall = time.perf_counter() - t0
    launches = {
        "edge_block_spmm": edge_block_spmm.launches.value,
        "fused_graduate": fused_graduate.launches.value,
    }
    for m in result.metrics:
        log(json.dumps({"layer_metrics": m.as_dict()}))
    f32_route = fused_graduate.cuda_core_launches.value
    rows_route = edge_block_spmm.rows_launches.value
    split = edge_block_spmm.split_counts.value
    log(f"[e2e] infer {wall:.3f}s launches={launches} (K1 rows route {rows_route}, split "
        f"{split[0]} segments into {split[1]} slabs; K2 CUDA-core route {f32_route})")
    assert split[0] > 0, "K1 split no hub segment of the power-law chunks"
    cats = result.telemetry["trace"]["category_seconds"]
    log("[e2e] traced self-seconds by category (all threads): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(cats.items(), key=lambda kv: -kv[1])}))
    assert all(v > 0 for v in launches.values()), f"kernel not on the path: {launches}"
    assert f32_route == launches["fused_graduate"], "K2's f32 transforms left the CUDA-core route"
    assert rows_route == launches["edge_block_spmm"] == len(k1_shapes), \
        f"K1 launches off the rows route: {rows_route} of {launches['edge_block_spmm']}"
    _log_k1_shapes(result.metrics, k1_shapes)
    d2h = sum(m.d2h_device_seconds for m in result.metrics)
    h2d = sum(m.h2d_device_seconds for m in result.metrics)
    assert d2h > 0 and h2d > 0, f"the staging copies were not timed: h2d {h2d}, d2h {d2h}"
    log(f"[e2e] aggregation stage per chunk (aggregate_seconds / chunks, staging thread) "
        f"{[round(m.aggregate_seconds / m.chunks * 1e3, 3) for m in result.metrics]} ms, "
        f"pipeline stall {[round(m.pipeline_stall_seconds, 4) for m in result.metrics]} s; "
        f"pinned d2h of partial {d2h * 1e3 / len(k1_shapes):.3f} ms per chunk (device, "
        f"{d2h:.4f} s in all), h2d of the operands {h2d * 1e3 / len(k1_shapes):.3f} ms "
        f"per chunk (device, {h2d:.4f} s in all); {_pinned_held()}")
    k1 = _time_k1_chunks(k1_first, k1_shapes)
    evictions = sum(m.evictions for m in result.metrics)
    assert evictions > 0, "the hot store never evicted"

    out = spills_to_dense(result.final.spills, store.num_vertices, result.final.dim)
    assert out.shape == (num_vertices, 172) and np.isfinite(out).all()
    perm = store.old_of_new()
    feats_internal = feats if perm is None else feats[perm]
    t0 = time.perf_counter()
    ref = dense_reference(store.topology(), feats_internal, specs, device="cuda")
    err = float(np.abs(out - ref).max(axis=1).mean())
    log(f"[e2e] mean-max-abs error vs dense reference: {err:.3g} "
        f"(limit {E2E_ERR:g}; mean row max |ref| {np.abs(ref).max(axis=1).mean():.3g}; "
        f"reference {time.perf_counter() - t0:.2f}s)")
    assert err < E2E_ERR, f"e2e error {err} >= {E2E_ERR}"
    by_model = {"sage": launches}
    for kind, others in (("gcn", init_gnn_params("gcn", E2E_WIDTHS, seed=3)),
                         ("gin", init_gnn_params("gin", E2E_WIDTHS, seed=3, gin_eps=GIN_EPS))):
        by_model[kind] = _e2e_model(kind, others, store, cfg, feats_internal, workdir)
    return by_model, k1, {"store": store, "final": result.final, "out": out, "ref": ref,
                          "specs": specs, "cfg": cfg, "wall": wall, "feats": feats_internal,
                          "metrics": result.metrics, "trace_path": result.trace_path}


def _e2e_model(kind: str, specs, store, cfg, feats, workdir: str) -> dict[str, int]:
    """One more model through AtlasSession.infer on [e2e]'s store and
    config, after the GraphSAGE run: its LayerMetrics, wall, traced
    seconds and K1's shapes; every K1 launch on the rows route, every K2
    launch on the CUDA cores at a shape [K2] checked (GIN's MLP: two K2
    launches a transform call), evictions, and the error against the
    dense reference on the card (GCN below E2E_ERR on mean-max-abs; GIN,
    whose weight-1 sums over the hubs grow layer by layer, within
    rtol GIN_RTOL and atol GIN_RTOL * max(1, max|ref|)).  Returns its
    launches."""
    from unittest import mock

    from repro_torch.core import atlas, graduation
    from repro_torch.core.atlas import spills_to_dense
    from repro_torch.kernels import edge_block_spmm as ebs
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import dense_reference
    from repro_torch.session import AtlasSession

    v = store.num_vertices
    k2_checked = set(_k2_cases(v))
    read = _reset_gnn_counters()
    k1_shapes: list[tuple] = []
    recording = _recording_aggregators(k1_shapes, {})
    k2_tally: dict[tuple, int] = {}  # K2 calls by (n, k, m, activation)
    transforms = []  # one entry per call of the graduation transform

    def counted(spec, agg, update=graduation.layer_update):
        transforms.append(agg.shape[0])
        return update(spec, agg)

    t0 = time.perf_counter()
    with mock.patch.object(atlas, "chunk_aggregate", recording), \
            mock.patch.object(graduation, "layer_update", counted), \
            mock.patch.object(ops, "graduate", _tallied(
                ops.graduate, k2_tally, lambda x, w, b, act: (x.shape[0], *w.shape, act))), \
            AtlasSession(store, config=cfg, workdir=os.path.join(workdir, f"run_{kind}")) as s:
        result = s.infer(specs)
    wall = time.perf_counter() - t0
    k1, k1_rows, k2, k2_cuda_core = read()
    split = ebs.split_counts.value
    for m in result.metrics:
        log(json.dumps({"layer_metrics": m.as_dict(), "model": kind}))
    log(f"[e2e] {kind} {E2E_WIDTHS}: infer {wall:.3f}s launches K1 {k1} (rows route {k1_rows}, "
        f"split {split[0]} segments into {split[1]} slabs), "
        f"K2 {k2} (CUDA-core route {k2_cuda_core}) in {len(transforms)} transform calls; K2 "
        f"calls by (n, k, m, activation) {sorted(k2_tally.items())}")
    cats = result.telemetry["trace"]["category_seconds"]
    log(f"[e2e] {kind} traced self-seconds by category (all threads): " + json.dumps(
        {k: round(val, 4) for k, val in sorted(cats.items(), key=lambda kv: -kv[1])}))
    _log_k1_shapes(result.metrics, k1_shapes)
    assert k1 > 0 and k1_rows == k1 == len(k1_shapes), \
        f"{kind}: K1 launches off the rows route: {k1_rows} of {k1}"
    assert k2 > 0 and k2_cuda_core == k2 == sum(k2_tally.values()), \
        f"{kind}: K2 launches off the CUDA-core route: {k2_cuda_core} of {k2}"
    per_call = 2 if kind == "gin" else 1
    assert k2 == per_call * len(transforms), \
        f"{kind}: {k2} K2 launches for {len(transforms)} transform calls"
    assert set(k2_tally) <= k2_checked, f"{kind}: K2 shapes unchecked: {set(k2_tally) - k2_checked}"
    evictions = sum(m.evictions for m in result.metrics)
    assert evictions > 0, f"{kind}: the hot store never evicted"

    out = spills_to_dense(result.final.spills, v, result.final.dim)
    assert out.shape == (v, E2E_WIDTHS[-1]) and np.isfinite(out).all()
    t0 = time.perf_counter()
    ref = dense_reference(store.topology(), feats, specs, device="cuda")
    diff = np.abs(out - ref)
    err, ref_max = float(diff.max(axis=1).mean()), float(np.abs(ref).max())
    log(f"[e2e] {kind} mean-max-abs error vs dense reference: {err:.3g}, max abs {diff.max():.3g} "
        f"(max|ref| {ref_max:.3g}; evictions {evictions}; reference "
        f"{time.perf_counter() - t0:.2f}s)")
    if kind == "gin":
        atol = GIN_RTOL * max(1.0, ref_max)
        worst = float((diff - GIN_RTOL * np.abs(ref)).max())
        log(f"[e2e] gin: max(|out - ref| - rtol |ref|) {worst:.3g} (limit atol {atol:.3g}: "
            f"rtol {GIN_RTOL:g}, atol rtol x max(1, max|ref|))")
        np.testing.assert_allclose(out, ref, rtol=GIN_RTOL, atol=atol)
    else:
        assert err < E2E_ERR, f"{kind}: e2e error {err} >= {E2E_ERR}"
    return {"edge_block_spmm": k1, "fused_graduate": k2}


PUBLISH_IDS = 100_000  # ids per lookup of each reader, drawn with duplicates
FRONTEND_THREADS, FRONTEND_REQUESTS, FRONTEND_IDS = 8, 200, 64  # per thread


def phase_publish(e2e: dict, workdir: str) -> dict:
    """Publish [e2e]'s final layer and serve it: three reader paths, a
    re-publish under a pinned reader, GC, and the batching front end.
    Every time here is the host's clock: publish and lookups are host code
    over numpy and mmaps."""
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.session import AtlasSession

    t_phase = time.perf_counter()
    store, final, out = e2e["store"], e2e["final"], e2e["out"]
    new_of_old = store.new_of_old()
    assert new_of_old is not None, "the e2e store must be reordered (order='at')"
    rng = np.random.default_rng(5)
    ids = rng.integers(0, store.num_vertices, PUBLISH_IDS)
    expect = out[new_of_old[ids]]  # external ids -> storage rows
    stats: dict = {"ids": PUBLISH_IDS, "unique_ids": int(len(np.unique(ids)))}
    with AtlasSession(store, workdir=os.path.join(workdir, "run")) as s:
        t0 = time.perf_counter()
        pub = s.publish(final)
        wall = time.perf_counter() - t0
        assert (pub.num_rows, pub.dim) == (store.num_vertices, final.dim)
        on_disk = sum(os.path.getsize(f) for f in pub.files)
        readers = {
            "page_cache": s.reader(final.layer, fast_path=False, cache_bytes=32 << 20),
            "mmap": s.reader(final.layer, fast_path=True),
            "auto": s.reader(final.layer, fast_path="auto", cache_bytes=256 << 20),
        }
        assert not readers["page_cache"].fast_path and readers["mmap"].fast_path
        assert readers["auto"].fast_path, "fast_path='auto' at 256 MiB did not take the mmap path"
        layer = readers["mmap"].layer
        stats["publish"] = {
            "epoch": pub.epoch, "rows": pub.num_rows, "dim": pub.dim,
            "data_bytes": layer.data_nbytes, "file_bytes": on_disk,
            "files": len(pub.files), "blocks": layer.num_blocks,
            "block_rows": int(layer.file_block_rows[0]), "seconds": wall,
            "mb_per_s": on_disk / wall / 1e6,
        }
        log(f"[publish] v{pub.epoch}: {pub.num_rows} x {pub.dim} f32 "
            f"({layer.data_nbytes} B of rows, {on_disk} B on disk) in {len(pub.files)} "
            f"file(s) of {layer.num_blocks} blocks of {int(layer.file_block_rows[0])} rows: "
            f"{wall:.4f} s host clock, {on_disk / wall / 1e6:.1f} MB/s")
        for name, r in readers.items():
            for phase in ("cold", "warm"):
                blocks = r.blocks_read
                t0 = time.perf_counter()
                got = r.lookup(ids)
                dt = time.perf_counter() - t0
                assert got.dtype == np.float32 and np.array_equal(got, expect), \
                    f"[publish] {name} reader's {phase} lookup differs from spills_to_dense"
                stats[f"{name}_{phase}"] = {
                    "seconds": dt, "ids_per_s": PUBLISH_IDS / dt,
                    "blocks_read": r.blocks_read - blocks,
                }
            cache = r.cache
            log(f"[publish] {name} reader (fast_path={r.fast_path}): "
                f"{PUBLISH_IDS} ids ({stats['unique_ids']} distinct) cold "
                f"{stats[name + '_cold']['ids_per_s']:.0f} ids/s, warm "
                f"{stats[name + '_warm']['ids_per_s']:.0f} ids/s host clock; blocks_read "
                f"{stats[name + '_cold']['blocks_read']} + {stats[name + '_warm']['blocks_read']}"
                + ("" if cache is None else
                   f"; cache hits {cache.hits} misses {cache.misses} evicted "
                   f"{cache.evicted_blocks}"))
        assert readers["page_cache"].cache.evicted_blocks > 0, "the 32 MiB cache never evicted"

        # re-publish under the open readers: their version stays on disk
        # and serves the same bits; once they close, gc collects it
        pinned = readers["page_cache"]
        t0 = time.perf_counter()
        pub2 = s.publish(final)
        stats["republish_seconds"] = time.perf_counter() - t0
        assert pub.epoch not in pub2.gc_removed and os.path.isdir(pub.dir)
        assert pinned.version == pub.epoch
        assert np.array_equal(pinned.lookup(ids), expect), "pinned reader changed across re-publish"
        for r in readers.values():
            r.close()
        collected = s.gc(final.layer)
        assert collected == [pub.epoch] and not os.path.exists(pub.dir), \
            f"gc collected {collected}, expected [{pub.epoch}]"
        log(f"[publish] re-published as v{pub2.epoch} in {stats['republish_seconds']:.4f} s "
            f"host clock under a reader pinned to v{pub.epoch} (same bits); gc after "
            f"close collected {collected}")

        # the batching front end: FRONTEND_THREADS callers, one reader
        reqs = [rng.integers(0, store.num_vertices, FRONTEND_IDS)
                for _ in range(FRONTEND_THREADS * FRONTEND_REQUESTS)]
        results: list = [None] * len(reqs)
        with s.reader(final.layer, fast_path="auto", cache_bytes=256 << 20) as r:
            assert r.version == pub2.epoch
            with ServingFrontend(r, max_batch=4096, max_delay_s=0.002) as fe:
                def client(k: int) -> None:
                    for i in range(k, len(reqs), FRONTEND_THREADS):
                        results[i] = fe.lookup(reqs[i], timeout=60)

                threads = [threading.Thread(target=client, args=(k,))
                           for k in range(FRONTEND_THREADS)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                dt = time.perf_counter() - t0
            for q, got in zip(reqs, results):
                assert got is not None and np.array_equal(got, r.lookup(q)), \
                    "[publish] a front-end request's rows differ from the direct lookup"
                assert np.array_equal(got, out[new_of_old[q]])
        snap = fe.snapshot()
        assert snap["requests"] == len(reqs) and snap["errors"] == 0
        n = len(reqs) * FRONTEND_IDS
        stats["frontend"] = {"threads": FRONTEND_THREADS, "requests": len(reqs),
                             "ids_per_request": FRONTEND_IDS, "seconds": dt,
                             "ids_per_s": n / dt, **snap}
        log(f"[publish] front end: {FRONTEND_THREADS} threads x {FRONTEND_REQUESTS} "
            f"requests of {FRONTEND_IDS} ids: {snap['waves']} waves "
            f"({snap['ids_per_wave']:.1f} ids per wave), {n / dt:.0f} ids/s host clock")
    stats["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[publish] phase {stats['phase_seconds']:.2f} s host clock, checks included")
    log(json.dumps({"publish_phase": stats}))
    return stats


def _reset_gnn_counters():
    from repro_torch.kernels import edge_block_spmm, fused_graduate

    counters = (edge_block_spmm.launches, edge_block_spmm.rows_launches,
                fused_graduate.launches, fused_graduate.cuda_core_launches)
    for counter in (*counters, edge_block_spmm.split_counts):
        counter.reset()
    return lambda: tuple(c.value for c in counters)


DIST_EXACT_VERTICES = 20_000
# GIN's exact dims: with in-degrees 4 and 16 (self-loops included), the self
# message, features in [-2, 2] and weights in [-1, 1], every partial sum stays
# an integer below 2^24 (at [16, 32, 8] the worst case passes it)
DIST_GIN_DIMS = [8, 8, 4]


def int_gin_specs(dims, seed: int) -> list:
    """GIN stack with small-integer MLP weights and biases and eps=0
    (``exact.int_specs`` gives only w/b, which GIN's update cannot read):
    on ``exact.pow_degree_graph`` every sum is exact in any order."""
    from repro_torch.models.gnn import GNNLayerSpec

    rng = np.random.default_rng(seed)
    specs = []
    for i in range(len(dims) - 1):
        d_in, d_out = dims[i], dims[i + 1]
        h = max(d_in, d_out)
        specs.append(GNNLayerSpec(
            kind="gin", in_dim=d_in, out_dim=d_out,
            activation=i < len(dims) - 2,
            params={
                "w1": rng.integers(-1, 2, size=(d_in, h)).astype(np.float32),
                "b1": rng.integers(-2, 3, size=h).astype(np.float32),
                "w2": rng.integers(-1, 2, size=(h, d_out)).astype(np.float32),
                "b2": rng.integers(-2, 3, size=d_out).astype(np.float32),
                "eps": np.float32(0.0),
            },
        ))
    return specs


def exact_gin_case(v: int):
    """(csr, features, specs) of the exact GIN run: power-of-two in-degrees
    4 and 16 with self-loops, integer features of width DIST_GIN_DIMS[0]
    and ``int_gin_specs``."""
    from repro_torch.exact import int_features, pow_degree_graph

    csr = pow_degree_graph(v, (4, 16), seed=7, self_loops=True)
    return csr, int_features(v, DIST_GIN_DIMS[0], seed=8), int_gin_specs(DIST_GIN_DIMS, seed=9)


def _dist_exact_cases(workdir: str) -> list[dict]:
    """Every shard count and exchange on exact graphs, each bitwise equal
    to the single-machine run on the card; GIN's single-machine run also
    bitwise equal to the dense reference on the card."""
    from repro_torch.core.atlas import AtlasConfig, spills_to_dense
    from repro_torch.dist import DistSession
    from repro_torch.exact import exact_graph_and_specs
    from repro_torch.models.gnn import dense_reference
    from repro_torch.session import AtlasSession
    from repro_torch.storage.layout import GraphStore

    v = DIST_EXACT_VERTICES
    cases = []
    cfg = AtlasConfig(backend="cuda", chunk_bytes=1 << 16, hot_slots=4096)
    for kind in ("gcn", "sage", "gin"):
        if kind == "gin":
            csr, feats, specs = exact_gin_case(v)
        else:
            csr, feats, specs = exact_graph_and_specs(v, 16, kind=kind)
        store = GraphStore.create(os.path.join(workdir, f"exact_{kind}"), csr, feats,
                                  num_partitions=4)
        with AtlasSession(store, config=cfg, workdir=os.path.join(workdir, f"x1_{kind}")) as s:
            res = s.infer(specs)
            ref = spills_to_dense(res.final.spills, v, res.final.dim)
        if kind == "gin":
            dense = dense_reference(csr, feats, specs, device="cuda")
            same = bool(np.array_equal(ref, dense))
            log(f"[dist] exact gin {DIST_GIN_DIMS} V={v}: one machine bitwise the dense reference "
                f"on the card: {same} (max|ref| {float(np.abs(dense).max()):.0f})")
            assert same, "[dist] exact gin: the one-machine run differs from the dense reference"
        for shards, exchange in ((1, "local"), (2, "local"), (4, "local"), (2, "mesh")):
            t0 = time.perf_counter()
            with DistSession(store, shards=shards, config=cfg, exchange=exchange,
                             mesh_devices=["cuda:0"] * shards,
                             workdir=os.path.join(workdir, f"x_{kind}_{shards}_{exchange}")) as d:
                res_d = d.infer(specs)
            wall = time.perf_counter() - t0
            same = bool(np.array_equal(
                spills_to_dense(res_d.final.spills, v, res_d.final.dim), ref))
            recv = sum(r["exchange"]["recv_records"]
                       for reports in res_d.shard_reports.values() for r in reports)
            cases.append({"kind": kind, "shards": shards, "exchange": exchange,
                          "bit_identical": same, "recv_records": recv, "seconds": wall})
            log(f"[dist] exact {kind} V={v}: {shards} shard(s) on {exchange}: "
                f"bit_identical={same}, {recv} records received, {wall:.3f} s host clock")
            assert same, f"[dist] {kind} {shards} shards on {exchange} differs from one machine"
            assert shards == 1 or recv > 0, "[dist] no record crossed the exchange"
    return cases


def _dist_process_run(workdir: str) -> dict:
    """The process-worker launcher as a user runs it: one python process per
    shard per layer, each with its own CUDA context."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.infer_dist",
           "--vertices", str(DIST_EXACT_VERTICES), "--feat-dim", "16", "--shards", "2",
           "--workers", "process", "--workdir", os.path.join(workdir, "infer_dist")]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    wall = time.perf_counter() - t0
    assert out.returncode == 0, \
        f"[dist] infer_dist exited {out.returncode}:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}"
    report = json.loads(out.stdout[out.stdout.index("{"):])
    assert report["bit_identical"] and report["served_identical"], report
    assert report["device"] == "cuda"
    startup = {layer: [r["startup_seconds"] for r in reports]
               for layer, reports in report["shard_reports"].items()}
    log(f"[dist] infer_dist --workers process --shards 2 (V={DIST_EXACT_VERTICES}, gcn): "
        f"bit_identical and served_identical; wall {wall:.2f} s host clock (dist infer "
        f"{report['infer_seconds']:.2f} s, then the single-machine check); worker startup "
        f"(spawn to layer start) by layer {startup} s")
    return {"wall_seconds": wall, "infer_seconds": report["infer_seconds"],
            "worker_startup_seconds": startup}


def phase_dist(e2e: dict, workdir: str) -> dict:
    """Sharded inference on the card: e2e's model on e2e's store, then the
    exact-graph cases and the process-worker launcher."""
    from repro_torch.core.atlas import spills_to_dense
    from repro_torch.dist import DistSession
    from repro_torch.launch.obs_report import analyze, load_trace

    t_phase = time.perf_counter()
    store, specs, cfg = e2e["store"], e2e["specs"], e2e["cfg"]
    read = _reset_gnn_counters()
    t0 = time.perf_counter()
    with DistSession(store, shards=2, config=cfg, workers="thread", exchange="local",
                     workdir=os.path.join(workdir, "dist")) as dist:
        result = dist.infer(specs)
        wall = time.perf_counter() - t0
        k1, k1_rows, k2, k2_cuda_core = read()
        out = spills_to_dense(result.final.spills, store.num_vertices, result.final.dim)
        # the published merge serves the run's own rows by external id
        dist.publish(result.final)
        ids = np.random.default_rng(5).integers(0, store.num_vertices, PUBLISH_IDS)
        with dist.reader(result.final.layer, fast_path=True) as reader:
            served = reader.lookup(ids)
        served_ok = bool(np.array_equal(served, out[store.new_of_old()[ids]]))
    reports = [r for layer in sorted(result.shard_reports) for r in result.shard_reports[layer]]
    err = float(np.abs(out - e2e["ref"]).max(axis=1).mean())
    vs_e2e = float(np.abs(out - e2e["out"]).max())
    evictions = sum(r["evictions"] for r in reports)
    per_shard = {}
    for r in reports:
        acc = per_shard.setdefault(r["shard"], dict.fromkeys(r["exchange"], 0))
        for key, val in r["exchange"].items():
            acc[key] += val
    barrier = analyze(load_trace(result.trace_path))["category_seconds"].get("barrier", 0.0)
    stats = {
        "vertices": store.num_vertices, "shards": 2, "infer_seconds": wall,
        "e2e_infer_seconds": e2e["wall"], "mean_max_abs_err": err,
        "max_abs_vs_e2e": vs_e2e, "evictions": evictions,
        "launches": {"edge_block_spmm": k1, "edge_block_spmm_rows": k1_rows,
                     "fused_graduate": k2, "fused_graduate_cuda_core": k2_cuda_core},
        "exchange_by_shard": per_shard, "traced_barrier_seconds": barrier,
        "served_ids": PUBLISH_IDS, "served_identical": served_ok,
    }
    log(f"[dist] 2 thread shards, local exchange, V={store.num_vertices}: infer "
        f"{wall:.3f} s host clock (e2e's single machine {e2e['wall']:.3f} s); K1 {k1} launches "
        f"({k1_rows} on the rows route), K2 {k2} ({k2_cuda_core} on the CUDA cores); "
        f"evictions {evictions}")
    for shard, ex in sorted(per_shard.items()):
        log(f"[dist] shard {shard}: sent {ex['sent_records']} records ({ex['sent_bytes']} B), "
            f"received {ex['recv_records']} records ({ex['recv_bytes']} B) over 3 layers")
    log(f"[dist] mean-max-abs error vs dense reference {err:.3g} (limit {E2E_ERR:g}); "
        f"max |dist - e2e| {vs_e2e:.3g}; traced barrier (exchange collect + fsync) "
        f"{barrier:.4f} s; {_pinned_held()}")
    assert err < E2E_ERR, f"[dist] error {err} >= {E2E_ERR}"
    assert evictions > 0, "[dist] the shards' hot stores never evicted"
    assert k1_rows > 0 and k1_rows == k1, f"[dist] K1 launches off the rows route: {k1_rows} of {k1}"
    assert k2_cuda_core > 0, "[dist] K2 never ran on the shard workers"
    assert all(ex["sent_records"] > 0 and ex["recv_records"] > 0 for ex in per_shard.values()), \
        f"[dist] a shard sent or received nothing: {per_shard}"
    assert served_ok, "[dist] the published dist layer serves other rows than its spills"
    stats["exact_cases"] = _dist_exact_cases(workdir)
    stats["process"] = _dist_process_run(workdir)
    stats["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[dist] phase {stats['phase_seconds']:.2f} s host clock, checks included")
    log(json.dumps({"dist_phase": stats}))
    return stats


MESH_SHAPE = (4, 2)  # (data, model): the reference example's mesh
MESH_WIDTHS = [128, 256, 256, 172]  # [e2e]'s widths
MESH_EXACT_VERTICES = 20_000
MESH_EXACT = (((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
              ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")))


_MESH_FAMILIES = {"K1": ("segment_rows_kernel", "segment_reduce_kernel"),
                  "K2": ("sgemm_kernel", "graduate_tc_kernel")}


def _mesh_run(mesh, plan, x, specs) -> tuple[list[float], list, torch.Tensor, str]:
    """Each layer's step called once to warm it up (its first call moves
    the plan's indices to the card), then timed on the host clock,
    synchronized; the second layer (the widest input) once more under
    torch.profiler.  Returns the walls, the wire bytes, the padded output
    of the timed passes and the profiled layer's device split."""
    from repro_torch.dist import mesh as dm

    combined = isinstance(plan, dm.CombinedEdgePlan)
    h = dm.shard_features(mesh, torch.from_numpy(x))
    walls, moved, split = [], [], ""
    for k, spec in enumerate(specs):
        has_self = spec.kind == "sage"
        step = (dm.make_combined_layer_step(mesh, has_self=has_self, activation=spec.activation)
                if combined else
                dm.make_layer_step(mesh, has_self=has_self, activation=spec.activation))
        args = dm.layer_weights(spec, torch.float32)
        step(h, plan, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h_next = step(h, plan, *args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if k == 1:
            events = _device_kernels(lambda: step(h, plan, *args))
            busy = sum(e.self_device_time_total for e in events) / 1e3
            shares = {fam: sum(e.self_device_time_total for e in events
                               if any(n in e.key for n in names)) / 1e3
                      for fam, names in _MESH_FAMILIES.items()}
            split = (f"layer 1 device busy {busy:.3f} ms in {sum(e.count for e in events)} "
                     f"kernels, of it " + ", ".join(f"{f} {v:.3f} ms" for f, v in shares.items())
                     if busy > 0 else "layer 1 device busy not measured (no device time)")
        h = h_next
        rows = plan.slots if combined else plan.bucket
        want = dm.wire_bytes(mesh.num_shards, mesh.model_size, rows, spec.in_dim, 4,
                             plan.v_local, spec.out_dim)
        assert step.wire_bytes == want, f"[mesh] wire bytes {step.wire_bytes} != {want}"
        moved.append(step.wire_bytes.total)
    return walls, moved, dm.gather_shards(h), split


def _mesh_exact_cases() -> list[dict]:
    """Exact graphs at every mesh, all positions on cuda:0: both steps (the
    baseline at 1 and 3 chunks), each bitwise the dense reference."""
    from repro_torch.dist import mesh as dm
    from repro_torch.exact import exact_graph_and_specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.gnn import dense_reference

    cases = []
    for shape, axes in MESH_EXACT:
        mesh = make_mesh(shape, axes, devices="cuda:0")
        for kind in ("gcn", "sage"):
            csr, feats, specs = exact_graph_and_specs(MESH_EXACT_VERTICES, 16, kind=kind)
            for step, chunks in (("combined", 1), ("baseline", 1), ("baseline", 3)):
                build = dm.build_combined_plan if step == "combined" else dm.build_edge_plan
                plan = build(csr, mesh.num_shards, kind)
                x = dm.pad_features(feats, plan)
                want = dense_reference(dm.pad_graph(csr, plan), x, specs, device="cuda")
                got, _ = dm.run_layers(mesh, plan, torch.from_numpy(x), specs, chunks=chunks)
                same = bool(np.array_equal(got.numpy(), want))
                cases.append({"mesh": "x".join(map(str, shape)), "kind": kind, "step": step,
                              "chunks": chunks, "bit_identical": same})
                assert same, f"[mesh] exact {kind} {step} x{chunks} on {shape} differs"
    log(f"[mesh] exact graphs ({MESH_EXACT_VERTICES} x 16, gcn and sage) at meshes "
        f"{[c[0] for c in MESH_EXACT]}: combined and baseline (chunks 1 and 3), "
        f"{len(cases)} runs, each bitwise the dense reference")
    return cases


def phase_mesh(num_vertices: int) -> dict:
    """The GNN device mesh (repro_torch.dist.mesh) on the card: both steps
    at [e2e]'s widths on a (4, 2) mesh whose positions share cuda:0, then
    the exact graphs at every mesh."""
    from repro_torch.dist import mesh as dm
    from repro_torch.graphs.synth import make_features, powerlaw_graph
    from repro_torch.kernels import edge_block_spmm as ebs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.gnn import dense_reference, init_gnn_params

    t_phase = time.perf_counter()
    s, m = MESH_SHAPE
    csr = powerlaw_graph(num_vertices, 12, seed=1, self_loops=True)
    feats = make_features(num_vertices, MESH_WIDTHS[0], seed=2)
    t0 = time.perf_counter()
    plans = {"gcn-combined": dm.build_combined_plan(csr, s, kind="gcn"),
             "gcn-baseline": dm.build_edge_plan(csr, s, kind="gcn"),
             "sage-combined": dm.build_combined_plan(csr, s, kind="sage")}
    plan_s = time.perf_counter() - t0
    cplan, eplan = plans["gcn-combined"], plans["gcn-baseline"]
    log(f"[mesh] V={num_vertices} E={csr.num_edges} on a {s}x{m} mesh over ['cuda:0'] * {s * m}: "
        f"bucket {cplan.bucket} ({s * s * cplan.bucket} padded edges), slots {cplan.slots}, "
        f"reuse {cplan.reuse}; three plans in {plan_s:.2f} s host clock")
    dl = max(MESH_WIDTHS[:-1]) // m
    log(f"[mesh] message slabs per model shard at D/M={dl} (f32 from K1): baseline "
        f"{s * s * eplan.bucket * dl * 4 / 1e9:.2f} GB, combined "
        f"{s * s * cplan.slots * dl * 4 / 1e9:.2f} GB; no chunks")
    mesh = make_mesh(MESH_SHAPE, ("data", "model"), devices=["cuda:0"] * (s * m))
    x = dm.pad_features(feats, cplan)
    read = _reset_gnn_counters()
    runs = {}
    for name, plan in plans.items():
        specs = init_gnn_params(name.split("-")[0], MESH_WIDTHS, seed=3)
        torch.cuda.reset_peak_memory_stats()
        walls, moved, out, split = _mesh_run(mesh, plan, x, specs)
        peak = torch.cuda.max_memory_allocated()
        ref = dense_reference(dm.pad_graph(csr, plan), x, specs, device="cuda")
        err = float(np.abs(out.numpy() - ref).max(axis=1).mean())
        runs[name] = {"layer_seconds": walls, "wire_bytes": moved, "mean_max_abs_err": err,
                      "peak_bytes": peak, "device_split": split}
        log(f"[mesh] {name}: per layer {['%.4f' % w for w in walls]} s host clock "
            f"(synchronized, after a warm-up); wire bytes {moved}; peak {peak} B; "
            f"mean-max-abs error vs dense reference {err:.3g} (limit {E2E_ERR:g}); {split}")
        assert err < E2E_ERR, f"[mesh] {name}: error {err} >= {E2E_ERR}"
    k1, k1_rows, k2, k2_cuda_core = read()
    split = ebs.split_counts.value
    ratio = [b / c for b, c in zip(runs["gcn-baseline"]["wire_bytes"],
                                   runs["gcn-combined"]["wire_bytes"])]
    log(f"[mesh] wire bytes baseline / combined by layer: {['%.3f' % r for r in ratio]}; "
        f"K1 {k1} launches ({k1_rows} on the rows route; split {split[0]} segments into "
        f"{split[1]} slabs), K2 {k2} ({k2_cuda_core} on the CUDA cores)")
    assert split[0] > 0, "[mesh] K1 split no hub segment of the power-law graph"
    assert k1 > 0 and k1_rows == k1, f"[mesh] K1 launches off the rows route: {k1_rows} of {k1}"
    assert k2 > 0 and k2_cuda_core == k2, f"[mesh] K2 off the CUDA cores: {k2_cuda_core} of {k2}"
    read = _reset_gnn_counters()
    exact_cases = _mesh_exact_cases()
    e1, e1_rows, e2, e2_cuda_core = read()
    assert e1 > 0 and e1_rows == e1 and e2 > 0 and e2_cuda_core == e2, (e1, e1_rows, e2, e2_cuda_core)
    stats = {"vertices": num_vertices, "edges": csr.num_edges, "mesh": list(MESH_SHAPE),
             "bucket": cplan.bucket, "slots": cplan.slots, "reuse": cplan.reuse,
             "plan_seconds": plan_s, "runs": runs, "wire_ratio": ratio,
             "launches": {"edge_block_spmm": k1, "fused_graduate": k2},
             "k1_split": {"segments": split[0], "slabs": split[1]},
             "exact_cases": exact_cases, "card": smi(),
             "phase_seconds": time.perf_counter() - t_phase}
    log(f"[mesh] phase {stats['phase_seconds']:.2f} s host clock, checks included; {stats['card']}")
    log(json.dumps({"mesh_phase": stats}))
    return stats


GATHER_VERTEXWISE_VERTICES = 5_000


def phase_gather(e2e: dict) -> dict:
    """The gather baselines on the card, then e2e's trace through the
    port's obs_report."""
    from repro_torch.core.gather_ref import layerwise_gather, vertexwise_gather
    from repro_torch.graphs.synth import make_features, powerlaw_graph
    from repro_torch.launch.obs_report import analyze, load_trace, reconcile, validate_trace
    from repro_torch.models.gnn import dense_reference

    t_phase = time.perf_counter()
    store, specs = e2e["store"], e2e["specs"]
    e2e_read = [m.bytes_read for m in e2e["metrics"]]
    v_small = GATHER_VERTEXWISE_VERTICES
    small = powerlaw_graph(v_small, 12, seed=1)
    small_feats = make_features(v_small, 128, seed=2)
    small_ref = dense_reference(small, small_feats, specs, device="cuda")
    stats = {}
    for name, fn, csr, feats, ref, batch in (
        ("layerwise", layerwise_gather, store.topology(), e2e["feats"], e2e["ref"], 4096),
        ("vertexwise", vertexwise_gather, small, small_feats, small_ref, 1024),
    ):
        read = _reset_gnn_counters()
        t0 = time.perf_counter()
        out, g = fn(csr, feats, specs, batch_size=batch, device="cuda")
        wall = time.perf_counter() - t0
        k1, k1_rows, k2, _ = read()
        err = float(np.abs(out - ref).max(axis=1).mean())
        stats[name] = {"vertices": csr.num_vertices, "batch_size": batch, "seconds": wall,
                       "mean_max_abs_err": err, **dataclasses.asdict(g),
                       "launches": {"edge_block_spmm": k1, "edge_block_spmm_rows": k1_rows,
                                    "fused_graduate": k2}}
        log(f"[gather] {name} V={csr.num_vertices} batch {batch}: {wall:.3f} s host clock; "
            f"bytes_read {g.bytes_read} in {g.block_reads} blocks, rows_requested "
            f"{g.rows_requested}, vertex visits {g.compute_vertex_visits}; K1 {k1} launches "
            f"({k1_rows} rows route), K2 {k2}; error vs dense reference {err:.3g}")
        assert out.shape == ref.shape and np.isfinite(out).all()
        assert err < E2E_ERR, f"[gather] {name} error {err} >= {E2E_ERR}"
        assert k1 > 0 and k2 > 0, f"[gather] {name} did not run K1 and K2"
    lw = stats["layerwise"]["bytes_read"]
    stats["e2e_bytes_read_by_layer"] = e2e_read
    stats["layerwise_read_amplification"] = lw / sum(e2e_read)
    log(f"[gather] read volume on e2e's graph: layerwise gather {lw} B against ATLAS's "
        f"{sum(e2e_read)} B ({e2e_read} by layer): {lw / sum(e2e_read):.2f}x")

    events = load_trace(e2e["trace_path"])
    violations = validate_trace(events)
    layers = [m.as_dict() for m in e2e["metrics"]]
    report = analyze(events)
    problems = reconcile(report, layers)
    for field in ("aggregate_seconds", "h2d_seconds", "pipeline_stall_seconds",
                  "transform_seconds", "barrier_seconds"):
        log(f"[gather] e2e trace vs LayerMetrics: {field} metric "
            f"{sum(m[field] for m in layers):.4f} s")
    log(f"[gather] e2e trace: {report['num_events']} events, {report['num_spans']} spans; "
        f"{len(violations)} schema violation(s), reconcile: {problems or 'no mismatch'}")
    assert not violations, f"[gather] e2e's trace breaks the schema: {violations[:5]}"
    assert not problems, f"[gather] e2e's trace does not reconcile with its metrics: {problems}"
    stats["trace"] = {"events": report["num_events"], "spans": report["num_spans"],
                      "violations": len(violations), "reconcile_problems": problems}
    stats["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[gather] phase {stats['phase_seconds']:.2f} s host clock, checks included")
    log(json.dumps({"gather_phase": stats}))
    return stats


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _peak(dtype) -> float:
    from repro_torch.perf.hlo_cost import H100

    return H100["peak_flops"] if dtype == torch.bfloat16 else H100["peak_flops_f32"]


def _check(name: str, got, plain, tol: float) -> float:
    torch.cuda.synchronize()
    err = float((got.float() - plain.float()).abs().max())
    assert torch.isfinite(got.float()).all(), f"{name}: non-finite output"
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
    return err


@dataclasses.dataclass(frozen=True)
class _ServeRun:
    arch: str
    max_batch: int
    lengths: list  # prompt lengths, in submission order
    needed: tuple  # kernels that must launch
    max_tokens: int
    layers: int | None = None  # the depth, where the published one is cut


def _serve_traffic():
    """lm-serve's traffic, drawn from numpy seed 4 (the MoE runs' prompt
    lengths from seed 6, recurrentgemma's from seed 8, the last four
    runs' from seed 10): the generator (which then draws the prompts'
    tokens or embeddings, run by run: new runs go last) and the runs."""
    rng = np.random.default_rng(4)
    moe = np.random.default_rng(6)
    hybrid = np.random.default_rng(8)
    rest = np.random.default_rng(10)
    runs = (
        # prompts of 64–128 tokens, not 64–256: every prompt token is replayed
        # through a host-bound decode step, and the smoke has a time budget
        _ServeRun("qwen3-14b", 4, [int(n) for n in rng.integers(64, 129, 5)],
                  ("flash_attention", "rms_norm"), 16),
        # one prompt of 512 pads the wave to two whole SSD chunks
        _ServeRun("mamba2-2.7b", 4, [int(n) for n in rng.integers(300, 513, 3)] + [512],
                  ("ssd_chunk", "rms_norm"), 16),
        # the MoE models: 8 new tokens, not 16 (the replay of each prompt is host-bound)
        _ServeRun("deepseek-moe-16b", 4, [int(n) for n in moe.integers(64, 129, 4)],
                  ("flash_attention", "rms_norm"), 8),
        # one of 35 layers: 14.07 B parameters (28.1 GB, 55.4 GB at init,
        # which stacks a copy of the layer): two would not fit
        _ServeRun("arctic-480b", 2, [int(n) for n in moe.integers(64, 129, 2)],
                  ("flash_attention", "rms_norm"), 8, layers=1),
        # all 38 layers (9.63 B parameters, 19.25 GB): prompts shorter than the
        # window of 2048, so the band is exercised by [lm-check], [K3] and [train]
        _ServeRun("recurrentgemma-9b", 4, [int(n) for n in hybrid.integers(64, 129, 4)],
                  ("flash_attention", "rglru_scan", "rms_norm"), 8),
        # the dense and modality-stub attention models at published width and
        # depth, one wave each: deepseek-7b (32/32 heads), musicgen-medium
        # (embeddings, 24/24 heads of 64, K5 general at 1536), pixtral-12b
        # (embeddings, attention width 4096 of d_model 5120) and starcoder2-3b
        # (QKV and gelu biases, 24/2 heads, K5 general at 3072)
        *(_ServeRun(arch, 4, [int(n) for n in rest.integers(64, 129, 4)],
                    ("flash_attention", "rms_norm"), 8)
          for arch in ("deepseek-7b", "musicgen-medium", "pixtral-12b", "starcoder2-3b")),
    )
    return rng, runs


def _served_waves(arch: str) -> list[tuple[int, int]]:
    """(batch, padded prompt length) of each aligned wave lm-serve runs for
    ``arch``: ServingEngine takes max_batch requests in order and left-pads
    them to the longest."""
    _, runs = _serve_traffic()
    run = next(r for r in runs if r.arch == arch)
    return [(len(run.lengths[i:i + run.max_batch]), max(run.lengths[i:i + run.max_batch]))
            for i in range(0, len(run.lengths), run.max_batch)]


def _norm_rows(cfg, tokens: int) -> list[tuple[int, int, str]]:
    """(rows, width, what) of the K5 calls a forward of ``cfg`` over
    ``tokens`` token rows makes: the hidden rows (every family), the q- and
    k-norm (qk_norm) and mamba's inner norm."""
    rows = [(tokens, cfg.d_model, "rows")]
    if cfg.qk_norm:
        rows += [(tokens * cfg.num_heads, cfg.head_dim, "q-norm"),
                 (tokens * cfg.num_kv_heads, cfg.head_dim, "k-norm")]
    if cfg.family == "ssm":
        rows.append((tokens, 2 * cfg.d_model, "inner"))
    return rows


def _merged(shapes) -> list[tuple]:
    """One case per (rows, width, dtype), named for all its uses."""
    labels: dict[tuple, list[str]] = {}
    for n, d, w, dt in shapes:
        labels.setdefault((n, d, dt), []).append(w)
    return [(n, d, " / ".join(ws), dt) for (n, d, dt), ws in labels.items()]


def _by_shape(cases) -> list[tuple]:
    """One case per shape (every field but the last, its label), labelled
    with all its uses, in first-use order."""
    labels: dict[tuple, list[str]] = {}
    for case in cases:
        labels.setdefault(tuple(case[:-1]), []).append(case[-1])
    return [(*key, " / ".join(ws)) for key, ws in labels.items()]


def _k5_shapes() -> list[tuple[int, int, str, torch.dtype]]:
    """(rows, width, what, dtype) of K5's checks: first every shape the
    served path normalises (bf16: each run's prefill waves and their decode
    steps), then the fixed extra shapes."""
    from repro_torch.configs import get_config

    shapes = []
    for run in _serve_traffic()[1]:
        cfg = get_config(run.arch)
        for b, s in _served_waves(run.arch):
            for tokens, what in ((b * s, f"prefill B={b} S={s}"), (b, f"decode B={b}")):
                shapes += [(n, d, f"{run.arch} {what} {w}", torch.bfloat16)
                           for n, d, w in _norm_rows(cfg, tokens)]
    shapes += [(n, d, w, dt) for n, d, w in ((1024, 5120, "qwen3 rows at 4x256"),
                                             (4 * 40 * 256, 128, "qwen3 qk-norm at 4x256"),
                                             (2048, 2560, "mamba rows"),
                                             (4096, 4096, "recurrentgemma [train] rows"))
               for dt in (torch.bfloat16, torch.float32)]
    b, s = _served_waves("arctic-480b")[0]
    shapes += [(MESH_TRAIN_B * MESH_TRAIN_S, get_config(MESH_TRAIN_ARCH).d_model,
                f"{MESH_TRAIN_ARCH} [train-mesh] one device rows", torch.float32),
               (b * s, get_config("arctic-480b").d_model, f"arctic-480b prefill B={b} S={s} rows",
                torch.float32)]
    return _merged(shapes + _train_mesh_rows() + _serve_mesh_rows() + _rec_k5_rows("train")
                   + _rec_k5_rows("serve") + _moe_k5_rows("train") + _moe_k5_rows("serve"))


def _k3_cases() -> list[tuple[int, int, int, int, int, int | None, torch.dtype, str]]:
    """(B, S, Hq, Hkv, D, window, dtype, what) of K3's checks: every
    prefill wave lm-serve runs through attention, at its model's head
    counts, head dim and window in bf16, then qwen3's first wave in f32,
    the fixed extras at head dim 128, and recurrentgemma's [train] forward
    and a ragged case with the band active, in f32 and bf16."""
    from repro_torch.configs import get_config

    cases = []
    for run in _serve_traffic()[1]:
        cfg = get_config(run.arch)
        if cfg.family != "ssm":
            cases += [(b, s, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.window or None,
                       torch.bfloat16, f"{run.arch} wave") for b, s in _served_waves(run.arch)]
    b, s, hq, hkv, d, w, _, what = cases[0]
    cases.append((b, s, hq, hkv, d, w, torch.float32, what))
    cases += [(b, s, 40, 8, 128, None, dt, "extra") for b, s, dt in (
        (4, 256, torch.bfloat16), (4, 256, torch.float32), (4, 200, torch.bfloat16),
        (4, 200, torch.float32), (1, 4096, torch.bfloat16))]
    rg = get_config("recurrentgemma-9b")
    rg_heads = (rg.num_heads, rg.num_kv_heads, rg.head_dim)
    cases += [(1, 4096, *rg_heads, rg.window, torch.bfloat16, "recurrentgemma-9b [train]")]
    cases += [(4, 200, *rg_heads, 64, dt, "recurrentgemma heads, band active, ragged")
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(b, MESH_TRAIN_S, hq, hkv, 128, None, torch.bfloat16,
               f"{MESH_TRAIN_ARCH} [train-mesh] {what}") for b, hq, hkv, what in _train_mesh_cases()]
    cases += [(b, SERVE_MESH_S, hq, hkv, 128, None, torch.bfloat16,
               f"{MESH_TRAIN_ARCH} [serve-mesh] {what}") for b, hq, hkv, what in _serve_mesh_cases()]
    cases += [(b, s, hq, hkv, d, w, torch.bfloat16, what)
              for b, s, hq, hkv, d, w, what in _rec_k3_cases()]
    cases += [(b, s, hq, hkv, d, None, torch.bfloat16, what)
              for b, s, hq, hkv, d, what in _moe_k3_cases()]
    return _by_shape(cases)


def _band_mask(s: int, window: int | None, device) -> torch.Tensor:
    """The [S, S] bool mask of causal attention (with its window), True
    where a query sees a key: scaled_dot_product_attention's attn_mask."""
    from repro_torch.kernels.ref import attention_mask

    return attention_mask(s, True, window, device)


def _tallied(fn, tally: dict, key):
    """``fn`` counting its calls by ``key(*args)`` into ``tally``; the
    kernels' own counters stay the record of their launches."""

    def tallied(*args, **kwargs):
        k = key(*args)
        tally[k] = tally.get(k, 0) + 1
        return fn(*args, **kwargs)

    return tallied


def _k5_general(x, scale, eps: float = 1e-6):
    """K5's general kernel (the route every shape took before the resident
    one existed) at a shape the wrapper sends to the resident route:
    called through its C entry, so the two are timed in one run; not a
    launch of the main path."""
    from repro_torch.kernels import _build

    out = torch.empty_like(x)
    lib = _build.load("rms_norm")
    rc = lib.atlas_rms_norm(_build.ptr(x), _build.ptr(scale), _build.ptr(out), x.shape[0],
                            x.shape[1], eps, int(x.dtype == torch.bfloat16),
                            16 // x.element_size(), _build.stream_handle(x.device))
    _build.check(rc, lib, "rms_norm")
    return out


def _k4_cuda_core(x, a, b, c, chunk: int, heads_per_bc: int):
    """K4's CUDA-core kernel (the route every shape took before the
    tensor-core one existed) on bf16 inputs the wrapper sends to the
    tensor cores, through its C entry: the same-run comparison; not a
    launch of the main path."""
    from repro_torch.kernels import _build

    bh, s, p = x.shape
    y = torch.empty_like(x)
    lib = _build.load("ssd_chunk")
    rc = lib.atlas_ssd_chunk(_build.ptr(x), _build.ptr(a), _build.ptr(b), _build.ptr(c),
                             _build.ptr(y), None, bh, s, p, b.shape[-1], chunk, heads_per_bc,
                             int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
    _build.check(rc, lib, "ssd_chunk")
    return y


def phase_k5() -> dict:
    """K5 at every case of ``_k5_shapes``; returns the {"kernels"} entries
    of each route's first case."""
    import torch.nn.functional as F

    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels.ref import rms_norm_ref
    from repro_torch.kernels.rms_norm import rms_norm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    entries = {}
    log(f"[K5] timing floor: an empty kernel (torch.cuda._sleep(0)) times "
        f"{median_ms(lambda: torch.cuda._sleep(0)):.4f}ms between the events")
    for n, d, what, dtype in _k5_shapes():
        x = (torch.randn((n, d), generator=gen, device=dev)).to(dtype)
        scale = (torch.randn((d,), generator=gen, device=dev) * 0.1).to(dtype)
        route = rn.route(dtype, d)
        counter = rn.route_launches[route]
        before = counter.value
        got = rms_norm(x, scale)
        assert counter.value == before + 1, f"K5 did not take its {route} route"
        err = _check("K5", got, rms_norm_ref(x, scale), K5_TOL[dtype])
        assert torch.equal(got, rms_norm(x, scale)), "K5 is not bitwise repeatable"
        w1 = 1.0 + scale
        t_kernel = median_ms(lambda: rms_norm(x, scale))
        t_plain = median_ms(lambda: rms_norm_ref(x, scale))
        t_lib = median_ms(lambda: F.rms_norm(x, (d,), w1, 1e-6))
        was = ""
        if route == "resident":
            _check("K5 general", _k5_general(x, scale), rms_norm_ref(x, scale), K5_TOL[dtype])
            was = f" general={median_ms(lambda: _k5_general(x, scale)):.4f}ms"
        nbytes, _, (b_ms, b_by) = _bound("rms_norm", (x, scale, got))
        log(f"[K5] [{n},{d}] {what} {str(dtype)[6:]} route={route}: max|kernel-plain|={err:.3g} "
            f"bitwise-repeat=ok kernel={t_kernel:.4f}ms{was} plain={t_plain:.4f}ms "
            f"F.rms_norm={t_lib:.4f}ms "
            f"bound={b_ms:.4f}ms ({b_by}, {nbytes} B) -> "
            f"{nbytes / t_kernel / 1e6:.0f} GB/s")
        # the first case of each route gives its {"kernels"} entry: "rms_norm"
        # (resident) and "rms_norm_general" (the general kernel, at musicgen's 1536)
        key = "rms_norm" if route == "resident" else "rms_norm_general"
        if key not in entries:
            entries[key] = dict(name=key, route="cuda",
                                source="src/repro_torch/csrc/rms_norm.cu",
                                replaces="src/repro/kernels/rms_norm.py:20 (_rms_kernel)",
                                shape=f"[{n},{d}] {str(dtype)[6:]}",
                                cores=route, max_abs_err=err, ms=t_kernel, kernel_ms=t_kernel,
                                plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                                library_ms=t_lib)
    return entries


def _k3_cuda_core(q, k, v, window: int | None):
    """K3's CUDA-core forward (the route recurrentgemma's bf16 calls took
    before the tensor-core one took a window and head dim 256) on inputs
    the wrapper sends to the tensor cores, through its C entry: the
    same-run comparison; not a launch of the main path."""
    from repro_torch.kernels import _build

    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    rc = lib.atlas_flash_attention(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                                   None, b * hq, s, d, hq // k.shape[1], 1.0 / d**0.5, 1,
                                   window or 0, int(q.dtype == torch.bfloat16),
                                   _build.stream_handle(q.device))
    _build.check(rc, lib, "flash_attention")
    return out


def _rg_route(dtype: torch.dtype) -> str:
    """The route recurrentgemma's K3 calls (head dim 256, a window) must
    take: bf16 on the tensor cores, f32 on the CUDA cores."""
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def phase_k3() -> dict:
    """K3 at every case of ``_k3_cases``; returns the {"kernels"} entries
    of the first case (causal, head dim 128) and of the first windowed
    case at head dim 256 (recurrentgemma's served wave)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    entries = {}
    for b, s, hq, hkv, d, window, dtype, what in _k3_cases():
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
                   for h in (hq, hkv, hkv))
        route = fa.route(dtype, d, window=window)
        if d == 256 or window is not None:
            assert route == _rg_route(dtype), f"K3 at D={d} window={window} took {route}"
        counter = fa.route_launches[route]
        before = counter.value
        got = flash_attention(q, k, v, True, window=window)
        assert counter.value == before + 1, f"K3 did not take its {route} route"
        plain = flash_attention_ref(q, k, v, True, window)
        err = _check("K3", got, plain, K3_TOL[dtype])
        assert torch.equal(got, flash_attention(q, k, v, True, window=window)), \
            "K3 is not bitwise repeatable"
        if window is not None and window >= s:  # causal attention, bit for bit
            assert torch.equal(got, flash_attention(q, k, v, True)), "window >= S changed K3's bits"
        t_was, was = None, ""
        if route == "tensor_core" and (d == 256 or window is not None):
            _check("K3 cuda-core", _k3_cuda_core(q, k, v, window), plain, K3_TOL[dtype])
            t_was = median_ms(lambda: _k3_cuda_core(q, k, v, window), reps=5)
            was = f" cuda_core={t_was:.4f}ms"
        del plain
        t_kernel = median_ms(lambda: flash_attention(q, k, v, True, window=window))
        t_plain = median_ms(lambda: flash_attention_ref(q, k, v, True, window), reps=5)
        if window is None:
            t_lib = median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        else:
            band = _band_mask(s, window, dev)
            t_lib = median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True))
        # QKᵀ and PV inside the band
        nbytes, flops, (b_ms, b_by) = _bound("flash_attention", (q, k, v, got), causal=True,
                                             window=window)
        log(f"[K3] B={b} Hq={hq} Hkv={hkv} S={s} D={d} window={window} {str(dtype)[6:]} ({what}) "
            f"route={route}: max|kernel-plain|={err:.3g} bitwise-repeat=ok kernel={t_kernel:.4f}ms"
            f"{was} plain={t_plain:.4f}ms sdpa{'' if window is None else '-banded'}={t_lib:.4f}ms "
            f"bound={b_ms:.4f}ms ({b_by}) -> {flops / t_kernel / 1e9:.1f} TFLOP/s")
        key = "flash_attention" if window is None else "flash_attention_windowed"
        if key not in entries and (window is None or d == 256):
            entries[key] = dict(
                name=key, route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:25 (_flash_kernel)"
                         + ("" if window is None else "; the window is the reference's jnp "
                            "src/repro/models/layers.py:86 (blockwise_attention(window=))"),
                shape=f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} window={window} {str(dtype)[6:]}",
                cores=route, max_abs_err=err, ms=t_kernel, kernel_ms=t_kernel, plain_ms=t_plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=t_lib)
            if t_was is not None:
                entries[key]["cuda_core_ms"] = t_was
        del q, k, v, got
        torch.cuda.empty_cache()
    return entries


def _k4_cases() -> list[tuple[int, int, int, torch.dtype, str]]:
    """(B, S, heads, dtype, what) of K4's checks at mamba2-2.7b's P, N and
    chunk, B/C shared by a sequence's heads: the served wave in both
    dtypes (bf16 first: the reported one), one long prompt whose 16
    chunks exercise the state pass, [train]'s, then [train-mesh-rec]'s and
    [serve-mesh-rec]'s (80 heads on one device, 40 on a model position)."""
    (wb, ws), = _served_waves("mamba2-2.7b")
    h = _mamba_scan_dims()[0]
    cases = [(wb, ws, h, torch.bfloat16, "lm-serve wave"), (wb, ws, h, torch.float32, "lm-serve wave"),
             (1, 4096, h, torch.bfloat16, "long prompt"),
             (TRAIN_B, TRAIN_S, h, torch.bfloat16, "[train]")]
    return _by_shape(cases + [(b, s, hh, torch.bfloat16, what)
                              for b, s, hh, what in _rec_k4_cases()])


def phase_k4() -> dict:
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_chunk import ssd_scan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    _, p, n, chunk = _mamba_scan_dims()
    entry = None
    for b, s, h, dtype, what in _k4_cases():
        x = torch.randn((b * h, s, p), generator=gen, device=dev).to(dtype)
        a = torch.rand((b * h, s), generator=gen, device=dev) * 0.3 + 0.7
        bm = (torch.randn((b, s, n), generator=gen, device=dev) * 0.3).to(dtype)
        cm = (torch.randn((b, s, n), generator=gen, device=dev) * 0.3).to(dtype)
        route = sc.route(dtype, p, n, chunk)
        counter = sc.route_launches[route]
        before = counter.value
        run = lambda: ssd_scan(x, a, bm, cm, chunk, heads_per_bc=h)  # noqa: E731
        got = run()
        assert counter.value == before + 1, f"K4 did not take its {route} route"
        err = _check("K4", got, ssd_scan_ref(x, a, bm, cm, chunk, h), K4_TOL[dtype])
        assert torch.equal(got, run()), "K4 is not bitwise repeatable"
        # the final state the prefill hands to the decode cache
        y_st, st = ssd_scan(x, a, bm, cm, chunk, heads_per_bc=h, return_state=True)
        _, st_ref = ssd_scan_ref(x, a, bm, cm, chunk, h, return_state=True)
        st_err = _check("K4 state", st, st_ref, K4_TOL[torch.float32])
        assert torch.equal(y_st, got), "K4's output changed when it also wrote its state"
        t_kernel = median_ms(run)
        # the prefill's call: y and the final state
        t_state = median_ms(lambda: ssd_scan(x, a, bm, cm, chunk, heads_per_bc=h,
                                             return_state=True))
        t_plain = median_ms(lambda: ssd_scan_ref(x, a, bm, cm, chunk, h), reps=5)
        was = ""
        if route == "tensor_core":
            _check("K4 cuda-core", _k4_cuda_core(x, a, bm, cm, chunk, h),
                   ssd_scan_ref(x, a, bm, cm, chunk, h), K4_TOL[dtype])
            t_was = median_ms(lambda: _k4_cuda_core(x, a, bm, cm, chunk, h), reps=5)
            was = f" cuda_core={t_was:.4f}ms"
            # the three launches' device times (torch.profiler)
            passes = {e.key.split("(")[0].split("<")[0].removeprefix("void "):
                      e.self_device_time_total / e.count / 1e3 for e in _device_kernels(run, 10)}
            was += " passes: " + ", ".join(f"{k} {v:.4f}ms" for k, v in passes.items())
        nbytes, flops, (b_ms, b_by) = _bound("ssd_scan", (x, a, bm, cm, got), chunk=chunk,
                                             heads_per_bc=h)
        log(f"[K4] BH={b}x{h} S={s} P={p} N={n} chunk={chunk} heads_per_bc={h} "
            f"{str(dtype)[6:]} ({what}) route={route}: "
            f"max|kernel-plain|={err:.3g} (final state {st_err:.3g}) bitwise-repeat=ok "
            f"kernel={t_kernel:.4f}ms (with the final state {t_state:.4f}ms){was} "
            f"plain={t_plain:.4f}ms bound={b_ms:.4f}ms ({b_by}; {nbytes} B, {flops} flop) -> "
            f"{flops / t_kernel / 1e9:.1f} TFLOP/s")
        if entry is None:
            entry = dict(name="ssd_chunk", route="cuda",
                         source="src/repro_torch/csrc/ssd_chunk.cu",
                         replaces="src/repro/kernels/ssd_chunk.py:28 (_ssd_kernel)",
                         cores=route, max_abs_err=err, ms=t_kernel, kernel_ms=t_kernel,
                         plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del x, a, bm, cm, got, y_st, st
    return entry


def _k6_cases() -> list[tuple[tuple[int, int, int], str]]:
    """((B, S, R), what) of K6's checks: recurrentgemma's served prefill
    waves and its [train] sequences."""
    from repro_torch.configs import get_config

    r = get_config("recurrentgemma-9b").d_rnn
    cases = [((b, s, r), "recurrentgemma-9b lm-serve wave")
             for b, s in _served_waves("recurrentgemma-9b")]
    cases += [((b, s, r), f"{arch} [train]") for arch, _, b, s in TRAIN_RUNS
              if arch == "recurrentgemma-9b"]
    return _by_shape(cases + _rec_k6_cases())


def _k6_sequential(lib):
    """The sequential kernels K6 replaced (one thread per channel walking
    S; no path launches them), as (forward, backward) callables that
    allocate their outputs like the wrappers."""
    from repro_torch.kernels import _build

    ptr, opt = _build.ptr, (lambda t: None if t is None else _build.ptr(t))

    def fwd(a, w, h0):
        h = torch.empty_like(a)
        _build.check(lib.atlas_rglru_scan_loop(ptr(a), ptr(w), opt(h0), ptr(h), *a.shape,
                                               _build.stream_handle(a.device)), lib, "rglru_scan")
        return h

    def bwd(a, h, dh, h0):
        da, dw = torch.empty_like(a), torch.empty_like(a)
        dh0 = None if h0 is None else torch.empty_like(h0)
        _build.check(lib.atlas_rglru_scan_bwd_loop(ptr(a), ptr(h), ptr(dh), opt(h0), ptr(da),
                                                   ptr(dw), opt(dh0), *a.shape,
                                                   _build.stream_handle(a.device)),
                     lib, "rglru_scan")
        return da, dw, dh0

    return fwd, bwd


def _max_err(got, want) -> tuple[float, float]:
    """max |got - want| and that over max |want|, over the non-None pairs."""
    pairs = [(g, x) for g, x in zip(got, want) if g is not None]
    err = max(float((g - x).abs().max()) for g, x in pairs)
    return err, err / max(float(x.abs().max()) for _, x in pairs)


K6_CHUNKS = (32, 64, 128)  # the chunk lengths the [K6] phase times beside CHUNK


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one float past a
    16-byte boundary (K6 then copies 4 bytes at a time)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def phase_k6() -> dict:
    """K6 (the RG-LRU scan, a chunked scan across blocks) and its backward
    at every case of ``_k6_cases``, with and without a carried state h0:
    bitwise the chunked plain versions (``CHUNK``) and themselves, within
    f32 rounding of the sequential loop (1e-6 of its largest magnitude;
    the error printed); the sequential kernels they replaced bitwise the
    loop.  Median times of the kernels, the plain versions and the
    sequential kernels on the same inputs, each kernel's GB/s and bound;
    without h0 also both kernels at each chunk length of ``K6_CHUNKS``
    (bitwise their plain versions at that length): the measurement behind
    ``CHUNK``.  Returns the {"kernels"} entries of the first case without
    h0 (the prefill's call)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as k6
    from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref

    seq_fwd, seq_bwd = _k6_sequential(_build.load("rglru_scan"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    entries = {}
    log(f"[K6] CHUNK={k6.CHUNK} (the chunk length of the kernels and their plain versions)")
    for (b, s, r), what in _k6_cases():
        # the 4-byte copies and the chunk sweep once per shape of lm-serve and [train]; the
        # split steps' shapes only as their path runs them
        full = any("-mesh-rec]" not in use for use in what.split(" / "))
        a = torch.rand((b, s, r), generator=gen, device=dev) * 0.95 + 0.04
        w, dh = (torch.randn((b, s, r), generator=gen, device=dev) for _ in range(2))
        for h0 in (None, torch.randn((b, r), generator=gen, device=dev)):
            before, before_bwd = k6.launches.value, k6.bwd_launches.value
            h = k6.rglru_scan(a, w, h0)
            assert k6.launches.value == before + 1, "K6 did not count its launch"
            plain = rglru_scan_ref(a, w, h0)
            torch.cuda.synchronize()
            assert torch.isfinite(h).all() and torch.equal(h, plain), \
                "K6 differs from the chunked plain version"
            assert torch.equal(h, k6.rglru_scan(a, w, h0)), "K6 is not bitwise repeatable"
            grads = k6.rglru_scan_bwd(a, h, dh, h0)
            assert k6.bwd_launches.value == before_bwd + 1, "K6 bwd did not count its launch"
            want = rglru_scan_bwd_ref(a, h, dh, h0)
            again = k6.rglru_scan_bwd(a, h, dh, h0)
            for name, g, x, y in zip(("da", "dw", "dh0"), grads, want, again):
                assert (g is None) == (x is None) == (y is None) == (name == "dh0" and h0 is None)
                if g is not None:
                    assert torch.equal(g, x), f"K6 bwd {name} differs from the chunked plain version"
                    assert torch.equal(g, y), f"K6 bwd {name} is not bitwise repeatable"
            err_plain = max(_max_err((h,), (plain,))[0], _max_err(grads, want)[0])
            # the sequential loop: the chunks join by carries, another order of the same sums
            loop = rglru_scan_ref(a, w, h0, chunk=None)
            loop_grads = rglru_scan_bwd_ref(a, h, dh, h0, chunk=None)
            fwd_err, fwd_rel = _max_err((h,), (loop,))
            bwd_err, bwd_rel = _max_err(grads, loop_grads)
            assert fwd_rel <= 1e-6 and bwd_rel <= 1e-6, (fwd_rel, bwd_rel)
            assert torch.equal(seq_fwd(a, w, h0), loop), "the sequential kernel is not the loop"
            for g, x in zip(seq_bwd(a, h, dh, h0), loop_grads):
                assert (g is None and x is None) or torch.equal(g, x), \
                    "the sequential backward kernel is not the loop"
            del plain, want, again, loop, loop_grads
            t_fwd = median_ms(lambda: k6.rglru_scan(a, w, h0))
            t_bwd = median_ms(lambda: k6.rglru_scan_bwd(a, h, dh, h0))
            t_fwd_seq = median_ms(lambda: seq_fwd(a, w, h0))
            t_bwd_seq = median_ms(lambda: seq_bwd(a, h, dh, h0))
            t_fwd_plain = median_ms(lambda: rglru_scan_ref(a, w, h0), reps=3, warmup=1)
            t_bwd_plain = median_ms(lambda: rglru_scan_bwd_ref(a, h, dh, h0), reps=3, warmup=1)
            state = () if h0 is None else (h0,)
            # a, w read, h written (and h0 read); a, h, dh read, da, dw written (and h0, dh0)
            fwd_bytes, _, (fb_ms, fb_by) = _bound("rglru_scan", (a, w, *state, h),
                                                  chunk=k6.CHUNK)
            bwd_bytes, _, (bb_ms, bb_by) = _bound("rglru_scan_bwd", (
                a, h, dh, *state, *(g for g in grads if g is not None)), chunk=k6.CHUNK)
            log(f"[K6] B={b} S={s} R={r} h0={'yes' if h0 is not None else 'no'} ({what}) "
                f"chunk={k6.CHUNK}: forward and backward bitwise the chunked plain versions and "
                f"themselves; against the sequential loop max abs err fwd {fwd_err:.3g} "
                f"(rel {fwd_rel:.3g}) bwd {bwd_err:.3g} (rel {bwd_rel:.3g}); "
                f"fwd kernel={t_fwd:.4f}ms ({fwd_bytes / t_fwd / 1e6:.0f} GB/s) "
                f"sequential={t_fwd_seq:.4f}ms plain={t_fwd_plain:.4f}ms bound={fb_ms:.4f}ms "
                f"({fb_by}); bwd kernel={t_bwd:.4f}ms ({bwd_bytes / t_bwd / 1e6:.0f} GB/s) "
                f"sequential={t_bwd_seq:.4f}ms plain={t_bwd_plain:.4f}ms bound={bb_ms:.4f}ms "
                f"({bb_by})")
            if h0 is None and full:
                # the 4-byte copies: contiguous views one float off 16-byte alignment
                a4, w4, h4, dh4 = (_misaligned(t) for t in (a, w, h, dh))
                assert torch.equal(k6.rglru_scan(a4, w4), h), "K6's 4-byte copies changed the bits"
                for g, x in zip(k6.rglru_scan_bwd(a4, h4, dh4), grads):
                    assert (g is None and x is None) or torch.equal(g, x), \
                        "K6 bwd's 4-byte copies changed the bits"
                t4_fwd = median_ms(lambda: k6.rglru_scan(a4, w4))
                t4_bwd = median_ms(lambda: k6.rglru_scan_bwd(a4, h4, dh4))
                del a4, w4, h4, dh4
                log(f"[K6] B={b} S={s} R={r} 4-byte copies (misaligned views, bitwise the "
                    f"16-byte ones): fwd {t4_fwd:.4f}ms bwd {t4_bwd:.4f}ms, against "
                    f"{t_fwd:.4f}ms and {t_bwd:.4f}ms")
                sweep = []
                for chunk in K6_CHUNKS:
                    got = k6.rglru_scan(a, w, chunk=chunk)
                    assert torch.equal(got, rglru_scan_ref(a, w, chunk=chunk)), chunk
                    got_bwd = k6.rglru_scan_bwd(a, got, dh, chunk=chunk)
                    for g, x in zip(got_bwd, rglru_scan_bwd_ref(a, got, dh, chunk=chunk)):
                        assert (g is None and x is None) or torch.equal(g, x), chunk
                    del got, got_bwd
                    tf = median_ms(lambda: k6.rglru_scan(a, w, chunk=chunk))
                    tb = median_ms(lambda: k6.rglru_scan_bwd(a, h, dh, chunk=chunk))
                    sweep.append(f"chunk={chunk} fwd {tf:.4f}ms bwd {tb:.4f}ms")
                log(f"[K6] B={b} S={s} R={r} chunk lengths (each bitwise its plain version): "
                    + "; ".join(sweep))
            if not entries and h0 is None:
                common = dict(route="cuda", source="src/repro_torch/csrc/rglru_scan.cu",
                              shape=f"B={b} S={s} R={r} f32, no h0", cores="cuda_core",
                              chunk=k6.CHUNK, max_abs_err=err_plain, library_ms=None,
                              library="none: no single PyTorch call computes a linear "
                              "recurrence stably (cumprod/cumsum underflows over long S)")
                entries["rglru_scan"] = dict(
                    name="rglru_scan", replaces="none: port-only; the reference runs "
                    "src/repro/models/rglru.py:64 (rglru_scan) with jax.lax.associative_scan",
                    ms=t_fwd, kernel_ms=t_fwd, plain_ms=t_fwd_plain, bound_ms=fb_ms,
                    bound_by=fb_by, sequential_ms=t_fwd_seq, loop_max_abs_err=fwd_err, **common)
                entries["rglru_scan_bwd"] = dict(
                    name="rglru_scan_bwd", replaces="none: port-only; XLA differentiates "
                    "src/repro/models/rglru.py:64 (rglru_scan)",
                    ms=t_bwd, kernel_ms=t_bwd, plain_ms=t_bwd_plain, bound_ms=bb_ms,
                    bound_by=bb_by, sequential_ms=t_bwd_seq, loop_max_abs_err=bwd_err, **common)
            del h, grads
        del a, w, dh
        torch.cuda.empty_cache()
    return entries


def _prompts(rng, lengths, cfg):
    """One prompt per length from ``rng``: tokens, or ``[n, d_model]`` f32
    rows, standard normal, for a model that takes embeddings."""
    if cfg.input_mode == "tokens":
        return [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lengths]
    return [rng.standard_normal((int(n), cfg.d_model)).astype(np.float32) for n in lengths]


def phase_lm_check() -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    dev = torch.device("cuda")
    # recurrentgemma-9b at S=2304 (window 2048): the band cuts the first keys of
    # the last 256 rows, and the replay's decode reads its ring past the wrap;
    # musicgen-medium and pixtral-12b prefill and replay [B, S, d_model] f32
    # embeddings
    for arch, bsz, s in (("qwen3-14b", 2, 256), ("mamba2-2.7b", 2, 512),
                         ("deepseek-moe-16b", 2, 256), ("recurrentgemma-9b", 1, 2304),
                         ("deepseek-7b", 2, 256), ("musicgen-medium", 2, 256),
                         ("pixtral-12b", 2, 256), ("starcoder2-3b", 2, 256)):
        cfg = dataclasses.replace(get_config(arch), num_layers=4, dtype_name="float32")
        if cfg.family == "moe":
            # drop-free, as the smoke configs: a prefill that drops tokens
            # legitimately differs from a decode that never does
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
        params = lm.init_params(cfg, seed=1, device=dev)
        rng = np.random.default_rng(5)
        if cfg.input_mode == "tokens":
            tokens = rng.integers(0, cfg.vocab_size, (bsz, s)).astype(np.int32)
        else:
            tokens = rng.standard_normal((bsz, s, cfg.d_model)).astype(np.float32)
        tokens = torch.from_numpy(tokens).to(dev)
        t0 = time.perf_counter()
        want, _ = lm.prefill(params, cfg, tokens)
        cache = lm.init_cache(cfg, bsz, s, dev)
        for t in range(s):
            logits, cache = lm.decode_step(params, cfg, cache, tokens[:, t:t + 1])
        torch.cuda.synchronize()
        err = float((logits - want).abs().max())
        log(f"[lm-check] {arch} 4 layers f32 B={bsz} S={s}"
            + ("" if cfg.input_mode == "tokens" else f" embeddings [B, S, {cfg.d_model}]")
            + (f" window {cfg.window}" if cfg.window else "")
            + (f" capacity_factor {cfg.capacity_factor:.4g}" if cfg.family == "moe" else "")
            + f": max|prefill - replay| = {err:.3g} "
            f"(limit {LM_CHECK_TOL:g}; max|logit| {float(want.abs().max()):.3g}) "
            f"in {time.perf_counter() - t0:.2f}s")
        assert torch.isfinite(want).all() and torch.isfinite(logits).all()
        assert err <= LM_CHECK_TOL, f"{arch}: prefill vs replay {err} > {LM_CHECK_TOL}"
        del params, cache
        torch.cuda.empty_cache()


class _LogitsWatch:
    """ServingEngine's ``on_logits`` hook for lm-serve: whether every
    logits tensor of the run is finite (kept on the card, no sync), and
    each wave's prefill logits beside its last replayed ones and the
    number of replay steps (its padded prompt length)."""

    def __init__(self, device) -> None:
        self.finite = torch.ones((), dtype=torch.bool, device=device)
        self.waves: list[list] = []  # [prefill logits, last replay logits, replay steps]

    def __call__(self, stage: str, logits: torch.Tensor) -> None:
        self.finite &= torch.isfinite(logits).all()
        if stage == "prefill":
            self.waves.append([logits, None, 0])
        elif stage == "replay":
            self.waves[-1][1] = logits
            self.waves[-1][2] += 1

    def shapes(self) -> list[tuple[int, int]]:
        return [(p.shape[0], n) for p, _, n in self.waves]

    def gaps(self) -> list[float]:
        return [float((r - p).abs().max()) for p, r, _ in self.waves]


def _left_padded(prompts, device) -> torch.Tensor:
    """The batch ServingEngine prefills for one wave: left-padded with 0
    (tokens, or rows of zeros before embeddings)."""
    s = max(len(p) for p in prompts)
    buf = np.zeros((len(prompts), s, *prompts[0].shape[1:]), prompts[0].dtype)
    for i, p in enumerate(prompts):
        buf[i, s - len(p):] = p
    return torch.from_numpy(buf).to(device)


def _plain_ssd_witness(cfg, params, prompts, watch: _LogitsWatch) -> str:
    """The one-wave mamba run's prefill again, with the plain SSD scan in
    place of K4: if its gap to the replay matches K4's, the gap is the
    model's and not the kernel's."""
    from unittest import mock

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.models import lm

    def plain(x, a, b, c, chunk=256, *, heads_per_bc=1, return_state=False):
        return ssd_scan_ref(x, a, b, c, chunk, heads_per_bc, return_state)

    (pre_k4, replay, _), = watch.waves
    with mock.patch.object(ops, "ssd", plain):
        pre_plain, _ = lm.prefill(params, cfg, _left_padded(prompts, pre_k4.device))
    return (f"max|plain-scan prefill - replay| {float((pre_plain - replay).abs().max()):.3g}, "
            f"max|plain-scan prefill - K4 prefill| {float((pre_plain - pre_k4).abs().max()):.3g}, "
            f"max|replay logit| {float(replay.abs().max()):.3g}")


def phase_lm_serve() -> dict[str, int]:
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ops, rglru_scan, rms_norm, ssd_chunk
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServingEngine

    dev = torch.device("cuda")
    counts = {"flash_attention": flash_attention.launches, "ssd_chunk": ssd_chunk.launches,
              "rms_norm": rms_norm.launches, "rglru_scan": rglru_scan.launches,
              "flash_attention_tc": flash_attention.tensor_core_launches,
              "flash_attention_cuda_core": flash_attention.cuda_core_launches,
              "ssd_chunk_tc": ssd_chunk.tensor_core_launches,
              "rms_norm_resident": rms_norm.resident_launches,
              "rms_norm_general": rms_norm.general_launches}
    total = dict.fromkeys(counts, 0)
    by_arch = {}
    # the shapes the K3, K5 and K6 phases checked (bf16)
    k3_checked = {(b, hq, hkv, s, d) for b, s, hq, hkv, d, _, dt, _ in _k3_cases()
                  if dt == torch.bfloat16}
    k6_checked = {shape for shape, _ in _k6_cases()}
    k5_checked = {(n, d) for n, d, _, dt in _k5_shapes() if dt == torch.bfloat16}
    rng, runs = _serve_traffic()
    for run in runs:
        arch, max_batch, lengths, needed = run.arch, run.max_batch, run.lengths, run.needed
        cfg = get_config(arch)
        published = cfg.num_layers
        if run.layers:
            cfg = dataclasses.replace(cfg, num_layers=run.layers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        pbytes = sum(_nbytes(t) for t in _leaves(params))
        n_params = sum(t.numel() for t in _leaves(params))
        log(f"[lm-serve] {arch}: {cfg.num_layers} of {published} layers d_model={cfg.d_model} "
            f"{cfg.dtype_name}, {n_params} parameters ({pbytes} B), init "
            f"{time.perf_counter() - t0:.2f}s, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B")
        watch = _LogitsWatch(dev)
        engine = ServingEngine(cfg, params, max_batch=max_batch, device=dev, on_logits=watch)
        prompts = _prompts(rng, lengths, cfg)
        for uid, p in enumerate(prompts):
            engine.submit(Request(uid, p, max_tokens=run.max_tokens))
        for c in counts.values():
            c.reset()
        tally: dict[tuple[int, int], int] = {}  # K5 calls by (rows, width)
        k3_tally: dict[tuple, int] = {}  # K3 calls by (B, Hq, Hkv, S, D)
        k6_tally: dict[tuple, int] = {}  # K6 calls by (B, S, R)
        t0 = time.perf_counter()
        with mock.patch.object(ops, "rms_norm_kernel",
                               _tallied(ops.rms_norm_kernel, tally, lambda x, *_: tuple(x.shape))), \
                mock.patch.object(ops, "flash_attention", _tallied(
                    ops.flash_attention, k3_tally,
                    lambda q, k, *_, **__: (q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                                            q.shape[3]))), \
                mock.patch.object(ops, "rglru_scan_kernel", _tallied(
                    ops.rglru_scan_kernel, k6_tally, lambda a, *_: tuple(a.shape))):
            done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.value for k, c in counts.items()}
        st = engine.stats
        new_tokens = sum(len(r.output_tokens) for r in done)
        log(f"[lm-serve] {arch}: prompts {lengths}, {len(done)} requests in "
            f"{st['waves']} waves (B, S) {watch.shapes()}, wall {wall:.3f}s; prefill s/wave "
            f"{[round(t, 4) for t in st['prefill_s']]}, replay s/wave "
            f"{[round(t, 4) for t in st['replay_s']]}, decode {st['decode_s']:.3f}s "
            f"for {new_tokens} tokens ({new_tokens / st['decode_s']:.1f} tok/s); "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; launches {launches}")
        log(f"[lm-serve] {arch}: {cfg.dtype_name} max|prefill - replay| on the last prompt token "
            f"per wave {[f'{x:.3g}' for x in watch.gaps()]} (reported, not checked)")
        log(f"[lm-serve] {arch}: K5 launches by row shape (rows, width) "
            f"{sorted(tally.items(), key=lambda kv: -kv[1])}; K3 launches by shape "
            f"(B, Hq, Hkv, S, D) {sorted(k3_tally.items(), key=lambda kv: -kv[1])}"
            + (f"; K6 launches by shape (B, S, R) {sorted(k6_tally.items())}" if k6_tally else ""))
        assert all(launches[k] > 0 for k in needed), f"{arch}: kernel not on the path: {launches}"
        if cfg.family == "hybrid":
            # per wave's prefill: the windowed K3 (tensor-core route) once per
            # attention layer, K6 once per RG-LRU layer
            n_super = cfg.num_layers // 3
            want = {"flash_attention_tc": n_super * st["waves"],
                    "flash_attention": n_super * st["waves"],
                    "rglru_scan": (cfg.num_layers - n_super) * st["waves"]}
            assert all(launches[k] == n for k, n in want.items()), (launches, want)
            assert sum(k6_tally.values()) == launches["rglru_scan"], (k6_tally, launches)
            assert set(k6_tally) <= k6_checked, \
                f"{arch}: K6 shapes unchecked: {set(k6_tally) - k6_checked}"
        else:
            # one tensor-core attention (qwen3) or SSD scan (mamba) per layer per wave's prefill
            tc_key = "ssd_chunk_tc" if cfg.family == "ssm" else "flash_attention_tc"
            want_tc = cfg.num_layers * st["waves"]
            assert launches[tc_key] == want_tc, \
                f"{arch}: {tc_key} launches {launches[tc_key]} != {want_tc}"
            if cfg.family != "ssm":
                assert launches["flash_attention"] == want_tc, \
                    f"{arch}: K3 launches off the tensor cores: {launches}"
        # every K5 launch on the route rms_norm.route names for its width: resident
        # at every served width but musicgen's 1536 and starcoder2's 3072
        want_k5 = {"rms_norm_resident": 0, "rms_norm_general": 0}
        for (_, w), n in tally.items():
            want_k5[f"rms_norm_{rms_norm.route(cfg.dtype, w)}"] += n
        general = {w for _, w in tally if rms_norm.route(cfg.dtype, w) == "general"}
        assert general <= set(K5_GENERAL_WIDTHS), f"{arch}: K5 widths on the general route: {general}"
        assert launches["rms_norm"] == sum(tally.values()), \
            f"{arch}: K5 launches {launches} vs {sum(tally.values())} calls"
        assert launches["flash_attention"] == sum(k3_tally.values()), \
            f"{arch}: K3 launches {launches} vs {sum(k3_tally.values())} calls"
        assert all(launches[k] == n for k, n in want_k5.items()), \
            f"{arch}: K5 launches by route {launches} against the rule's {want_k5}"
        assert len(done) == len(lengths) and all(r.done for r in done)
        assert all(1 <= len(r.output_tokens) <= run.max_tokens for r in done), \
            "token counts out of range"
        assert bool(watch.finite), f"{arch}: non-finite logits"
        # the K3/K4/K5 phases checked the kernels at these wave shapes
        assert watch.shapes() == _served_waves(arch), (watch.shapes(), _served_waves(arch))
        assert set(tally) <= k5_checked, f"{arch}: K5 shapes unchecked: {set(tally) - k5_checked}"
        assert set(k3_tally) <= k3_checked, \
            f"{arch}: K3 shapes unchecked: {set(k3_tally) - k3_checked}"
        if cfg.family == "ssm":
            log(f"[lm-serve] {arch}: witness, {_plain_ssd_witness(cfg, params, prompts, watch)}")
        log(f"[lm-serve] {arch}: first wave's prefill again, "
            f"{_prefill_split(cfg, params, prompts[:max_batch])}")
        was = (f" (PERF.md section 5's: wall {DECODE_STEP_MS[arch]} ms)"
               if arch in DECODE_STEP_MS else "")
        log(f"[lm-serve] {arch}: one decode step at batch {max_batch}, position "
            f"{max(lengths)}: {_decode_step_split(cfg, params, max_batch, max(lengths))}{was}")
        for k in total:
            total[k] += launches[k]
        by_arch[arch] = launches
        del engine, params, watch
        torch.cuda.empty_cache()
    return {"total": total, "by_arch": by_arch}


# [train]'s runs, each at its published width, with its depth (None: the
# published one): qwen3-14b cut to 4 of 40 layers (40 would hold ~14.8 B
# params x 12 B of state, ~178 GB); mamba2-2.7b at its 64 layers (2.83 B
# params, 54 GB at peak); deepseek-moe-16b cut to 4 of 28 (its dense first
# layer and 3 MoE layers, 2.27 B params; 28 would need ~197 GB); each with
# its batch shape: B=2, S=2048, except recurrentgemma-9b's B=1, S=4096 (the
# same tokens a step, and its window of 2048 bands the attention), cut to 5
# of 38 layers (one superblock and the 2-layer RG-LRU tail, 3.10 B params;
# 38 would hold ~9.63 B x 12 B of state, ~116 GB)
# one decode step's wall in PERF.md section 5, before the kernels' meta route
DECODE_STEP_MS = {"qwen3-14b": 82.77, "deepseek-moe-16b": 95.26, "recurrentgemma-9b": 54.56}
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 2, 2048, 5, 1e-3
TRAIN_RUNS = (("qwen3-14b", 4, TRAIN_B, TRAIN_S), ("mamba2-2.7b", None, TRAIN_B, TRAIN_S),
              ("deepseek-moe-16b", 4, TRAIN_B, TRAIN_S), ("recurrentgemma-9b", 5, 1, 4096))
K3_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# [train-mesh]: qwen2-7b at its published width (d_model 3584, 28/4 heads of
# 128, d_ff 18944, vocab 152064, QKV bias) cut to 2 of 28 layers (28 would
# hold ~7.6 B params x 12 B of state, ~91 GB, before the mesh's copies; 2, not
# 4, keeps the smoke's wall: the checkpoint of the state is most of the phase),
# bf16 parameters, f32 moments, remat, one fixed global batch of B=4, S=1024;
# the (4, 2) mesh and the (2, 2) one it resumes on, over cuda:0 repeated;
# the pipeline: its 2 blocks over 2 stages, 4 microbatches of B=1
MESH_TRAIN_ARCH, MESH_TRAIN_LAYERS, MESH_TRAIN_B, MESH_TRAIN_S = "qwen2-7b", 2, 4, 1024
MESH_TRAIN_MESHES = ((4, 2), (2, 2))
MESH_TRAIN_TOL = 2e-2  # ROADMAP's bf16 bar
MESH_RESUME_TOL = 1e-4  # the reference elastic check's bar on the step-3 loss
PIPE_STAGES, PIPE_MICRO = 2, 4
# [serve-mesh]: [train-mesh]'s qwen2-7b cut, bf16, served by the sharded
# serving step on (1, 2) and (2, 2) over cuda:0 repeated: a global batch of
# 4 prompts of 504 tokens (not a multiple of K3's 64-row tile), then 16
# decode steps from length 504 in a cache of 1024 slots, teacher-forced by
# the one-device step's greedy tokens: at 504-511 model position 1's block
# of 512 slots holds no valid key yet, at 512-519 the new keys land in it
SERVE_MESH_MESHES = ((1, 2), (2, 2))
SERVE_MESH_B, SERVE_MESH_S, SERVE_MESH_MAX, SERVE_MESH_STEPS = 4, 504, 1024, 16
SERVE_MESH_TOL = 2e-2  # ROADMAP's bf16 bar
# [train-mesh-rec] and [serve-mesh-rec]: the ssm and hybrid families split over
# model (Mamba-2 by heads, RG-LRU by channels, the hybrid's local attention by
# sequence, its MLPs by columns) at their published widths on (1, 2) and (2, 2)
# over cuda:0 repeated, bf16; mamba2-2.7b cut to 4 of 64 layers, recurrentgemma-9b
# to 5 of 38 (one superblock and the 2-layer RG-LRU tail, as [train] cuts it)
REC_MESHES = ((1, 2), (2, 2))
# (arch, layers, B, S, moment dtype) of [train-mesh-rec].  recurrentgemma at B=1,
# S=4096: model position 1's 2048 queries see keys from 1 (the window of 2048 cuts
# its block); B=2 would hold ~48 GB of activations in one shard beside the state,
# and bf16 moments keep the sharded state (19 GB), its f32 gradient blocks (12.7
# GB) and one shard's views and activations inside the card's 80 GB.  At B=1 the
# (2, 2) mesh does not split the batch: its one row runs on data shard 0, with
# the parameters still gathered from both data shards' blocks
REC_TRAIN_RUNS = (("mamba2-2.7b", 4, 4, 1024, "float32"),
                  ("recurrentgemma-9b", 5, 1, 4096, "bfloat16"))
# (arch, layers, B, prompt, max_len) of [serve-mesh-rec], then 16 decode steps
# teacher-forced by the one-device step: recurrentgemma's ring of 2048 slots
# (1024 a position) fills at 2047 and wraps from position 1's block into
# position 0's at 2048
REC_SERVE_RUNS = (("mamba2-2.7b", 4, 4, 512, 1024), ("recurrentgemma-9b", 5, 2, 2040, 4096))
REC_SERVE_STEPS = 16


def _rec_cfg(arch: str, layers: int):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=layers)


def _rec_shards(b: int) -> list[tuple[str, int, int]]:
    """(what, rows, model positions) of each run of a batch of ``b`` rows
    in [train-mesh-rec] / [serve-mesh-rec]: one device, then each mesh's
    data shard (the whole batch where it does not split over data)."""
    return [("one device", b, 1)] + [(f"({d}, {m}) shard", b // d if b % d == 0 else b, m)
                                     for d, m in REC_MESHES]


def _rec_k3_cases() -> list[tuple[int, int, int, int, int, int, str]]:
    """(B, S, Hq, Hkv, D, window, what) of the hybrid's attention calls in
    [train-mesh-rec] (``train``) and [serve-mesh-rec]'s prefill (``serve``):
    one device's whole sequence, then each model position's block of
    query rows from the window's first key (or 0) to the block's end."""
    out = []
    for kind, runs in (("train", REC_TRAIN_RUNS), ("serve", REC_SERVE_RUNS)):
        for arch, layers, b, s, *_ in runs:
            cfg = _rec_cfg(arch, layers)
            if cfg.family != "hybrid":
                continue
            for what, rows, tp in _rec_shards(b):
                w = s // tp
                for m in range(tp):
                    n = (m + 1) * w - max(0, m * w - cfg.window + 1)
                    out.append((rows, n, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                cfg.window, f"{arch} [{kind}-mesh-rec] {what}"))
    return out


def _rec_k4_cases() -> list[tuple[int, int, int, str]]:
    """(B, S, heads, what) of mamba's SSD scans in [train-mesh-rec] and
    [serve-mesh-rec]'s prefill: 80 heads on one device, 80/tp on a model
    position, B/C shared by the position's heads."""
    out = []
    for kind, runs in (("train", REC_TRAIN_RUNS), ("serve", REC_SERVE_RUNS)):
        for arch, layers, b, s, *_ in runs:
            cfg = _rec_cfg(arch, layers)
            if cfg.family == "ssm":
                h = 2 * cfg.d_model // cfg.ssm_head_dim
                out += [(rows, s, h // tp, f"{arch} [{kind}-mesh-rec] {what}")
                        for what, rows, tp in _rec_shards(b)]
    return out


def _rec_k5_rows(kind: str) -> list[tuple[int, int, str, torch.dtype]]:
    """(rows, width, what, dtype) of K5's calls (bf16) in [train-mesh-rec]
    (``kind`` "train": each run's token rows) or [serve-mesh-rec] ("serve":
    each prefill's and each decode step's): the hidden rows of every run,
    and mamba's inner rows on one device (a split position's gated norm
    combines over model without K5)."""
    out = []
    for arch, layers, b, s, *_ in (REC_TRAIN_RUNS if kind == "train" else REC_SERVE_RUNS):
        cfg = _rec_cfg(arch, layers)
        for what, rows, tp in _rec_shards(b):
            for tokens, step in ((rows * s, "rows"),) + (((rows, "decode rows"),)
                                                         if kind == "serve" else ()):
                out.append((tokens, cfg.d_model, f"{arch} [{kind}-mesh-rec] {what} {step}",
                            torch.bfloat16))
                if cfg.family == "ssm" and tp == 1:
                    out.append((tokens, 2 * cfg.d_model,
                                f"{arch} [{kind}-mesh-rec] {what} inner {step}", torch.bfloat16))
    return out


def _rec_k6_cases() -> list[tuple[tuple[int, int, int], str]]:
    """((B, S, R), what) of the RG-LRU scans in [train-mesh-rec] and
    [serve-mesh-rec]'s prefill: R channels on one device, R/tp on a model
    position."""
    out = []
    for kind, runs in (("train", REC_TRAIN_RUNS), ("serve", REC_SERVE_RUNS)):
        for arch, layers, b, s, *_ in runs:
            cfg = _rec_cfg(arch, layers)
            if cfg.family == "hybrid":
                out += [((rows, s, cfg.d_rnn // tp), f"{arch} [{kind}-mesh-rec] {what}")
                        for what, rows, tp in _rec_shards(b)]
    return out


def _train_mesh_cases() -> list[tuple[int, int, int, str]]:
    """(B, Hq, Hkv, what) of [train-mesh]'s attention calls at S=1024: the
    one-device step's, each mesh's data shard's on one model position's
    heads, and the pipeline's microbatch."""
    from repro_torch.configs import get_config

    cfg = get_config(MESH_TRAIN_ARCH)
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    return ([(MESH_TRAIN_B, hq, hkv, "one device")]
            + [(MESH_TRAIN_B // d, hq // m, hkv // m, f"({d}, {m}) shard")
               for d, m in MESH_TRAIN_MESHES]
            + [(MESH_TRAIN_B // PIPE_MICRO, hq, hkv, "pipeline microbatch")])


def _serve_mesh_cases() -> list[tuple[int, int, int, str]]:
    """(B, Hq, Hkv, what) of [serve-mesh]'s prefill attention calls at
    S=504: the one-device step's and each mesh's data shard's on one model
    position's heads."""
    from repro_torch.configs import get_config

    cfg = get_config(MESH_TRAIN_ARCH)
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    return ([(SERVE_MESH_B, hq, hkv, "one device")]
            + [(SERVE_MESH_B // d, hq // m, hkv // m, f"({d}, {m}) shard")
               for d, m in SERVE_MESH_MESHES])


def _serve_mesh_rows() -> list[tuple[int, int, str, torch.dtype]]:
    """(rows, width, what, dtype) of [serve-mesh]'s K5 calls (bf16): each
    prefill's B·S rows and each decode step's B."""
    from repro_torch.configs import get_config

    d = get_config(MESH_TRAIN_ARCH).d_model
    return [(b * s, d, f"{MESH_TRAIN_ARCH} [serve-mesh] {what} {kind} rows", torch.bfloat16)
            for b, _, _, what in _serve_mesh_cases()
            for s, kind in ((SERVE_MESH_S, "prefill"), (1, "decode"))]


def _train_mesh_rows() -> list[tuple[int, int, str, torch.dtype]]:
    """(rows, width, what, dtype) of [train-mesh]'s K5 calls (bf16)."""
    from repro_torch.configs import get_config

    d = get_config(MESH_TRAIN_ARCH).d_model
    return [(b * MESH_TRAIN_S, d, f"{MESH_TRAIN_ARCH} [train-mesh] {what} rows", torch.bfloat16)
            for b, _, _, what in _train_mesh_cases()]


# [train-mesh-moe] and [serve-mesh-moe]: the moe family split over model (each
# position its E/tp experts, the routing once at a data shard's first position),
# its attention by heads and its MLPs (deepseek's leading dense block and shared
# experts, arctic's dense residual) by columns, at published width on cuda:0
# repeated, bf16.  deepseek-moe-16b cut to 4 of 28 layers (1 dense, 3 moe: 2.27 B
# parameters, a state of ~22.7 GB with f32 moments), trained at [train-mesh]'s
# B=4, S=1024 on (1, 2) and (2, 2) and served with [serve-mesh]'s traffic on both;
# arctic-480b cut to 1 of 35 layers as [lm-serve] (14.07 B parameters) served on
# (1, 2) with 2 prompts: its one-device parameters (28.1 GB) and their sharded
# copy fit side by side, two meshes' copies would not
MOE_MESHES = ((1, 2), (2, 2))
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "deepseek-moe-16b", 4
MOE_SERVE_RUNS = (("deepseek-moe-16b", 4, 4, MOE_MESHES), ("arctic-480b", 1, 2, ((1, 2),)))
MOE_LAYER_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}  # (a): one block's FFN alone
MOE_STEP_F32_TOL = 1e-4  # (b'): the whole step in f32, its routing the one device's


def _moe_shards(b: int, meshes) -> list[tuple[str, int, int]]:
    """(what, rows, model positions) of each run of a batch of ``b`` rows
    in [train-mesh-moe] / [serve-mesh-moe]: one device, then each mesh's
    data shard."""
    return [("one device", b, 1)] + [(f"({d}, {m}) shard", b // d, m) for d, m in meshes]


def _moe_k3_cases() -> list[tuple[int, int, int, int, int, str]]:
    """(B, S, Hq, Hkv, D, what) of the attention calls of [train-mesh-moe]
    (S=1024) and [serve-mesh-moe]'s prefills (S=504): one device's heads,
    then each data shard's on one model position's Hq/tp and Hkv/tp."""
    out = []
    runs = [("train", MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MESH_TRAIN_B, MESH_TRAIN_S, MOE_MESHES)]
    runs += [("serve", arch, layers, b, SERVE_MESH_S, meshes)
             for arch, layers, b, meshes in MOE_SERVE_RUNS]
    for kind, arch, layers, b, s, meshes in runs:
        cfg = _rec_cfg(arch, layers)
        out += [(rows, s, cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim,
                 f"{arch} [{kind}-mesh-moe] {what}") for what, rows, tp in _moe_shards(b, meshes)]
    return out


def _moe_k5_rows(kind: str) -> list[tuple[int, int, str, torch.dtype]]:
    """(rows, width, what, dtype) of K5's calls (bf16, the hidden rows) in
    [train-mesh-moe] (``kind`` "train": each run's token rows) or
    [serve-mesh-moe] ("serve": each prefill's and each decode step's)."""
    out = []
    if kind == "train":
        d = _rec_cfg(MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS).d_model
        return [(rows * MESH_TRAIN_S, d, f"{MOE_TRAIN_ARCH} [train-mesh-moe] {what} rows",
                 torch.bfloat16) for what, rows, _ in _moe_shards(MESH_TRAIN_B, MOE_MESHES)]
    for arch, layers, b, meshes in MOE_SERVE_RUNS:
        d = _rec_cfg(arch, layers).d_model
        for what, rows, _ in _moe_shards(b, meshes):
            out += [(rows * SERVE_MESH_S, d, f"{arch} [serve-mesh-moe] {what} prefill rows",
                     torch.bfloat16),
                    (rows, d, f"{arch} [serve-mesh-moe] {what} decode rows", torch.bfloat16)]
    return out


def _max_rel(name: str, got, plain, tol: float) -> float:
    """max|got - plain| within ``tol`` of max|plain|: for sums over many
    rows of terms of either sign (K5's dscale), where an elementwise
    relative bar would hold a cancelled sum to its own rounding."""
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all(), f"{name}: non-finite output"
    err = float((got.float() - plain.float()).abs().max())
    assert err <= tol * float(plain.float().abs().max()), f"{name}: {err} above {tol} of max"
    return err


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name without namespaces, template
    arguments, parameters or return type."""
    return key.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0].split()[-1] \
        .split("::")[-1]


def _passes(fn, reps: int = 10) -> str:
    """Each device kernel's mean time per launch over ``reps`` calls of
    ``fn`` (torch.profiler), with ``xN`` where a call launches it N times."""
    return ", ".join(
        f"{_kernel_name(e.key)} {e.self_device_time_total / e.count / 1e3:.4f}ms"
        + (f" x{round(e.count / reps)}" if round(e.count / reps) > 1 else "")
        for e in _device_kernels(fn, reps)
    ) or "not measured (no device time in the trace)"


def _library_bwd_ms(fn, inputs, dout) -> float:
    """Device time of the backward of one library call (autograd through
    ``fn``), the forward done once outside the timed window."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return median_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))


def _k5_bwd_general(x, scale, dy, eps: float = 1e-6):
    """K5's general backward (the route every shape took before the
    resident one existed) on inputs the wrapper sends to the resident
    route, through its C entry: the same-run comparison; not a launch of
    the main path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rms_norm as rn

    n, d = x.shape
    rows = 8 if d <= 1024 else 1
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(-(-n // rows), rn._BLOCKS_PER_SM * sms)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    lib = _build.load("rms_norm")
    rc = lib.atlas_rms_norm_bwd(*(_build.ptr(t) for t in (x, scale, dy, dx, dscale, partial)),
                                n, d, blocks, eps, int(x.dtype == torch.bfloat16),
                                16 // x.element_size(), _build.stream_handle(x.device))
    _build.check(rc, lib, "rms_norm")
    return dx, dscale


def _k5_bwd_cases() -> list[tuple[int, int, str, torch.dtype]]:
    """(rows, width, what, dtype) of K5's backward checks: every shape
    [train] normalises (bf16, B·S token rows of each of TRAIN_RUNS: qwen3's
    hidden rows and q-/k-norm, mamba's hidden and inner rows, deepseek-moe's
    and recurrentgemma's hidden rows), then qwen3's hidden rows and k-norm
    in f32, [train-mesh]'s rows (bf16) and its one-device rows in f32, and
    arctic's width at [train]'s 4,096 rows in bf16 and f32 (no path trains
    it)."""
    from repro_torch.configs import get_config

    shapes = [(n, d, f"{arch} {w}", torch.bfloat16) for arch, _, b, s in TRAIN_RUNS
              for n, d, w in _norm_rows(get_config(arch), b * s)]
    tokens = TRAIN_B * TRAIN_S
    q = get_config("qwen3-14b")
    shapes += [(tokens, q.d_model, "qwen3 rows", torch.float32),
               (tokens * q.num_kv_heads, q.head_dim, "qwen3 k-norm", torch.float32),
               (MESH_TRAIN_B * MESH_TRAIN_S, get_config(MESH_TRAIN_ARCH).d_model,
                f"{MESH_TRAIN_ARCH} [train-mesh] one device rows", torch.float32)]
    shapes += [(tokens, get_config("arctic-480b").d_model, "arctic-480b width", dt)
               for dt in (torch.bfloat16, torch.float32)]
    return _merged(shapes + _train_mesh_rows() + _rec_k5_rows("train") + _moe_k5_rows("train"))


def phase_k5_bwd() -> dict:
    """K5's backward at every shape of [train] (``_k5_bwd_cases``), each
    case on its route beside the general kernel on the same inputs where it
    is resident, and K5's forward at the same inputs against its plain
    version (the forward [train] runs there)."""
    import torch.nn.functional as F

    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels.ref import rms_norm_bwd_ref, rms_norm_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    entry = None
    for n, d, what, dtype in _k5_bwd_cases():
        x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        scale = (0.1 * torch.randn((d,), generator=gen, device=dev)).to(dtype)
        dy = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        _check("K5 fwd", rn.rms_norm(x, scale), rms_norm_ref(x, scale), K5_TOL[dtype])
        route = rn.bwd_route(x, scale, dy)
        counter = rn.bwd_route_launches[route]
        before, before_route = rn.bwd_launches.value, counter.value
        dx, ds = rn.rms_norm_bwd(x, scale, dy)
        assert rn.bwd_launches.value == before + 1, "K5 bwd did not count its launch"
        assert counter.value == before_route + 1, f"K5 bwd did not take its {route} route"
        want = rms_norm_bwd_ref(x, scale, dy)
        err_dx = _check("K5 bwd dx", dx, want[0], K5_TOL[dtype])
        err_ds = _max_rel("K5 bwd dscale", ds, want[1], K5_TOL[dtype])
        err = max(err_dx, err_ds)
        again = rn.rms_norm_bwd(x, scale, dy)
        assert torch.equal(again[0], dx) and torch.equal(again[1], ds), "K5 bwd not bitwise repeatable"
        t_kernel = median_ms(lambda: rn.rms_norm_bwd(x, scale, dy))
        t_plain = median_ms(lambda: rms_norm_bwd_ref(x, scale, dy))
        w1 = (1.0 + scale.float()).to(dtype)
        t_lib = _library_bwd_ms(lambda a, w: F.rms_norm(a, (d,), w, 1e-6), (x, w1), dy)
        was = ""
        if route == "resident":
            old = _k5_bwd_general(x, scale, dy)
            _check("K5 bwd general dx", old[0], want[0], K5_TOL[dtype])
            _max_rel("K5 bwd general dscale", old[1], want[1], K5_TOL[dtype])
            was = f" general={median_ms(lambda: _k5_bwd_general(x, scale, dy)):.4f}ms"
            was += " passes: " + _passes(lambda: rn.rms_norm_bwd(x, scale, dy))
            del old
        nbytes, _, (b_ms, b_by) = _bound("rms_norm_bwd", (x, scale, dy, dx, ds))
        log(f"[K5-bwd] [{n},{d}] {what} {str(dtype)[6:]} route={route}: max|kernel-plain| "
            f"dx={err_dx:.3g} dscale={err_ds:.3g} (max|dscale| "
            f"{float(want[1].float().abs().max()):.4g}) "
            f"bitwise-repeat=ok kernel={t_kernel:.4f}ms{was} plain={t_plain:.4f}ms "
            f"F.rms_norm-bwd={t_lib:.4f}ms bound={b_ms:.4f}ms ({b_by}, {nbytes} B) -> "
            f"{nbytes / t_kernel / 1e6:.0f} GB/s")
        if entry is None:
            entry = dict(name="rms_norm_bwd", route="cuda",
                         source="src/repro_torch/csrc/rms_norm.cu",
                         replaces="none: no Pallas backward; the reference differentiates "
                                  "src/repro/models/layers.py:40 (rms_norm) with XLA",
                         shape=f"[{n},{d}] {str(dtype)[6:]}", cores=route, max_abs_err=err,
                         ms=t_kernel,
                         kernel_ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=t_lib)
        del x, scale, dy, dx, ds, want, again
    return entry


def _k3_bwd_cuda_core(q, k, v, out, lse, do, window: int | None = None, causal: bool = True):
    """K3's CUDA-core backward (the route every shape took before the
    tensor-core one existed, and recurrentgemma's windowed head dim 256
    until it took those) on bf16 inputs the wrapper sends to the tensor
    cores, through its launcher: the same-run comparison; not a launch of
    the main path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    b, hq, s, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dims = (b * hq, s, d, hq // k.shape[1], 1.0 / d**0.5, int(causal))
    rc = fa._bwd_cuda_core(q, k, v, out, lse, do, dq, dk, dv, dims, window or 0)
    _build.check(rc, _build.load("flash_attention"), "flash_attention")
    return dq, dk, dv


def _k3_bwd_cases() -> list[tuple[int, int, int, int, int, int | None, torch.dtype, str]]:
    """(B, S, Hq, Hkv, D, window, dtype, what) of K3's backward checks:
    [train]'s shape of each attention model of TRAIN_RUNS in bf16 (qwen3's
    40/8 and deepseek-moe's 16/16 at head dim 128, recurrentgemma's 16/1 at
    256 with its window, also in f32), then f32 and a ragged bf16 case at
    small S."""
    from repro_torch.configs import get_config

    cases = []
    for arch, _, b, s in TRAIN_RUNS:
        cfg = get_config(arch)
        if cfg.family == "ssm":
            continue
        dtypes = (torch.bfloat16, torch.float32) if cfg.window else (torch.bfloat16,)
        cases += [(b, s, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.window or None, dt,
                   f"{arch} [train]") for dt in dtypes]
    cases += [(1, s, 40, 8, 128, None, dt, "extra") for s, dt in (
        (256, torch.float32), (200, torch.bfloat16), (200, torch.float32))]
    cases += [(b, MESH_TRAIN_S, hq, hkv, 128, None, torch.bfloat16,
               f"{MESH_TRAIN_ARCH} [train-mesh] {what}") for b, hq, hkv, what in _train_mesh_cases()]
    cases += [(b, s, hq, hkv, d, w, torch.bfloat16, what)
              for b, s, hq, hkv, d, w, what in _rec_k3_cases() if "[train-mesh-rec]" in what]
    cases += [(b, s, hq, hkv, d, None, torch.bfloat16, what)
              for b, s, hq, hkv, d, what in _moe_k3_cases() if "[train-mesh-moe]" in what]
    return _by_shape(cases)


def phase_k3_bwd() -> dict:
    """K3's backward at every case of ``_k3_bwd_cases`` (lse from the
    forward; at [train]'s bf16 shapes, head dim 128 and recurrentgemma's
    windowed 256, the tensor-core backward, beside the CUDA-core one on
    the same inputs); the forward
    with lse must equal the forward without it bitwise on both routes and
    its plain version within K3's bar (the forward [train] runs).  Returns
    the {"kernels"} entries of the first case and of the first windowed one."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                                         flash_attention_ref)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    entries = {}
    for b, s, hq, hkv, d, window, dtype, what in _k3_bwd_cases():
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
                       for h in (hq, hkv, hkv, hq))
        lse = torch.empty((b * hq, s), dtype=torch.float32, device=dev)
        out = fa.flash_attention(q, k, v, True, lse=lse, window=window)
        assert torch.equal(out, fa.flash_attention(q, k, v, True, window=window)), \
            "lse changed K3's output"
        _check("K3 fwd", out, flash_attention_ref(q, k, v, True, window), K3_TOL[dtype])
        _check("K3 lse", lse, flash_attention_lse_ref(q, k, True, window), 1e-5)
        route = fa.bwd_route(q, k, v, out, do, window)
        if d == 256 or window is not None:
            assert route == _rg_route(dtype), f"K3 bwd at D={d} window={window} took {route}"
        counter = fa.bwd_route_launches[route]
        before, before_route = fa.bwd_launches.value, counter.value
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, True, window)
        assert fa.bwd_launches.value == before + 1, "K3 bwd did not count its launch"
        assert counter.value == before_route + 1, f"K3 bwd did not take its {route} route"
        want = flash_attention_bwd_ref(q, k, v, out, do, True, window)
        err = max(_check(f"K3 bwd {n}", g, w, K3_BWD_TOL[dtype])
                  for n, g, w in zip(("dq", "dk", "dv"), got, want))
        t_was, was = None, ""
        if route == "tensor_core":
            old = _k3_bwd_cuda_core(q, k, v, out, lse, do, window)
            for n, g, w in zip(("dq", "dk", "dv"), old, want):
                _check(f"K3 bwd cuda-core {n}", g, w, K3_BWD_TOL[dtype])
            del old
            t_was = median_ms(lambda: _k3_bwd_cuda_core(q, k, v, out, lse, do, window), reps=5)
            was = f" cuda_core={t_was:.4f}ms"
        passes = _passes(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, True, window))
        del want
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, True, window)
        assert all(torch.equal(a, g) for a, g in zip(again, got)), "K3 bwd not bitwise repeatable"
        del again
        if window is not None and route == "tensor_core":
            # a window of S or more is causal attention, bit for bit, forward and backward
            wide, lse2 = s + 1, torch.empty_like(lse)
            o2 = fa.flash_attention(q, k, v, True, lse=lse2, window=wide)
            assert torch.equal(o2, fa.flash_attention(q, k, v, True)), "window >= S changed K3"
            g2 = fa.flash_attention_bwd(q, k, v, o2, lse2, do, True, wide)
            g3 = fa.flash_attention_bwd(q, k, v, o2, lse2, do, True)
            assert all(torch.equal(a, c) for a, c in zip(g2, g3)), "window >= S changed K3 bwd"
            del o2, lse2, g2, g3
        t_kernel = median_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, True, window),
                             reps=10 if d == 256 else 25)
        t_plain = median_ms(lambda: flash_attention_bwd_ref(q, k, v, out, do, True, window),
                            reps=5)
        if window is None:
            t_lib = _library_bwd_ms(
                lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                                                enable_gqa=True), (q, k, v), do)
        else:
            band = _band_mask(s, window, dev)
            t_lib = _library_bwd_ms(
                lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, attn_mask=band,
                                                                enable_gqa=True), (q, k, v), do)
        # five products inside the band: S recomputed, dP, dV, dQ, dK
        nbytes, flops, (b_ms, b_by) = _bound("flash_attention_bwd", (q, k, v, out, do, lse, *got),
                                             causal=True, window=window)
        log(f"[K3-bwd] B={b} Hq={hq} Hkv={hkv} S={s} D={d} window={window} {str(dtype)[6:]} "
            f"({what}) route={route} (forward route {fa.route(dtype, d, window=window)}): "
            f"max|kernel-plain|={err:.3g} bitwise-repeat=ok lse-keeps-forward-bitwise=ok "
            f"kernel={t_kernel:.4f}ms{was} passes: {passes} plain={t_plain:.4f}ms "
            f"sdpa{'' if window is None else '-banded'}-bwd={t_lib:.4f}ms bound={b_ms:.4f}ms "
            f"({b_by}) -> {flops / t_kernel / 1e9:.1f} TFLOP/s")
        key = "flash_attention_bwd" if window is None else "flash_attention_windowed_bwd"
        if key not in entries:
            entries[key] = dict(
                name=key, route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
                replaces="none: no Pallas backward; the reference differentiates "
                         "src/repro/models/layers.py:86 (blockwise_attention"
                         + ("" if window is None else "(window=)") + ") with XLA",
                shape=f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} window={window} {str(dtype)[6:]}",
                cores=route, max_abs_err=err, ms=t_kernel, kernel_ms=t_kernel, plain_ms=t_plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=t_lib)
            if t_was is not None:
                entries[key]["cuda_core_ms"] = t_was
        del q, k, v, do, out, lse, got
        torch.cuda.empty_cache()
    return entries


def _mamba_scan_dims() -> tuple[int, int, int, int]:
    """(heads, P, N, chunk) of mamba2-2.7b's SSD scan."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-2.7b")
    return 2 * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssd_chunk


def _k4_bwd_cuda_core(x, a, b, c, dy, chunk: int, heads_per_bc: int):
    """K4's CUDA-core backward (the route every shape took before the
    tensor-core one existed) on bf16 inputs the wrapper sends to the tensor
    cores, through its C entry: the same-run comparison; not a launch of
    the main path."""
    from repro_torch.kernels import _build

    bh, s, p = x.shape
    n, nc = b.shape[-1], s // chunk
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    da = torch.empty((bh, s), dtype=torch.float32, device=x.device)
    states = torch.empty((2, bh, nc, p, n), dtype=torch.float32, device=x.device)
    partials = torch.empty((2, bh, s, n), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_chunk")
    rc = lib.atlas_ssd_chunk_bwd(
        *(_build.ptr(t) for t in (x, a, b, c, dy, dx, da, db, dc, states[0], states[1],
                                  partials[0], partials[1])),
        bh, s, p, n, chunk, heads_per_bc, int(x.dtype == torch.bfloat16),
        _build.stream_handle(x.device))
    _build.check(rc, lib, "ssd_chunk")
    return dx, da, db, dc


def _k4_bwd_cases() -> list[tuple[int, int, int, int, torch.dtype, tuple[float, float], str]]:
    """(B, S, heads, heads_per_bc, dtype, decays in [lo, hi), what) of K4's
    backward checks, each over B·heads sequences at mamba2-2.7b's widths:
    [train]'s, then [train-mesh-rec]'s (80 heads on one device, 40 on a
    model position)."""
    h, _, _, chunk = _mamba_scan_dims()
    cases = [
        (TRAIN_B, TRAIN_S, h, h, torch.bfloat16, (0.7, 1.0), "[train]'s shape"),
        (TRAIN_B, TRAIN_S, h, h, torch.float32, (0.7, 1.0), "[train]'s shape"),
        (TRAIN_B, chunk, h, 1, torch.float32, (0.7, 1.0), "one chunk, a b/c row per sequence"),
        (TRAIN_B, TRAIN_S, h, h, torch.bfloat16, (0.995, 1.0), "decays near 1"),
        (TRAIN_B, TRAIN_S, h, h, torch.bfloat16, (0.05, 0.06), "decays near 0.05"),
    ]
    return _by_shape(cases + [(b, s, hh, hh, torch.bfloat16, (0.7, 1.0), what)
                              for b, s, hh, what in _rec_k4_cases() if "[train-mesh-rec]" in what])


def phase_k4_bwd() -> dict:
    """K4's backward (ssd_scan_bwd) at [train]'s mamba2-2.7b shape (BH=2·80,
    S=2048, P=64, N=128, chunk 256, b/c shared by the 80 heads) in bf16 (the
    reported case) and f32, decays near 1 and near 0.05 in bf16, and one
    chunk with a b/c row per sequence in f32; dx, da, db, dc vs the plain
    backward, each within the bar of its largest magnitude (db and dc sum
    80 heads, da is a reverse cumsum of terms of either sign), and bitwise
    vs itself."""
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.ref import ssd_scan_bwd_ref

    _, p, n, chunk = _mamba_scan_dims()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    entry = None
    for bsz, s, h, hpb, dtype, (lo, hi), what in _k4_bwd_cases():
        bh = bsz * h
        x = torch.randn((bh, s, p), generator=gen, device=dev).to(dtype)
        a = torch.rand((bh, s), generator=gen, device=dev) * (hi - lo) + lo
        bm, cm = ((torch.randn((bh // hpb, s, n), generator=gen, device=dev) * 0.3).to(dtype)
                  for _ in range(2))
        dy = torch.randn((bh, s, p), generator=gen, device=dev).to(dtype)
        route = sc.bwd_route(dtype, p, n, chunk)
        counter = sc.bwd_route_launches[route]
        before, before_route = sc.bwd_launches.value, counter.value
        run = lambda: sc.ssd_scan_bwd(x, a, bm, cm, dy, chunk, heads_per_bc=hpb)  # noqa: E731
        got = run()
        assert sc.bwd_launches.value == before + 1, "K4 bwd did not count its launch"
        assert counter.value == before_route + 1, f"K4 bwd did not take its {route} route"
        want = ssd_scan_bwd_ref(x, a, bm, cm, dy, chunk, hpb)
        errs = {name: _max_rel(f"K4 bwd {name}", g, w, K4_TOL[dtype])
                for name, g, w in zip(("dx", "da", "db", "dc"), got, want)}
        again = run()
        assert all(torch.equal(g, r) for g, r in zip(got, again)), "K4 bwd not bitwise repeatable"
        t_kernel = median_ms(run)
        t_plain = median_ms(lambda: ssd_scan_bwd_ref(x, a, bm, cm, dy, chunk, hpb), reps=3)
        was = ""
        if route == "tensor_core" and entry is None:  # the reported case: the old route beside it
            old = _k4_bwd_cuda_core(x, a, bm, cm, dy, chunk, hpb)
            for name, g, w in zip(("dx", "da", "db", "dc"), old, want):
                _max_rel(f"K4 bwd cuda_core {name}", g, w, K4_TOL[dtype])
            t_was = median_ms(lambda: _k4_bwd_cuda_core(x, a, bm, cm, dy, chunk, hpb), reps=5)
            was = f" cuda_core={t_was:.4f}ms"
            del old
        # five products on and below the diagonal (C Bᵀ, dY Xᵀ, dX, dB, dC), three
        # with the state (B dSᵀ, X dS, dY S_in) and the two state recurrences
        nbytes, flops, (b_ms, b_by) = _bound("ssd_scan_bwd", (x, a, bm, cm, dy, *got),
                                             chunk=chunk, heads_per_bc=hpb)
        mags = ", ".join(f"{k} {float(w.float().abs().max()):.4g}"
                         for k, w in zip(("dx", "da", "db", "dc"), want))
        passes = f" passes: {_passes(run)}" if entry is None else ""
        log(f"[K4-bwd] BH={bsz}x{h} S={s} P={p} N={n} chunk={chunk} heads_per_bc={hpb} "
            f"{str(dtype)[6:]} decays [{lo}, {hi}) ({what}) route={route}: max|kernel-plain| "
            + ", ".join(f"{k}={v:.3g}" for k, v in errs.items()) + f" (max| |: {mags}) "
            f"bitwise-repeat=ok kernel={t_kernel:.4f}ms{passes}{was} plain={t_plain:.4f}ms "
            f"bound={b_ms:.4f}ms ({b_by}; {nbytes} B, {flops} flop) -> "
            f"{flops / t_kernel / 1e9:.1f} TFLOP/s")
        if entry is None:
            entry = dict(name="ssd_chunk_bwd", route="cuda",
                         source="src/repro_torch/csrc/ssd_chunk.cu",
                         replaces="none: no Pallas backward; the reference differentiates "
                                  "src/repro/models/mamba.py:52 (ssd_chunked) with XLA",
                         shape=f"BH={bsz}x{h} S={s} P={p} N={n} chunk={chunk} "
                               f"{str(dtype)[6:]}",
                         cores=route, max_abs_err=max(errs.values()), ms=t_kernel,
                         kernel_ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None)
        del x, a, bm, cm, dy, got, want, again
        torch.cuda.empty_cache()
    return entry


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_train_check(workdir: str) -> None:
    """The smoke configs of qwen3-14b, mamba2-2.7b, deepseek-moe-16b and
    recurrentgemma-9b in f32: three train steps on the card against the
    same three on the CPU from one init_train_state, then a checkpoint
    after step 2 restored and stepped: bitwise step 3; then a step under
    torch.use_deterministic_algorithms must flag no op."""
    for arch in ("qwen3-14b", "mamba2-2.7b", "deepseek-moe-16b", "recurrentgemma-9b"):
        _train_check(arch, os.path.join(workdir, arch))


def _train_check(arch: str, ckpt: str) -> None:
    import warnings

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves
    from repro_torch.train.step import init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = get_smoke_config(arch)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    host = init_train_state(cfg, AdamWConfig(lr=1e-3), seed=0, device="cpu")
    card = _to_device(host, dev)
    batches = [make_global_batch(0, i, 2, 64, cfg.vocab_size, device="cpu") for i in range(3)]
    losses = []
    for batch in batches:
        host, hm = step(host, batch)
        card, cm = step(card, _to_device(batch, dev))
        losses.append((float(cm["loss"]), float(hm["loss"])))
    loss_err = max(abs(a - b) for a, b in losses)
    param_err = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(tree_leaves(card["params"]), tree_leaves(host["params"])))
    log(f"[train-check] {cfg.name} f32, 3 steps card vs cpu: losses {losses}, "
        f"max|loss diff| {loss_err:.3g}, max|param diff| {param_err:.3g} (bar 1e-5)")
    assert loss_err <= 1e-5 * max(abs(a) for a, _ in losses), losses
    assert param_err <= 1e-5, param_err

    state = _to_device(init_train_state(cfg, AdamWConfig(lr=1e-3), seed=0, device="cpu"), dev)
    batch = _to_device(batches[0], dev)
    mgr = CheckpointManager(ckpt, async_save=False)
    for _ in range(2):
        state, _ = step(state, batch)
    mgr.save(2, state)
    state, _ = step(state, batch)
    restored, at = mgr.restore(state, device=dev)
    assert at == 2
    restored, _ = step(restored, batch)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(state)))
    assert same, f"{cfg.name}: resumed step 3 differs from the uninterrupted step 3"
    # which ops of the step PyTorch itself calls nondeterministic (warn only)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(restored, batch)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split("\n")[0][:160] for w in caught
                      if "determinis" in str(w.message)})
    log(f"[train-check] {cfg.name}: resume after step 2 -> step 3 bitwise equal to the "
        f"uninterrupted step 3 (params, moments, step); ops PyTorch flags as nondeterministic "
        f"in a step: {flagged or 'none'}")
    assert not flagged, f"{cfg.name}: nondeterministic ops in a train step: {flagged}"


def phase_train() -> dict:
    """Each of TRAIN_RUNS, bf16 parameters and f32 moments: TRAIN_STEPS
    AdamW steps on one fixed batch through make_train_step.  Each run sets
    the kernels' counts to 0 before its steps and reads them after; the
    phase's ``launches`` are the sum of the runs' (qwen3-14b + mamba2-2.7b
    + deepseek-moe-16b + recurrentgemma-9b), ``by_model`` each run's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as k6
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import ssd_chunk as sc

    counters = {"flash_attention": fa.launches,
                "flash_attention_tensor_core": fa.tensor_core_launches,
                "flash_attention_bwd": fa.bwd_launches,
                "flash_attention_bwd_tensor_core": fa.bwd_tensor_core_launches,
                "flash_attention_bwd_cuda_core": fa.bwd_cuda_core_launches,
                "rms_norm": rn.launches, "rms_norm_resident": rn.resident_launches,
                "rms_norm_bwd": rn.bwd_launches,
                "rms_norm_bwd_resident": rn.bwd_resident_launches,
                "ssd_chunk": sc.launches, "ssd_chunk_tensor_core": sc.tensor_core_launches,
                "ssd_chunk_bwd": sc.bwd_launches,
                "ssd_chunk_bwd_tensor_core": sc.bwd_tensor_core_launches,
                "rglru_scan": k6.launches, "rglru_scan_bwd": k6.bwd_launches}
    runs = {arch: _train_run(arch, layers, b, s, counters) for arch, layers, b, s in TRAIN_RUNS}
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in counters}
    by_model = {k: {arch: r["launches"][k] for arch, r in runs.items()} for k in counters}
    log(f"[train] launches over the phase's steps, summed over its runs: {launches}; "
        f"by model: {by_model}")
    return {"launches": launches, "by_model": by_model, "runs": runs}


def _train_checked() -> dict[str, set]:
    """The backward shapes the K3-, K4- and K5-bwd phases checked, keyed as
    ``_train_run`` tallies the calls of [train]."""
    _, p, n, _ = _mamba_scan_dims()
    return {
        "K3 bwd": {(b, hq, hkv, s, d, dt) for b, s, hq, hkv, d, _, dt, _ in _k3_bwd_cases()},
        "K6 bwd": {shape for shape, _ in _k6_cases()},
        "K4 bwd": {((b * h, s, p), (b * h // hpb, s, n), dt)
                   for b, s, h, hpb, dt, _, _ in _k4_bwd_cases()},
        "K5 bwd": {(rows, d, dt) for rows, d, _, dt in _k5_bwd_cases()},
    }


def _train_run(arch: str, layers, bsz: int, seq: int, counters: dict) -> dict:
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as k6
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves
    from repro_torch.train.step import init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = get_config(arch)
    published = cfg.num_layers
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, opt_cfg, seed=0, device=dev)
    batch = make_global_batch(0, 0, bsz, seq, cfg.vocab_size, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    fields = (("ssm_state", "ssm_head_dim", "ssd_chunk") if cfg.family == "ssm" else
              ("num_heads", "num_kv_heads", "head_dim", "d_ff", "num_experts", "top_k",
               "num_shared_experts", "moe_d_ff", "first_k_dense", "dense_d_ff", "d_rnn",
               "window"))
    widths = {f: getattr(cfg, f) for f in fields if getattr(cfg, f)}
    log(f"[train] {arch} d_model={cfg.d_model} {widths} vocab={cfg.vocab_size}, "
        f"{cfg.num_layers} of {published} layers{' (cut)' if layers else ''}, "
        f"{cfg.dtype_name} params ({n_params} values), f32 moments, remat={cfg.remat}; "
        f"B={bsz} S={seq}, lr {TRAIN_LR}; init {time.perf_counter() - t0:.2f}s")
    step = make_train_step(cfg, opt_cfg)
    # the backward kernels' calls by shape: each must be one its phase checked
    tally = {"K3 bwd": {}, "K4 bwd": {}, "K5 bwd": {}, "K6 bwd": {}}
    tallies = (
        mock.patch.object(fa, "flash_attention_bwd", _tallied(
            fa.flash_attention_bwd, tally["K3 bwd"],
            lambda q, k, *_: (*q.shape[:2], k.shape[1], *q.shape[2:], q.dtype))),
        mock.patch.object(sc, "ssd_scan_bwd", _tallied(
            sc.ssd_scan_bwd, tally["K4 bwd"],
            lambda x, a, b, *_: (tuple(x.shape), tuple(b.shape), x.dtype))),
        mock.patch.object(rn, "rms_norm_bwd", _tallied(
            rn.rms_norm_bwd, tally["K5 bwd"], lambda x, *_: (*x.shape, x.dtype))),
        mock.patch.object(k6, "rglru_scan_bwd", _tallied(
            k6.rglru_scan_bwd, tally["K6 bwd"], lambda a, *_: tuple(a.shape))),
    )
    losses, gnorms, walls, per_step = [], [], [], []
    for c in counters.values():
        c.reset()
    with tallies[0], tallies[1], tallies[2], tallies[3]:
        for _ in range(TRAIN_STEPS):
            before = {k: c.value for k, c in counters.items()}
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            per_step.append({k: c.value - before[k] for k, c in counters.items()})
    launches = {k: c.value for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    tokens = bsz * seq
    wall = float(np.median(walls[1:]))
    log(f"[train] {arch}: losses {losses}; grad norms {gnorms}")
    log(f"[train] {arch}: step wall (host clock, synchronized) {[round(w, 4) for w in walls]} s; "
        f"median of steps 2-{TRAIN_STEPS} {wall:.4f} s -> {tokens / wall:.1f} tokens/s; "
        f"peak device memory (max_memory_allocated) {peak} B; launches per step {per_step[-1]}")
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), (losses, gnorms)
    assert losses[-1] < losses[0], f"{arch}: loss did not fall: {losses}"
    assert all(p["rms_norm_bwd"] > 0 for p in per_step), per_step
    if cfg.family == "ssm":
        # K4's backward once per layer and step, every call and every forward on
        # the tensor cores
        assert all(p["ssd_chunk_bwd"] == cfg.num_layers for p in per_step), per_step
        assert all(p["ssd_chunk_bwd_tensor_core"] == p["ssd_chunk_bwd"] for p in per_step), per_step
        assert all(p["ssd_chunk_tensor_core"] == p["ssd_chunk"] > 0 for p in per_step), per_step
    elif cfg.family == "hybrid":
        # the windowed K3's backward once per attention layer, on the tensor
        # cores; K6's backward once per RG-LRU layer; every step
        n_super = cfg.num_layers // 3
        assert all(p["flash_attention_bwd_tensor_core"] == p["flash_attention_bwd"] == n_super
                   for p in per_step), per_step
        assert all(p["rglru_scan_bwd"] == cfg.num_layers - n_super for p in per_step), per_step
    else:  # every K3 backward call on the tensor cores
        assert all(p["flash_attention_bwd_tensor_core"] == p["flash_attention_bwd"] > 0
                   for p in per_step), per_step
    if cfg.family != "ssm":  # every K3 forward call on the tensor cores
        assert all(p["flash_attention_tensor_core"] == p["flash_attention"] > 0
                   for p in per_step), per_step
    # every K5 call of every trained model, forward and backward, resident
    # (recurrentgemma's 4096 since it took the resident route)
    assert all(p["rms_norm_resident"] == p["rms_norm"] > 0 for p in per_step), per_step
    assert all(p["rms_norm_bwd_resident"] == p["rms_norm_bwd"] > 0 for p in per_step), per_step
    checked = _train_checked()
    log(f"[train] {arch}: backward calls by shape {tally}")
    for k, calls in tally.items():
        assert set(calls) <= checked[k], f"{arch}: {k} shapes unchecked: {set(calls) - checked[k]}"
    assert sum(tally["K3 bwd"].values()) == launches["flash_attention_bwd"], (tally, launches)
    assert sum(tally["K4 bwd"].values()) == launches["ssd_chunk_bwd"], (tally, launches)
    assert sum(tally["K5 bwd"].values()) == launches["rms_norm_bwd"], (tally, launches)
    assert sum(tally["K6 bwd"].values()) == launches["rglru_scan_bwd"], (tally, launches)
    log(f"[train] {arch}: one step under torch.profiler: {_train_step_split(step, state, batch)}")
    state, counted = _counted_step(step, state, batch)
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step[-1], "wall": wall, "peak": peak,
            "cfg": cfg, "opt_cfg": opt_cfg, "batch": _on_meta(batch), "counted": counted}


def _on_meta(tree):
    """``tree``'s tensors as ``meta`` tensors of their shapes and dtypes."""
    return {k: _on_meta(v) if isinstance(v, dict) else torch.empty_like(v, device="meta")
            for k, v in tree.items()}


def _counted_step(step, state, batch) -> tuple:
    """One more call of ``step`` counted live on the card (``_counted``):
    ``(state, {"totals", "peak", "allocated_before"})``."""
    (state, _), counted = _counted(step, state, batch)
    return state, counted


def _sliced(tree, placements):
    """A tree of whole tensors as ``ShardedTensor``s of views: each
    position's block a slice of the one tensor (no copy)."""
    from repro_torch.distributed.sharding import ShardedTensor, tree_map

    def one(t, pl):
        shape = tuple(t.shape)
        return ShardedTensor(pl, shape, [t[pl.block(shape, p)] for p in range(pl.mesh.size)])

    return tree_map(one, tree, placements)


def _blocks_unequal(sharded, whole) -> tuple[int, int]:
    """(blocks compared, blocks not bitwise equal) of every position's
    block of each ``ShardedTensor`` leaf against that region of the
    matching whole tensor."""
    from repro_torch.distributed.sharding import tree_paths

    n = bad = 0
    for (_, st), (_, t) in zip(tree_paths(sharded), tree_paths(whole)):
        for p, block in enumerate(st.blocks):
            n += 1
            bad += not torch.equal(block, t[st.placement.block(st.shape, p)])
    return n, bad


def _state_bytes(state) -> int:
    from repro_torch.distributed.sharding import tree_paths

    return sum(_nbytes(*st.blocks) for _, st in tree_paths(state))


def _run_checks(workdir: str) -> None:
    """(g): the three checks on the card, as processes of their own, side
    by side; each must exit 0 and end with OK."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {"compression_check": ["--devices", "4"],
            "pipeline_check": ["--devices", "4", "--stages", "4"],
            "elastic_check": ["--devices", "8", "--ckpt", os.path.join(workdir, "elastic")]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", f"repro_torch.launch.{name}", *args],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                    env=env, cwd=ROOT) for name, args in runs.items()}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            lines = out.strip().splitlines()
            log(f"[train-mesh] (g) {name} --device cuda {' '.join(runs[name][:2])}: exit "
                f"{proc.returncode} ({time.perf_counter() - t0:.1f}s from the three's start, host "
                f"clock): {' | '.join(lines)}")
            assert proc.returncode == 0 and lines[-1] == "OK", f"{name}: {out}{err}"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_train_mesh(workdir: str) -> dict:
    """qwen2-7b's sharded train step (``distributed.spmd``) on the (4, 2)
    mesh and the (2, 2) one, over cuda:0 repeated, against the one-device
    ``make_train_step``: (a) step 1's loss and every gradient leaf, (b)
    the optimizer bitwise, (c) three free-running losses, (d) the resume
    on (2, 2), (e) K3's head split, (f) the pipeline, (g) the three
    checks.  Every comparison it prints it asserts.  The kernels' counts
    are set to 0 before the sharded steps and read after them."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.distributed.pipeline import make_pipeline_forward, sequential_forward
    from repro_torch.distributed.sharding import tree_map, tree_paths
    from repro_torch.distributed.spmd import (make_sharded_train_step, shard_train_state,
                                              state_shardings)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update, clip_scale, global_norm,
                                             tree_leaves)
    from repro_torch.train.step import (abstract_train_state, init_train_state, loss_and_grads,
                                        make_train_step)

    dev = torch.device("cuda")
    published = get_config(MESH_TRAIN_ARCH)
    cfg = dataclasses.replace(published, num_layers=MESH_TRAIN_LAYERS)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    batch = make_global_batch(0, 0, MESH_TRAIN_B, MESH_TRAIN_S, cfg.vocab_size, device=dev)
    tokens = MESH_TRAIN_B * MESH_TRAIN_S
    meshes = {(d, m): elastic_mesh(d * m, model_parallel=m, devices="cuda:0")
              for d, m in MESH_TRAIN_MESHES}
    log(f"[train-mesh] {MESH_TRAIN_ARCH} d_model={cfg.d_model} heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} of {cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"qkv_bias={cfg.qkv_bias}, {cfg.num_layers} of {published.num_layers} layers (cut), "
        f"{cfg.dtype_name} params, f32 moments, remat={cfg.remat}; global B={MESH_TRAIN_B} "
        f"S={MESH_TRAIN_S}, lr {TRAIN_LR}; meshes {list(meshes)} over cuda:0")
    counters = {"flash_attention": fa.launches, "flash_attention_tensor_core": fa.tensor_core_launches,
                "flash_attention_bwd": fa.bwd_launches,
                "flash_attention_bwd_tensor_core": fa.bwd_tensor_core_launches,
                "rms_norm": rn.launches, "rms_norm_resident": rn.resident_launches,
                "rms_norm_bwd": rn.bwd_launches, "rms_norm_bwd_resident": rn.bwd_resident_launches}
    tally = {"K3": {}, "K3 bwd": {}, "K5": {}, "K5 bwd": {}}
    k3_key = lambda q, k, *_, **__: (*q.shape[:2], k.shape[1], *q.shape[2:], q.dtype)  # noqa: E731
    k5_key = lambda x, *_, **__: (*x.shape, x.dtype)  # noqa: E731
    patches = (mock.patch.object(fa, "flash_attention", _tallied(fa.flash_attention, tally["K3"], k3_key)),
               mock.patch.object(fa, "flash_attention_bwd",
                                 _tallied(fa.flash_attention_bwd, tally["K3 bwd"], k3_key)),
               mock.patch.object(rn, "rms_norm", _tallied(rn.rms_norm, tally["K5"], k5_key)),
               mock.patch.object(rn, "rms_norm_bwd", _tallied(rn.rms_norm_bwd, tally["K5 bwd"], k5_key)))
    checked = {
        "K3": {(b, hq, hkv, s, d, dt) for b, s, hq, hkv, d, w, dt, _ in _k3_cases() if w is None},
        "K3 bwd": {(b, hq, hkv, s, d, dt) for b, s, hq, hkv, d, w, dt, _ in _k3_bwd_cases()
                   if w is None},
        "K5": {(n, d, dt) for n, d, _, dt in _k5_shapes()},
        "K5 bwd": {(n, d, dt) for n, d, _, dt in _k5_bwd_cases()},
    }
    peaks, walls = {}, {}

    with patches[0], patches[1], patches[2], patches[3]:
        # ---- the one-device step: the yardstick ------------------------------
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, opt_cfg, seed=0, device=dev)
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        (loss1, g1), wall = _synced(lambda: loss_and_grads(state["params"], cfg, batch))
        scale1 = clip_scale(opt_cfg, global_norm(g1))
        log(f"[train-mesh] {n_params} parameters; one device, step 1: loss {float(loss1):.6f} "
            f"grad norm {float(global_norm(g1)):.6f} clip scale {float(scale1):.6g}, loss and "
            f"gradients in {wall:.4f} s (host clock, synchronized)")

        # ---- (b) the optimizer: the one-device gradients and scale on (4, 2) --
        mesh = meshes[MESH_TRAIN_MESHES[0]]
        sharded = shard_train_state(state, mesh)
        step42 = make_sharded_train_step(cfg, opt_cfg, mesh, timed=True)
        psh = state_shardings(mesh, state)["params"]
        step42.apply(sharded, _sliced(g1, psh), scale=scale1)
        adamw_update(state["params"], g1, state["opt"], opt_cfg)
        compared = {part: _blocks_unequal(a, b) for part, a, b in (
            ("params", sharded["params"], state["params"]),
            ("m", sharded["opt"]["m"], state["opt"]["m"]), ("v", sharded["opt"]["v"], state["opt"]["v"]),
            ("step", {"step": sharded["opt"]["step"]}, {"step": state["opt"]["step"]}))}
        log(f"[train-mesh] (b) (4, 2) AdamW on the one-device step-1 gradients sliced to the "
            f"placements, with its clip scale, against adamw_update: (blocks, not bitwise equal) "
            f"{compared} (bar: 0 unequal)")
        assert all(bad == 0 for _, bad in compared.values()), compared
        peaks["one device + (4, 2), (b)"] = torch.cuda.max_memory_allocated()
        del sharded

        # ---- (c) the one-device run goes on: steps 2 and 3 ---------------------
        step1 = make_train_step(cfg, opt_cfg)
        one_losses = [float(loss1)]
        for _ in range(2):
            (state, m), wall = _synced(lambda: step1(state, batch))
            one_losses.append(float(m["loss"]))
            walls.setdefault("one device", []).append(wall)
        del state
        torch.cuda.empty_cache()

        # ---- (4, 2): three steps from the same init; (a) at step 1 -------------
        torch.cuda.reset_peak_memory_stats()
        sharded = shard_train_state(init_train_state(cfg, opt_cfg, seed=0, device=dev), mesh)
        torch.cuda.empty_cache()
        state_bytes = {MESH_TRAIN_MESHES[0]: _state_bytes(sharded)}
        one_tally = {k: dict(v) for k, v in tally.items()}
        for c in counters.values():
            c.reset()
        for t in tally.values():
            t.clear()
        splits = []
        (loss, grads), wall = _synced(lambda: step42.loss_and_grads(sharded["params"], batch))
        rel = {}
        for (path, g), ref in zip(tree_paths(grads), tree_leaves(g1)):
            ref = ref.float()
            rel[path] = float((g.full() - ref).norm() / ref.norm())
        worst = max(rel, key=rel.get)
        loss_rel = abs(float(loss) - one_losses[0]) / abs(one_losses[0])
        log(f"[train-mesh] (a) (4, 2) step 1 from the same state against the one-device step: "
            f"loss {float(loss):.6f} vs {one_losses[0]:.6f} (relative {loss_rel:.3g}); "
            f"||dg||/||g|| per gradient leaf {rel}; worst {worst} {rel[worst]:.3g} "
            f"(bar {MESH_TRAIN_TOL})")
        assert loss_rel <= MESH_TRAIN_TOL and rel[worst] <= MESH_TRAIN_TOL, (loss_rel, rel)
        del g1
        split = dict(step42.seconds)
        (_, m), opt_wall = _synced(lambda: step42.apply(sharded, grads))
        split.update(step42.seconds)
        splits.append(split)
        walls.setdefault((4, 2), []).append(wall + opt_wall)
        mesh_losses = [float(loss)]
        del grads
        (sharded, m), wall = _synced(lambda: step42(sharded, batch))
        walls[(4, 2)].append(wall)
        splits.append(dict(step42.seconds))
        mesh_losses.append(float(m["loss"]))
        mgr = CheckpointManager(os.path.join(workdir, "ckpt"), async_save=False)
        _, save_s = _synced(lambda: mgr.save(2, sharded))
        # step 3's loss: the forward and backward at the step-2 state (the
        # update after it is read by nothing)
        (loss, grads), step3_s = _synced(lambda: step42.loss_and_grads(sharded["params"], batch))
        splits.append(dict(step42.seconds))
        mesh_losses.append(float(loss))
        del grads
        peaks[(4, 2)] = torch.cuda.max_memory_allocated()
        rels = [abs(a - b) / abs(b) for a, b in zip(mesh_losses, one_losses)]
        log(f"[train-mesh] (c) free-running losses, steps 1-3: (4, 2) {mesh_losses}, one device "
            f"{one_losses}; relative {rels} (bar {MESH_TRAIN_TOL})")
        assert max(rels) <= MESH_TRAIN_TOL, rels

        # ---- (d) the resume on (2, 2) from the step-2 checkpoint ---------------
        torch.cuda.empty_cache()
        survivors = meshes[MESH_TRAIN_MESHES[1]]
        like = abstract_train_state(cfg, opt_cfg)
        (restored, at), restore_s = _synced(lambda: mgr.restore(like, shardings=state_shardings(
            survivors, like)))
        unequal = n_blocks = 0
        for (path, st), (_, saved) in zip(tree_paths(restored), tree_paths(sharded)):
            full = saved.full()
            for p, block in enumerate(st.blocks):
                n_blocks += 1
                unequal += not torch.equal(block, full[st.placement.block(st.shape, p)])
            del full
        log(f"[train-mesh] (d) checkpoint of the (4, 2) state after step 2: saved in {save_s:.2f} s, "
            f"restored onto (2, 2) through shardings= in {restore_s:.2f} s (host clock); "
            f"{n_blocks} restored blocks against the (4, 2) state's regions, {unequal} not bitwise "
            f"equal (bar 0)")
        assert at == 2 and unequal == 0, (at, unequal)
        del sharded
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state_bytes[MESH_TRAIN_MESHES[1]] = _state_bytes(restored)
        step22 = make_sharded_train_step(cfg, opt_cfg, survivors, timed=True)
        (restored, m), wall = _synced(lambda: step22(restored, batch))
        walls[(2, 2)] = [wall]
        splits.append(dict(step22.seconds))
        launches = {k: c.value for k, c in counters.items()}
        sharded_tally = {k: dict(v) for k, v in tally.items()}
        peaks[(2, 2)] = torch.cuda.max_memory_allocated()
        resumed = float(m["loss"])
        log(f"[train-mesh] (d) step 3: (4, 2) {mesh_losses[2]:.6f}, resumed on (2, 2) "
            f"{resumed:.6f}: |difference| {abs(resumed - mesh_losses[2]):.3g} "
            f"(bar {MESH_RESUME_TOL})")
        assert abs(resumed - mesh_losses[2]) < MESH_RESUME_TOL, (resumed, mesh_losses)
        del restored
        torch.cuda.empty_cache()

    # ---- (e) the heads: K3's calls by shape in the sharded steps ----------------
    local = (cfg.num_heads // MESH_TRAIN_MESHES[0][1], cfg.num_kv_heads // MESH_TRAIN_MESHES[0][1])
    log(f"[train-mesh] (e) the sharded steps' calls by shape {sharded_tally}; launches {launches}")
    for k in ("K3", "K3 bwd"):
        heads = {key[1:3] for key in sharded_tally[k]}
        assert local in heads and all(hq != cfg.num_heads for hq, _ in heads), (k, heads)
    for k in tally:
        calls = set(sharded_tally[k]) | set(one_tally[k])
        assert calls <= checked[k], f"{k} shapes unchecked: {calls - checked[k]}"
    assert sum(sharded_tally["K3"].values()) == launches["flash_attention"], (sharded_tally, launches)
    assert sum(sharded_tally["K3 bwd"].values()) == launches["flash_attention_bwd"]
    assert sum(sharded_tally["K5"].values()) == launches["rms_norm"]
    assert sum(sharded_tally["K5 bwd"].values()) == launches["rms_norm_bwd"]
    assert launches["flash_attention_tensor_core"] == launches["flash_attention"] > 0, launches
    assert launches["flash_attention_bwd_tensor_core"] == launches["flash_attention_bwd"] > 0
    # every K5 launch of every sharded step, forward and backward, at 3584 on the resident route
    assert launches["rms_norm_resident"] == launches["rms_norm"] > 0, launches
    assert launches["rms_norm_bwd_resident"] == launches["rms_norm_bwd"] > 0, launches
    for shape, ws in walls.items():
        log(f"[train-mesh] {shape} step walls (host clock, synchronized) {[round(w, 4) for w in ws]} s "
            f"-> {tokens / ws[-1]:.1f} tokens/s at the last")
    log(f"[train-mesh] (4, 2) step 3's loss and gradients (its update is read by nothing) in "
        f"{step3_s:.4f} s; the sharded steps' split (s; gather / forward_backward / reduce / "
        f"optimizer; (4, 2) steps 1-3, (2, 2) step 3): {splits}")
    log(f"[train-mesh] state held over the positions (B): {state_bytes}; one device "
        f"{n_params * (2 + 4 + 4)} B; peak device memory (max_memory_allocated) by run: {peaks}")

    # ---- (f) the pipeline: its blocks over 2 stages --------------------------------
    params = lm.init_params(cfg, seed=1, device=dev)["blocks"]
    gen = torch.Generator(device=dev).manual_seed(21)
    mb = MESH_TRAIN_B // PIPE_MICRO
    x = torch.randn((PIPE_MICRO, mb, MESH_TRAIN_S, cfg.d_model), generator=gen,
                    device=dev).to(cfg.dtype)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(cfg.dtype)
    positions = torch.arange(MESH_TRAIN_S, device=dev)

    def block(lp, h):
        return lm._dense_block_forward(lp, cfg, h, positions)[0]

    pipe = make_pipeline_forward(make_mesh((PIPE_STAGES,), ("stage",), "cuda:0"), "stage", block)
    out = {}
    for name, fn in (("pipeline", lambda p: pipe(p, x)),
                     ("sequential", lambda p: sequential_forward(p, x, block))):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.enable_grad():
            y = fn(leaves)
            out[name] = (y.detach(), torch.autograd.grad(y, tree_leaves(leaves), dy))
    fwd = float((out["pipeline"][0].float() - out["sequential"][0].float()).abs().max()
                / out["sequential"][0].float().abs().max())
    grad = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
               for a, b in zip(out["pipeline"][1], out["sequential"][1]))
    log(f"[train-mesh] (f) pipeline: {MESH_TRAIN_ARCH} block x {cfg.num_layers} over "
        f"{PIPE_STAGES} stages, {PIPE_MICRO} microbatches of B={mb} S={MESH_TRAIN_S}: "
        f"max|pipe - seq| / max|seq| forward {fwd:.3g}, gradients {grad:.3g} (bar {MESH_TRAIN_TOL})")
    assert fwd <= MESH_TRAIN_TOL and grad <= MESH_TRAIN_TOL, (fwd, grad)
    del params, x, dy, out
    torch.cuda.empty_cache()

    _run_checks(workdir)
    log(f"[train-mesh] card: {smi()}")
    return {"launches": launches, "state_bytes": state_bytes}


def _rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def _synced(fn, collect: bool = False) -> tuple:
    """``(fn(), its wall)`` on the host clock between two synchronizations of
    the card; ``collect`` runs Python's collector first (the last pass's
    cycles), outside the timed window."""
    import gc

    if collect:
        gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _greedy(got: torch.Tensor, want: torch.Tensor, err: float) -> tuple[int, int, int]:
    """The serving phases' rule on one decode step's logits ``[B, V]``: the
    greedy token equals one device's in every row whose one-device top-two
    gap exceeds twice the step's max |d| ``err`` (no error this size can
    flip it); returns (rows agreeing, rows held, rows)."""
    top = want.topk(2, dim=-1).values
    same = got.argmax(-1) == want.argmax(-1)
    clear = (top[:, 0] - top[:, 1]) > 2 * err
    assert bool(same[clear].all()), err
    return int(same.sum()), int(clear.sum()), same.numel()


def _counted(fn, *args) -> tuple:
    """``fn(*args)`` counted live on the card by the dry-run's op counter
    (``hlo_cost.trace_ops``), the peak statistics reset just before it:
    ``(result, {"totals", "peak", "allocated_before"})``."""
    import gc

    from repro_torch.perf import hlo_cost

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    result, records = hlo_cost.trace_ops(fn, *args)
    torch.cuda.synchronize()
    return result, {"totals": hlo_cost.analyze(records), "peak": torch.cuda.max_memory_allocated(),
                    "allocated_before": before}


def phase_serve_mesh() -> dict:
    """qwen2-7b served by the sharded serving step (``distributed.spmd``)
    on the (1, 2) and (2, 2) meshes over cuda:0 repeated, against the
    one-device make_serve_prefill and make_serve_step (see the module
    docstring, phase 21).  Every comparison it prints it asserts.  The
    kernels' counts are set to 0 before each mesh's timed prefill and read
    after its last decode step."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.distributed.sharding import param_shardings, shard_tree, tree_paths
    from repro_torch.distributed.spmd import ShardedServeStep, shard_cache
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.models import lm
    from repro_torch.train.step import make_serve_prefill, make_serve_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    b, s, max_len, steps = SERVE_MESH_B, SERVE_MESH_S, SERVE_MESH_MAX, SERVE_MESH_STEPS
    published = get_config(MESH_TRAIN_ARCH)
    cfg = dataclasses.replace(published, num_layers=MESH_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    params = lm.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev,
                                     dtype=torch.int32)}
    log(f"[serve-mesh] {MESH_TRAIN_ARCH} d_model={cfg.d_model} heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} of {cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"qkv_bias={cfg.qkv_bias}, {cfg.num_layers} of {published.num_layers} layers (cut), "
        f"{cfg.dtype_name}; B={b} prompts of {s} tokens, {steps} decode steps from {s} in a cache "
        f"of {max_len} slots; meshes {list(SERVE_MESH_MESHES)} over cuda:0")
    counters = {"flash_attention": fa.launches, "flash_attention_tensor_core": fa.tensor_core_launches,
                "rms_norm": rn.launches, "rms_norm_resident": rn.resident_launches}
    tally: dict = {"K3": {}, "K5": {}}
    checked = {"K3": {(bb, hq, hkv, ss, d, dt) for bb, ss, hq, hkv, d, w, dt, _ in _k3_cases()
                      if w is None},
               "K5": {(n, d, dt) for n, d, _, dt in _k5_shapes()}}
    patches = (mock.patch.object(ops, "flash_attention", _tallied(
                   ops.flash_attention, tally["K3"],
                   lambda q, k, *_, **__: (*q.shape[:2], k.shape[1], *q.shape[2:], q.dtype))),
               mock.patch.object(ops, "rms_norm_kernel", _tallied(
                   ops.rms_norm_kernel, tally["K5"], lambda x, *_: (*x.shape, x.dtype))))

    def long_cache(prefilled):
        cache = lm.init_cache(cfg, b, max_len, dev)
        cache["k"][:, :, :, :s] = prefilled["k"]
        cache["v"][:, :, :, :s] = prefilled["v"]
        cache["length"] = s
        return cache

    walls, launches, copies, counted = {}, {k: 0 for k in counters}, {}, {}
    with patches[0], patches[1]:
        # ---- one device: the yardstick and the tokens fed to every mesh ------------
        prefill1, decode1 = make_serve_prefill(cfg), make_serve_step(cfg)
        prefill1(params, batch)  # warm
        (want, prefilled), wall = _synced(lambda: prefill1(params, batch))
        walls["one device"] = {"prefill": wall, "decode": []}
        one = long_cache(prefilled)
        tokens, want_steps = [want.argmax(-1, keepdim=True).int()], []
        for i in range(steps):
            (logits, one), wall = _synced(lambda: decode1(params, one, {"tokens": tokens[i]}))
            want_steps.append(logits)
            walls["one device"]["decode"].append(wall)
            tokens.append(logits.argmax(-1, keepdim=True).int())
        del one
        one_tally = {k: dict(v) for k, v in tally.items()}

        for shape in SERVE_MESH_MESHES:
            d, m = shape
            name = f"({d}, {m})"
            mesh = elastic_mesh(d * m, model_parallel=m, devices="cuda:0")
            assert tuple(mesh.shape) == shape, mesh.shape
            step = ShardedServeStep(cfg, mesh)
            sharded = shard_tree(params, param_shardings(mesh, params))
            step.prefill(sharded, batch)  # warm
            for c in counters.values():
                c.reset()
            for t in tally.values():
                t.clear()
            # ---- prefill: logits, cache blocks, K3 at 14/2 heads, K5 resident ------
            (got, cache), wall = _synced(lambda: step.prefill(sharded, batch))
            walls[name] = {"prefill": wall, "decode": []}
            at = {k: c.value for k, c in counters.items()}
            logits_rel = _rel(got, want)
            cache_rel = max(_rel(block, prefilled[path][st.placement.block(st.shape, p)])
                            for path, st in tree_paths({"k": cache["k"], "v": cache["v"]})
                            for p, block in enumerate(st.blocks))
            heads = {key[1:3] for key in tally["K3"]}
            log(f"[serve-mesh] {name} prefill ({step.modes(s)}): logits ||d||/||l|| against the "
                f"one-device prefill {logits_rel:.3g}, max |d| "
                f"{float((got - want).abs().max()):.4g}; worst cache block ||d||/||c|| "
                f"{cache_rel:.3g} over {len(cache['k'].blocks)} positions' k and v blocks of "
                f"{tuple(cache['k'].blocks[0].shape)} (bar {SERVE_MESH_TOL}); K3 calls by shape "
                f"{tally['K3']}, launches {at}")
            assert logits_rel <= SERVE_MESH_TOL and cache_rel <= SERVE_MESH_TOL, (logits_rel,
                                                                                  cache_rel)
            assert at["flash_attention_tensor_core"] == at["flash_attention"] == \
                cfg.num_layers * d * m, at
            assert heads == {(cfg.num_heads // m, cfg.num_kv_heads // m)}, heads
            # ---- decode: 16 teacher-forced steps through the empty block and into it
            cache = shard_cache(long_cache(prefilled), mesh)
            errs, agree, sure, rows = [], 0, 0, 0
            for i in range(steps):
                (got, cache), wall = _synced(lambda: step.decode(sharded, cache,
                                                                {"tokens": tokens[i]}))
                walls[name]["decode"].append(wall)
                w = want_steps[i]
                assert torch.isfinite(got).all(), (name, i)
                err = float((got - w).abs().max())
                errs.append((round(_rel(got, w), 6), round(err, 4)))
                agree, sure, rows = (a + b for a, b in zip((agree, sure, rows),
                                                            _greedy(got, w, err)))
            worst = max(e[0] for e in errs)
            log(f"[serve-mesh] {name} decode ({(step.attention, step.mlp)}), positions {s}-"
                f"{s + steps - 1}: logits (||d||/||l||, max |d|) per step {errs}; worst "
                f"{worst:.3g} (bar {SERVE_MESH_TOL}); greedy tokens agreeing {agree} of {rows} "
                f"(each of the {sure} whose one-device top-two gap exceeds twice its step's max "
                f"|d| must)")
            assert worst <= SERVE_MESH_TOL, errs
            for k, c in counters.items():
                launches[k] += c.value
            sharded_tally = {k: dict(v) for k, v in tally.items()}
            for k in tally:
                calls = set(sharded_tally[k]) | set(one_tally[k])
                assert calls <= checked[k], f"{k} shapes unchecked: {calls - checked[k]}"
            assert sum(sharded_tally["K5"].values()) == counters["rms_norm"].value
            assert counters["rms_norm_resident"].value == counters["rms_norm"].value > 0
            # ---- the copies between positions, and one more call of each counted live
            pos = cache["length"]
            (_, cache), counted[f"{name} decode"] = _counted(
                step.decode, sharded, cache, {"tokens": tokens[-1]})
            _, counted[f"{name} prefill"] = _counted(step.prefill, sharded, batch)
            copies[name] = {k: {c: v for c, v in counted[f"{name} {k}"]["totals"][
                "collectives"].items() if v} for k in ("prefill", "decode")}
            log(f"[serve-mesh] {name} noted copy bytes by kind (wire bytes, ring factors), "
                f"one prefill / one decode step (at {pos}): {copies[name]['prefill']} / "
                f"{copies[name]['decode']}")
            del sharded, cache, step
            torch.cuda.empty_cache()
    for name, w in walls.items():
        log(f"[serve-mesh] {name}: prefill {w['prefill']:.4f} s, decode step mean "
            f"{sum(w['decode']) / len(w['decode']):.4f} s (min {min(w['decode']):.4f}, max "
            f"{max(w['decode']):.4f}; host clock, synchronized)")
    log(f"[serve-mesh] launches over both meshes' timed prefill and decode steps {launches}; "
        f"phase wall {time.perf_counter() - t_phase:.1f} s (host clock); card: {smi()}")
    return {"launches": launches, "walls": walls, "copies": copies, "counted": counted,
            "cfg": cfg, "batch": _on_meta(batch)}


def _nest(path: str, value) -> dict:
    """``value`` at the '/'-joined ``path`` of a new nested dict."""
    out: dict = {}
    node = out
    *parents, name = path.split("/")
    for k in parents:
        node = node.setdefault(k, {})
    node[name] = value
    return out


def _rec_counters() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as k6
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import ssd_chunk as sc

    return {"flash_attention": fa.launches, "flash_attention_tensor_core": fa.tensor_core_launches,
            "flash_attention_bwd": fa.bwd_launches,
            "flash_attention_bwd_tensor_core": fa.bwd_tensor_core_launches,
            "ssd_chunk": sc.launches, "ssd_chunk_tensor_core": sc.tensor_core_launches,
            "ssd_chunk_bwd": sc.bwd_launches, "ssd_chunk_bwd_tensor_core": sc.bwd_tensor_core_launches,
            "rms_norm": rn.launches, "rms_norm_resident": rn.resident_launches,
            "rms_norm_bwd": rn.bwd_launches, "rms_norm_bwd_resident": rn.bwd_resident_launches,
            "rglru_scan": k6.launches, "rglru_scan_bwd": k6.bwd_launches}


_REC_KEYS = {  # how each kernel's calls are tallied by shape
    "K3": lambda q, k, *_, **__: (*q.shape[:2], k.shape[1], *q.shape[2:], q.dtype),
    "K4": lambda x, a, b, *_, **__: (tuple(x.shape), tuple(b.shape), x.dtype),
    "K5": lambda x, *_, **__: (*x.shape, x.dtype),
    "K6": lambda a, *_, **__: tuple(a.shape),
}


def _kernel_tally(targets) -> tuple[dict, list]:
    """``targets`` ``(module, name, key)``: each kernel entry wrapped to
    tally its calls by shape under ``key`` (keyed as ``_REC_KEYS`` by the
    key's first word); returns the tallies and the (unstarted) patches."""
    from unittest import mock

    tally: dict = {key: {} for _, _, key in targets}
    return tally, [mock.patch.object(mod, name, _tallied(getattr(mod, name), tally[key],
                                                         _REC_KEYS[key.split()[0]]))
                   for mod, name, key in targets]


@contextlib.contextmanager
def _started(patches):
    for p in patches:
        p.start()
    try:
        yield
    finally:
        for p in patches:
            p.stop()


def _zeroed(counters: dict, tally: dict) -> None:
    """The kernels' counts set to 0 and the tallies emptied."""
    for c in counters.values():
        c.reset()
    for t in tally.values():
        t.clear()


def _rec_checked(window: int | None) -> dict[str, set]:
    """The shapes each kernel's phase checked, keyed as ``_REC_KEYS``."""
    _, p, n, _ = _mamba_scan_dims()
    return {
        "K3": {(b, hq, hkv, s, d, dt) for b, s, hq, hkv, d, w, dt, _ in _k3_cases() if w == window},
        "K3 bwd": {(b, hq, hkv, s, d, dt) for b, s, hq, hkv, d, w, dt, _ in _k3_bwd_cases()
                   if w == window},
        "K4": {((b * h, s, p), (b, s, n), dt) for b, s, h, dt, _ in _k4_cases()},
        "K4 bwd": {((b * h, s, p), (b * h // hpb, s, n), dt)
                   for b, s, h, hpb, dt, _, _ in _k4_bwd_cases()},
        "K5": {(rows, d, dt) for rows, d, _, dt in _k5_shapes()},
        "K5 bwd": {(rows, d, dt) for rows, d, _, dt in _k5_bwd_cases()},
        "K6": {shape for shape, _ in _k6_cases()},
        "K6 bwd": {shape for shape, _ in _k6_cases()},
    }


def _rec_split_shapes(cfg, tally: dict, tp: int, seq: int) -> str:
    """Asserts that the sharded steps' full-sequence kernels ran each
    model position's share: K4 at H/tp heads a B/C row, K6 at R/tp
    channels, K3 at all heads on each position's block of ``seq // tp``
    query rows from the window's first key (or 0); returns what it
    found."""
    found = {}
    if cfg.family == "ssm":
        h = 2 * cfg.d_model // cfg.ssm_head_dim
        heads = {x[0] // b[0] for k in ("K4", "K4 bwd") for x, b, _ in tally[k]}
        assert heads == {h // tp}, heads
        found["K4 heads a B/C row"] = sorted(heads)
    else:
        chans = {shape[2] for k in ("K6", "K6 bwd") for shape in tally[k]}
        assert chans == {cfg.d_rnn // tp}, chans
        rows = {key[3] for k in ("K3", "K3 bwd") for key in tally[k]}
        w = seq // tp
        blocks = {(m + 1) * w - max(0, m * w - cfg.window + 1) for m in range(tp)}
        assert rows == blocks and all(key[1:3] == (cfg.num_heads, cfg.num_kv_heads)
                                      for k in ("K3", "K3 bwd") for key in tally[k]), (rows, blocks)
        found["K6 channels"], found["K3 query rows"] = sorted(chans), sorted(rows)
    return str(found)


def phase_train_mesh_rec() -> dict:
    """mamba2-2.7b and recurrentgemma-9b at their published widths, cut in
    depth (REC_TRAIN_RUNS), trained by the sharded train step split over
    model on the (1, 2) and (2, 2) meshes over cuda:0 repeated, against
    the one-device make_train_step: (a) step 1's loss within 2e-2, and
    every gradient leaf held to an f32 one-device step on the same bf16
    parameter values: the split's distance from it at most one device's
    plus 2e-2, and within 2e-2 of one device's bf16 gradient wherever that
    is within 2e-2 of f32 (mamba's bf16 gradients lie 0.25-0.40 from f32
    on one device, so a direct 2e-2 bar between two bf16 steps would
    measure their rounding, not the split); (b) on (2, 2), AdamW on the one-device gradients
    sliced to the placements with the one-device clip scale, every block
    of params, m and v bitwise adamw_update's arithmetic (leaf by leaf:
    the one-device state and a second copy of the largest leaf's fit, two
    whole copies would not); (c) free-running losses of steps 1-3 within
    2e-2; (d) every K3, K4 and K5 call, forward and backward, on its
    tensor-core or resident route, K4 at 40 heads a B/C row, K6 at 2048
    channels, K3 on recurrentgemma's sequence blocks, every call at a
    shape its phase checked.  The kernels' counts are set to 0 before
    each mesh's steps and read after them."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.distributed.sharding import tree_map, tree_paths
    from repro_torch.distributed.spmd import make_sharded_train_step, shard_train_state
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as k6
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, clip_scale, global_norm
    from repro_torch.train.step import init_train_state, loss_and_grads, make_train_step

    synced = functools.partial(_synced, collect=True)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counters = _rec_counters()
    tally, patches = _kernel_tally(((fa, "flash_attention", "K3"),
                                    (fa, "flash_attention_bwd", "K3 bwd"),
                                    (sc, "ssd_scan", "K4"), (sc, "ssd_scan_bwd", "K4 bwd"),
                                    (rn, "rms_norm", "K5"), (rn, "rms_norm_bwd", "K5 bwd"),
                                    (k6, "rglru_scan", "K6"), (k6, "rglru_scan_bwd", "K6 bwd")))
    meshes = {shape: elastic_mesh(shape[0] * shape[1], model_parallel=shape[1], devices="cuda:0")
              for shape in REC_MESHES}

    launches = {k: 0 for k in counters}
    out = {"runs": {}}
    with _started(patches):
        for arch, layers, b, s, moments in REC_TRAIN_RUNS:
            cfg = _rec_cfg(arch, layers)
            opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS,
                                  moment_dtype=moments)
            batch = make_global_batch(0, 0, b, s, cfg.vocab_size, device=dev)
            checked = _rec_checked(cfg.window or None)
            log(f"[train-mesh-rec] {arch} d_model={cfg.d_model} "
                + (f"{2 * cfg.d_model // cfg.ssm_head_dim} SSD heads of {cfg.ssm_head_dim}, "
                   f"N={cfg.ssm_state}" if cfg.family == "ssm" else
                   f"d_rnn={cfg.d_rnn} heads {cfg.num_heads}/{cfg.num_kv_heads} of "
                   f"{cfg.head_dim} window={cfg.window} d_ff={cfg.d_ff}")
                + f" vocab={cfg.vocab_size}, {layers} of {get_published_layers(arch)} layers "
                f"(cut), {cfg.dtype_name} params, {moments} moments, remat={cfg.remat}; global "
                f"B={b} S={s}, lr {TRAIN_LR}; meshes {list(meshes)} over cuda:0")
            # ---- f32 yardstick: one device in f32 on the same bf16 parameter values
            _collected()
            params32 = tree_map(lambda t: t.float(), lm.init_params(cfg, seed=0, device=dev))
            cfg32 = dataclasses.replace(cfg, dtype_name="float32")
            g32 = tree_map(lambda t: t.to("cpu"), loss_and_grads(params32, cfg32, batch)[1])
            del params32
            # ---- one device: step 1's gradients, then (b) and steps 2-3 --------------
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for t in tally.values():
                t.clear()
            state = init_train_state(cfg, opt_cfg, seed=0, device=dev)
            (loss1, g1), wall1 = synced(lambda: loss_and_grads(state["params"], cfg, batch))
            scale1 = clip_scale(opt_cfg, global_norm(g1))
            one_tally = {k: dict(v) for k, v in tally.items()}
            mesh22 = meshes[REC_MESHES[-1]]
            compared = _rec_optimizer_bitwise(cfg, state, g1, scale1, opt_cfg, mesh22)
            log(f"[train-mesh-rec] {arch} (b) (2, 2) AdamW on the one-device step-1 gradients "
                f"sliced to the placements, with its clip scale {float(scale1):.6g}, leaf by leaf "
                f"against adamw_update's arithmetic: [blocks, not bitwise equal] {compared} "
                f"(bar: 0 unequal)")
            assert all(bad == 0 for _, bad in compared.values()), compared
            step1 = make_train_step(cfg, opt_cfg)
            one_losses, walls = [float(loss1)], {"one device": [wall1]}
            for _ in range(2):
                (state, m), wall = synced(lambda: step1(state, batch))
                one_losses.append(float(m["loss"]))
                walls["one device"].append(wall)
            peaks = {"one device": torch.cuda.max_memory_allocated()}
            del state
            g1 = tree_map(lambda t: t.to("cpu"), g1)  # the yardstick, off the card
            torch.cuda.empty_cache()
            run = {"losses": {"one device": one_losses}, "walls": walls, "peaks": peaks,
                   "splits": {}}
            for shape, mesh in meshes.items():
                name = f"({shape[0]}, {shape[1]})"
                _collected()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                sharded = shard_train_state(init_train_state(cfg, opt_cfg, seed=0, device=dev),
                                            mesh)
                torch.cuda.empty_cache()
                step = make_sharded_train_step(cfg, opt_cfg, mesh, timed=True)
                assert step.tensor_parallel and step.mixer in ("heads", "channels"), step.mixer
                _zeroed(counters, tally)
                # ---- (a) step 1 against the one-device step and the f32 yardstick -----
                (loss, grads), wall = synced(lambda: step.loss_and_grads(sharded["params"], batch))
                rel, missed = {}, {}
                for (path, gs), (_, ref), (_, ref32) in zip(tree_paths(grads), tree_paths(g1),
                                                            tree_paths(g32)):
                    got, ref, ref32 = gs.full(), ref.to(dev, torch.float32), ref32.to(dev)
                    # (split vs one device, split vs f32, one device vs f32)
                    rel[path] = tuple(round(float((x - y).norm() / y.norm()), 5)
                                      for x, y in ((got, ref), (got, ref32), (ref, ref32)))
                    direct, split32, one32 = rel[path]
                    if split32 > one32 + MESH_TRAIN_TOL or (one32 <= MESH_TRAIN_TOL
                                                            and direct > MESH_TRAIN_TOL):
                        missed[path] = rel[path]
                    del got, ref, ref32
                loss_rel = abs(float(loss) - one_losses[0]) / abs(one_losses[0])
                log(f"[train-mesh-rec] {arch} {name} (a) ({step.mixer}, {step.modes(s)}) step 1 "
                    f"from the same state: loss {float(loss):.6f} vs {one_losses[0]:.6f} "
                    f"(relative {loss_rel:.3g}); per gradient leaf ||dg||/||g|| (split vs one "
                    f"device, split vs f32, one device vs f32) {rel}; worst split vs one device "
                    f"{max(r[0] for r in rel.values()):.3g}, worst (split - one device) vs f32 "
                    f"{max(r[1] - r[2] for r in rel.values()):.3g} (bar {MESH_TRAIN_TOL}: the "
                    f"split adds at most it to one device's distance from f32, and is within it "
                    f"of one device where one device is within it of f32); missed {missed}")
                assert loss_rel <= MESH_TRAIN_TOL and not missed, (loss_rel, missed)
                splits = [dict(step.seconds)]
                opt_wall = synced(lambda: step.apply(sharded, grads))[1]
                splits[0].update(step.seconds)
                del grads
                walls[name] = [wall + opt_wall]
                losses = [float(loss)]
                (sharded, m), wall = synced(lambda: step(sharded, batch))
                walls[name].append(wall)
                splits.append(dict(step.seconds))
                losses.append(float(m["loss"]))
                (loss, grads), wall = synced(lambda: step.loss_and_grads(sharded["params"], batch))
                del grads
                walls[name].append(wall)
                splits.append(dict(step.seconds))
                losses.append(float(loss))
                at = {k: c.value for k, c in counters.items()}
                mesh_tally = {k: dict(v) for k, v in tally.items()}
                peaks[name] = torch.cuda.max_memory_allocated()
                rels = [abs(a - w) / abs(w) for a, w in zip(losses, one_losses)]
                log(f"[train-mesh-rec] {arch} {name} (c) free-running losses, steps 1-3: {losses}, "
                    f"one device {one_losses}; relative {rels} (bar {MESH_TRAIN_TOL})")
                assert max(rels) <= MESH_TRAIN_TOL, rels
                # ---- (d) the kernels: routes, shares, shapes checked -------------------
                split = _rec_split_shapes(cfg, mesh_tally, shape[1], s)
                log(f"[train-mesh-rec] {arch} {name} (d) calls by shape {mesh_tally}; launches "
                    f"{at}; each position's share: {split}")
                for key in tally:
                    calls = set(mesh_tally[key]) | set(one_tally[key])
                    assert calls <= checked[key], f"{key} shapes unchecked: {calls - checked[key]}"
                for key, counter in (("K3", "flash_attention"), ("K3 bwd", "flash_attention_bwd"),
                                     ("K4", "ssd_chunk"), ("K4 bwd", "ssd_chunk_bwd"),
                                     ("K5", "rms_norm"), ("K5 bwd", "rms_norm_bwd"),
                                     ("K6", "rglru_scan"), ("K6 bwd", "rglru_scan_bwd")):
                    assert sum(mesh_tally[key].values()) == at[counter], (key, mesh_tally, at)
                assert at["rms_norm_resident"] == at["rms_norm"] > 0, at
                assert at["rms_norm_bwd_resident"] == at["rms_norm_bwd"] > 0, at
                if cfg.family == "ssm":
                    assert at["ssd_chunk_tensor_core"] == at["ssd_chunk"] > 0, at
                    assert at["ssd_chunk_bwd_tensor_core"] == at["ssd_chunk_bwd"] > 0, at
                else:
                    assert at["flash_attention_tensor_core"] == at["flash_attention"] > 0, at
                    assert at["flash_attention_bwd_tensor_core"] == at["flash_attention_bwd"] > 0
                    assert at["rglru_scan"] > 0 and at["rglru_scan_bwd"] > 0, at
                for k2 in launches:
                    launches[k2] += at[k2]
                run["losses"][name] = losses
                run["splits"][name] = splits
                run.setdefault("held", {})[name] = held
                if mesh is mesh22:  # one more step, counted live for [dryrun]
                    (sharded, _), wall = synced(lambda: step(sharded, batch))
                    sharded, run["counted"] = _counted_step(step, sharded, batch)
                    run["wall"] = wall
                del sharded
                torch.cuda.empty_cache()
            for name, ws in walls.items():
                log(f"[train-mesh-rec] {arch} {name} step walls (host clock, synchronized) "
                    f"{[round(w, 4) for w in ws]} s -> {b * s / ws[-1]:.1f} tokens/s at the last")
            log(f"[train-mesh-rec] {arch} the sharded steps' split (s; gather / forward_backward "
                f"/ reduce / optimizer; steps 1-3): {run['splits']}; peak device memory "
                f"(max_memory_allocated) by run: {peaks}; allocated at each mesh's start "
                f"(after a garbage collection): {run['held']}")
            del g1, g32
            run.update(cfg=cfg, opt_cfg=opt_cfg, batch=_on_meta(batch))
            out["runs"][arch] = run
    log(f"[train-mesh-rec] launches over both runs' meshes {launches}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s (host clock); card: {smi()}")
    out["launches"] = launches
    return out


def _rec_optimizer_bitwise(cfg, state: dict, grads: dict, scale, opt_cfg, mesh) -> dict:
    """[train-mesh-rec]'s (b), leaf by leaf on ``mesh``: each leaf's params,
    m and v sharded, the sharded AdamW on its blocks (the one-device
    ``grads`` sliced to the placements, the clip ``scale``), then
    adamw_update's arithmetic on the one-device leaf in place (its scale
    and step scalars); ``state`` is left as adamw_update leaves it.
    Returns ``{part: [blocks, blocks not bitwise equal]}``."""
    from repro_torch.distributed.sharding import tree_paths
    from repro_torch.distributed.spmd import (make_sharded_train_step, shard_train_state,
                                              state_shardings)
    from repro_torch.train.optimizer import adamw_leaf, step_scalars

    step = make_sharded_train_step(cfg, opt_cfg, mesh)
    opt = state["opt"]
    k = step_scalars(opt_cfg, opt["step"] + 1)
    compared = {"params": [0, 0], "m": [0, 0], "v": [0, 0]}
    for (path, p), (_, g), (_, m), (_, v) in zip(tree_paths(state["params"]), tree_paths(grads),
                                                 tree_paths(opt["m"]), tree_paths(opt["v"])):
        sub = {"params": _nest(path, p), "opt": {"m": _nest(path, m), "v": _nest(path, v),
                                                 "step": opt["step"]}}
        sharded = shard_train_state(sub, mesh)
        step.apply(sharded, _sliced(_nest(path, g), state_shardings(mesh, sub)["params"]),
                   scale=scale)
        adamw_leaf(p, g, m, v, opt_cfg, scale, k["lr"], k["bc1"], k["bc2"])
        for part, got, want in (("params", sharded["params"], sub["params"]),
                                ("m", sharded["opt"]["m"], sub["opt"]["m"]),
                                ("v", sharded["opt"]["v"], sub["opt"]["v"])):
            n, bad = _blocks_unequal(got, want)
            compared[part][0] += n
            compared[part][1] += bad
    opt["step"] = opt["step"] + 1
    return compared


def _collected() -> None:
    """Python's cycles freed (autograd's and checkpoint's contexts hold
    device tensors until the collector runs), then the cached blocks."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def get_published_layers(arch: str) -> int:
    from repro_torch.configs import get_config

    return get_config(arch).num_layers


def _rec_long_cache(cfg, prefilled: dict, b: int, s: int, max_len: int, dev) -> dict:
    """A one-device prefill's cache written into a decode cache of
    ``max_len`` slots (the hybrid's ring of min(window, max_len): the
    prompt's positions in slots 0..S-1, S <= window)."""
    from repro_torch.models import lm

    cache = lm.init_cache(cfg, b, max_len, dev)
    if "k" in cache:
        cache["k"][:, :, :, :s] = prefilled["k"]
        cache["v"][:, :, :, :s] = prefilled["v"]
    for name in ("layers", "r1", "r2", "tail"):
        if name in cache:
            cache[name] = {k: v.clone() for k, v in prefilled[name].items()}
    cache["length"] = s
    return cache


def _rec_cache_rel(sharded: dict, whole: dict) -> float:
    """The worst ||d||/||c|| of every position's block of every cache
    tensor against that region of the one-device cache."""
    from repro_torch.distributed.sharding import tree_paths

    want = dict(tree_paths({k: v for k, v in whole.items() if k != "length"}))
    worst = 0.0
    for path, st in tree_paths({k: v for k, v in sharded.items() if k != "length"}):
        for p, block in enumerate(st.blocks):
            ref = want[path][st.placement.block(st.shape, p)]
            assert torch.isfinite(block.float()).all(), (path, p)
            if float(ref.float().norm()):
                worst = max(worst, _rel(block, ref))
            else:
                assert not block.float().abs().max(), (path, p)
    return worst


def phase_serve_mesh_rec() -> dict:
    """mamba2-2.7b and recurrentgemma-9b (REC_SERVE_RUNS) served by the
    sharded serving step split over model on the (1, 2) and (2, 2) meshes
    over cuda:0 repeated, against the one-device make_serve_prefill and
    make_serve_step: the prefill's logits and every cache block (SSM state
    by heads, conv windows and RG-LRU h by channels, the ring by slots)
    within 2e-2; 16 decode steps teacher-forced by the one-device greedy
    tokens, each step's logits within 2e-2 and its greedy tokens equal
    wherever the one-device top-two gap exceeds twice its max |d|, and the
    cache after them within 2e-2; K4 on the tensor cores at 40 heads
    once per layer, data shard run and model position in each prefill,
    K6 at 2048 channels once per RG-LRU layer, data shard run and model
    position, the windowed K3 on the tensor cores once per attention
    layer, data shard run and position, every K5 call resident, every
    call at a shape its phase checked.  The kernels' counts are set to 0
    before each mesh's timed prefill and read after its last decode step."""
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.distributed.spmd import ShardedServeStep, shard_cache
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.train.step import make_serve_prefill, make_serve_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counters = _rec_counters()
    tally, patches = _kernel_tally(((ops, "flash_attention", "K3"), (ops, "ssd_scan", "K4"),
                                    (ops, "rms_norm_kernel", "K5"),
                                    (ops, "rglru_scan_kernel", "K6")))

    launches = {k: 0 for k in counters}
    out: dict = {"runs": {}}
    with _started(patches):
        for arch, layers, b, s, max_len in REC_SERVE_RUNS:
            cfg = _rec_cfg(arch, layers)
            checked = _rec_checked(cfg.window or None)
            _collected()
            params = lm.init_params(cfg, seed=0, device=dev)
            gen = torch.Generator(device=dev).manual_seed(43)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev,
                                             dtype=torch.int32)}
            ring = min(cfg.window, max_len) if cfg.family == "hybrid" else None
            log(f"[serve-mesh-rec] {arch} d_model={cfg.d_model}, {layers} of "
                f"{get_published_layers(arch)} layers (cut), {cfg.dtype_name}; B={b} prompts of "
                f"{s} tokens, {REC_SERVE_STEPS} decode steps from {s} in a cache of {max_len}"
                + (f" (a ring of {ring} slots)" if ring else "") + f"; meshes {list(REC_MESHES)} "
                "over cuda:0")
            for t in tally.values():
                t.clear()
            prefill1, decode1 = make_serve_prefill(cfg), make_serve_step(cfg)
            prefill1(params, batch)  # warm
            (want, prefilled), wall = _synced(lambda: prefill1(params, batch))
            walls = {"one device": {"prefill": wall, "decode": []}}
            one = _rec_long_cache(cfg, prefilled, b, s, max_len, dev)
            tokens, want_steps = [want.argmax(-1, keepdim=True).int()], []
            for i in range(REC_SERVE_STEPS):
                (logits, one), wall = _synced(lambda: decode1(params, one, {"tokens": tokens[i]}))
                want_steps.append(logits)
                walls["one device"]["decode"].append(wall)
                tokens.append(logits.argmax(-1, keepdim=True).int())
            one_tally = {k: dict(v) for k, v in tally.items()}
            run: dict = {"walls": walls, "copies": {}}
            for shape in REC_MESHES:
                d, m = shape
                name = f"({d}, {m})"
                mesh = elastic_mesh(d * m, model_parallel=m, devices="cuda:0")
                step = ShardedServeStep(cfg, mesh)
                assert step.tensor_parallel and step.mixer in ("heads", "channels"), step.mixer
                shards = d if b % d == 0 else 1  # the data shards that run
                sharded = shard_tree(params, param_shardings(mesh, params))
                step.prefill(sharded, batch)  # warm
                _zeroed(counters, tally)
                (got, cache), wall = _synced(lambda: step.prefill(sharded, batch))
                walls[name] = {"prefill": wall, "decode": []}
                at = {k: c.value for k, c in counters.items()}
                logits_rel = _rel(got, want)
                cache_rel = _rec_cache_rel(cache, prefilled)
                log(f"[serve-mesh-rec] {arch} {name} prefill ({step.mixer}, {step.modes(s)}): "
                    f"logits ||d||/||l|| against the one-device prefill {logits_rel:.3g}, max |d| "
                    f"{float((got - want).abs().max()):.4g}; worst cache block ||d||/||c|| "
                    f"{cache_rel:.3g} (bar {SERVE_MESH_TOL}); calls by shape {tally}, launches {at}")
                assert logits_rel <= SERVE_MESH_TOL and cache_rel <= SERVE_MESH_TOL, (logits_rel,
                                                                                      cache_rel)
                per = shards * m  # one launch per layer, data shard run and model position
                if cfg.family == "ssm":
                    assert at["ssd_chunk_tensor_core"] == at["ssd_chunk"] == cfg.num_layers * per, at
                else:
                    n_super = cfg.num_layers // 3
                    assert at["flash_attention_tensor_core"] == at["flash_attention"] == \
                        n_super * per, at
                    assert at["rglru_scan"] == (cfg.num_layers - n_super) * per, at
                split = _rec_split_shapes(cfg, {**tally, "K4 bwd": {}, "K6 bwd": {}, "K3 bwd": {}},
                                          m, s)
                log(f"[serve-mesh-rec] {arch} {name} prefill: each position's share: {split}")
                del got
                # ---- decode: the steps teacher-forced by the one-device tokens ----------
                cache = shard_cache(_rec_long_cache(cfg, prefilled, b, s, max_len, dev), mesh)
                errs, agree, sure, rows = [], 0, 0, 0
                for i in range(REC_SERVE_STEPS):
                    (got, cache), wall = _synced(lambda: step.decode(sharded, cache,
                                                                    {"tokens": tokens[i]}))
                    walls[name]["decode"].append(wall)
                    w = want_steps[i]
                    assert torch.isfinite(got).all(), (name, i)
                    err = float((got - w).abs().max())
                    errs.append((round(_rel(got, w), 6), round(err, 4)))
                    agree, sure, rows = (a + b for a, b in zip((agree, sure, rows),
                                                                _greedy(got, w, err)))
                worst = max(e[0] for e in errs)
                final_rel = _rec_cache_rel(cache, one)
                log(f"[serve-mesh-rec] {arch} {name} decode, positions {s}-{s + REC_SERVE_STEPS - 1}"
                    + (f" (ring slots {s % ring}-{(s + REC_SERVE_STEPS - 1) % ring}, "
                       f"{ring // m} a position)" if ring else "")
                    + f": logits (||d||/||l||, max |d|) per step {errs}; worst {worst:.3g}; cache "
                    f"blocks after the last step, worst ||d||/||c|| {final_rel:.3g} (bar "
                    f"{SERVE_MESH_TOL}); greedy tokens agreeing {agree} of {rows} (each of the "
                    f"{sure} whose one-device top-two gap exceeds twice its step's max |d| must)")
                assert worst <= SERVE_MESH_TOL and final_rel <= SERVE_MESH_TOL, (errs, final_rel)
                at = {k: c.value for k, c in counters.items()}
                for k2 in launches:
                    launches[k2] += at[k2]
                for key in tally:
                    calls = set(tally[key]) | set(one_tally[key])
                    assert calls <= checked[key], f"{key} shapes unchecked: {calls - checked[key]}"
                assert sum(tally["K5"].values()) == at["rms_norm"]
                assert at["rms_norm_resident"] == at["rms_norm"] > 0, at
                if mesh.shape == tuple(REC_MESHES[-1]):  # one more of each, counted live
                    pos = run["counted_length"] = cache["length"]
                    (_, cache), run["counted_decode"] = _counted(
                        step.decode, sharded, cache, {"tokens": tokens[-1]})
                    _, run["counted_prefill"] = _counted(step.prefill, sharded, batch)
                    run["copies"] = {k: {c: v for c, v in run[f"counted_{k}"]["totals"][
                        "collectives"].items() if v} for k in ("prefill", "decode")}
                    log(f"[serve-mesh-rec] {arch} {name} noted copy bytes by kind, one prefill / "
                        f"one decode step (at {pos}): {run['copies']['prefill']} / "
                        f"{run['copies']['decode']}")
                del sharded, cache, step
                torch.cuda.empty_cache()
            for name, w in walls.items():
                log(f"[serve-mesh-rec] {arch} {name}: prefill {w['prefill']:.4f} s, decode step "
                    f"mean {sum(w['decode']) / len(w['decode']):.4f} s (min {min(w['decode']):.4f}, "
                    f"max {max(w['decode']):.4f}; host clock, synchronized)")
            run.update(cfg=cfg, batch=_on_meta(batch), max_len=max_len)
            out["runs"][arch] = run
            del params, one, prefilled
    log(f"[serve-mesh-rec] launches over both runs' meshes' timed prefill and decode steps "
        f"{launches}; phase wall {time.perf_counter() - t_phase:.1f} s (host clock); card: {smi()}")
    out["launches"] = launches
    return out


class _RouteLog:
    """Every ``moe_route`` call's outputs (``fwd``, ``slot_gate``),
    detached, in call order: the one-device layer's (``models/moe.py``)
    and the split's (``distributed/spmd.py``)."""

    def __init__(self) -> None:
        from unittest import mock

        from repro_torch.distributed import spmd
        from repro_torch.models import moe

        self.calls: list[tuple] = []
        real = moe.moe_route

        def route(*args, **kwargs):
            out = real(*args, **kwargs)
            self.calls.append(tuple(t.detach().clone() for t in out))
            return out

        self._patches = [mock.patch.object(moe, "moe_route", route),
                         mock.patch.object(spmd, "moe_route", route)]

    def __enter__(self):
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc) -> None:
        for p in self._patches:
            p.stop()

    def take(self) -> list[tuple]:
        out, self.calls = self.calls, []
        return out

    @contextlib.contextmanager
    def off(self):
        """The unwrapped ``moe_route`` inside: a step counted live for
        [dryrun] runs the planner's ops, without this log's copies."""
        self.__exit__()
        try:
            yield
        finally:
            self.__enter__()


def _moe_passes(calls: list, n: int, passes: int, remat: bool) -> list[list[tuple]]:
    """The forward's routing of each of ``passes`` runs (data shards, in
    order) of ``n`` moe layers: with ``remat`` each run routes every layer
    twice (the forward, then the backward's recompute in reverse order),
    which must be the same bits."""
    per = 2 * n if remat else n
    assert len(calls) == per * passes, (len(calls), per, passes)
    out = []
    for i in range(passes):
        run = calls[i * per:(i + 1) * per]
        if remat:
            for a, b in zip(run[:n], reversed(run[n:])):
                assert all(torch.equal(x, y) for x, y in zip(a, b)), "the recompute routed anew"
        out.append(run[:n])
    return out


def _assigned(fwd: torch.Tensor, e: int, s: int) -> torch.Tensor:
    """``[B, E, S]`` bool: token ``t`` of row ``r`` holds a slot of expert
    ``x`` (``fwd [B, E·C]`` the slot maps, ``s`` an empty slot)."""
    b = fwd.shape[0]
    mask = torch.zeros((b, e, s + 1), dtype=torch.bool, device=fwd.device)
    return mask.scatter_(2, fwd.reshape(b, e, -1), True)[..., :s]


def _routing_diff(one: list, split: list, e: int, s: int) -> list[dict]:
    """Per moe layer, the (token, expert) assignments of the split's routing
    (its data shards' rows in order) that differ from one device's: their
    count, the experts and the rows they touch."""
    out = []
    for layer, want in enumerate(one):
        got = torch.cat([shard[layer][0] for shard in split])
        diff = _assigned(want[0], e, s) ^ _assigned(got, e, s)
        out.append({"assignments": int(diff.sum()),
                    "experts": diff.any(dim=2).any(dim=0).nonzero().flatten().tolist(),
                    "rows": diff.any(dim=2).any(dim=1).nonzero().flatten().tolist()})
    return out


def _layer_shares(step, layer: dict) -> list[dict]:
    """Each model position's share of one layer's whole leaves (a tree of
    tensors, ``lm.layer`` of a stack), sliced as ``step._share`` splits them
    (attention by heads): what the position computes with."""
    from repro_torch.distributed.sharding import tree_paths
    from repro_torch.distributed.spmd import _put

    out: list[dict] = [{} for _ in range(step.tp)]
    for path, t in tree_paths(layer):
        ms, dim = step._share(path, "heads", step.mlp)
        for m in ms:
            _put(out[m], path, t[step._region(tuple(t.shape), dim, m)])
    return out


def _moe_layer_check(cfg, lp: dict, h: torch.Tensor, mesh, grad: bool, what: str) -> dict:
    """(a): one moe block's FFN (``lm._moe_ffn``) on ``h`` on one device and
    split over ``mesh``'s model positions (``ShardedTrainStep._moe``, each
    position's leaves slices of the same whole leaves): the routing
    bitwise, the output and (``grad``) the gradients of ``h`` and every
    leaf within ``MOE_LAYER_TOL``; returns the errors."""
    from repro_torch.distributed.sharding import tree_map, tree_paths
    from repro_torch.distributed.spmd import ShardedTrainStep
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig

    step = ShardedTrainStep(cfg, AdamWConfig(), mesh)
    assert step.experts == "experts" and step.mlp == "columns", (step.experts, step.mlp)
    leaves = tree_map(lambda t: t.detach().requires_grad_(grad),
                      {k: v for k, v in lp.items() if k in ("moe", "shared", "residual")})
    paths = [p for p, _ in tree_paths(leaves)]
    devices = [step.devices[int(p)] for p in step.rows[0]]
    gen = torch.Generator(device=h.device).manual_seed(29)
    dy = torch.randn(h.shape, generator=gen, device=h.device).to(h.dtype)
    outs, routes = [], []
    with _RouteLog() as log_, torch.set_grad_enabled(grad):
        for fn in (lambda x: lm._moe_ffn(leaves, cfg, x),
                   lambda x: step._moe(_layer_shares(step, leaves), x, devices, step.mlp)):
            x = h.detach().clone().requires_grad_(grad)
            y = fn(x)
            gs = (torch.autograd.grad(y, [x] + [t for _, t in tree_paths(leaves)], dy)
                  if grad else ())
            outs.append((y.detach(), gs))
            (r,) = log_.take()
            routes.append(r)
            del y, x
    bitwise = all(torch.equal(a, b) for a, b in zip(*routes))
    tol = MOE_LAYER_TOL[h.dtype]
    errs = {"output": _rel(outs[1][0], outs[0][0])}
    for name, a, b in zip(["h"] + paths, outs[0][1], outs[1][1]):
        errs[name] = _rel(b, a) if float(a.float().norm()) else float(b.float().norm())
    log(f"[{what}] (a) one moe block's FFN alone, {cfg.name} at d_model={cfg.d_model}, "
        f"{cfg.num_experts} experts top-{cfg.top_k}, h {tuple(h.shape)} {str(h.dtype)[6:]}, split "
        f"over {mesh.shape} ({cfg.num_experts // step.tp} experts a position): routing (fwd, "
        f"slot_gate; the inverse map is a function of fwd) bitwise {bitwise}; ||d||/||ref|| "
        f"{errs} (bar {tol})")
    assert bitwise and max(errs.values()) <= tol, (bitwise, errs)
    return errs


def _agreeing(path: str, flipped: dict, *tensors) -> tuple:
    """``tensors`` (gradients of leaf ``path``), an expert leaf's cut to the
    (layer, expert) rows whose token sets agree (``flipped``: ``{layer:
    experts}`` that differ)."""
    if not (path.startswith("moe_blocks/moe/") and not path.endswith("router")
            and any(flipped.values())):
        return tensors
    keep = torch.ones(tensors[0].shape[:2], dtype=torch.bool, device=tensors[0].device)
    for layer, experts in flipped.items():
        keep[layer, experts] = False
    return tuple(t[keep] for t in tensors)


def _grad_rules(grads, g1, g32, flipped: dict, tol: float) -> tuple[dict, dict]:
    """(b)'s gradient rule, leaf by leaf: ``(split vs one device, split vs
    f32, one device vs f32)`` relative, the expert leaves over the (layer,
    expert) rows whose token sets agree (``flipped``: ``{layer: experts}``
    that differ, held by (a)).  Where no routing differs every leaf must be
    within ``tol`` of one device; elsewhere the split may add ``tol`` to
    one device's distance from the f32 step, and must be within ``tol`` of
    one device wherever one device is within it of f32.  Returns the
    errors and the leaves that missed."""
    from repro_torch.distributed.sharding import tree_paths

    any_flip = any(flipped.values())
    rel, missed = {}, {}
    for (path, gs), (_, ref), (_, ref32) in zip(tree_paths(grads), tree_paths(g1),
                                                tree_paths(g32)):
        got = gs.full()
        got, ref, ref32 = _agreeing(path, flipped, got, ref.to(got.device, torch.float32),
                                    ref32.to(got.device))
        rel[path] = tuple(round(float((x - y).norm() / y.norm()), 5) if float(y.norm()) else 0.0
                          for x, y in ((got, ref), (got, ref32), (ref, ref32)))
        direct, split32, one32 = rel[path]
        if direct > tol and (not any_flip or split32 > one32 + tol or one32 <= tol):
            missed[path] = rel[path]
        del got, ref, ref32
    return rel, missed


def _expert_errors(grads, g1, flipped: dict) -> dict:
    """``{(layer, expert): ||dg||/||g||}`` of the flipped experts' gate, up
    and down gradients together."""
    out = {}
    for layer, experts in flipped.items():
        for x in experts:
            num = den = 0.0
            for name in ("gate", "up", "down"):
                got = grads["moe_blocks"]["moe"][name].full()[layer, x]
                ref = g1["moe_blocks"]["moe"][name][layer, x].to(got.device, torch.float32)
                num += float((got - ref).double().norm()) ** 2
                den += float(ref.double().norm()) ** 2
            out[(layer, x)] = round((num / den) ** 0.5, 5) if den else 0.0
    return out


def phase_train_mesh_moe() -> dict:
    """deepseek-moe-16b at its published width, cut to 4 of 28 layers,
    trained by the sharded train step with its experts split over model on
    the (1, 2) and (2, 2) meshes over cuda:0 repeated, against the
    one-device make_train_step (see the module docstring, phase 21c).  The
    kernels' counts are set to 0 before each mesh's steps and read after
    them."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.distributed.sharding import param_shardings, shard_tree, tree_map, tree_paths
    from repro_torch.distributed.spmd import make_sharded_train_step, shard_train_state
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, clip_scale, global_norm
    from repro_torch.train.step import init_train_state, loss_and_grads, make_train_step

    synced = functools.partial(_synced, collect=True)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    arch, b, s = MOE_TRAIN_ARCH, MESH_TRAIN_B, MESH_TRAIN_S
    cfg = _rec_cfg(arch, MOE_TRAIN_LAYERS)
    n_moe = cfg.num_layers - cfg.first_k_dense
    e = cfg.num_experts
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    batch = make_global_batch(0, 0, b, s, cfg.vocab_size, device=dev)
    counters = _rec_counters()
    tally, patches = _kernel_tally(((fa, "flash_attention", "K3"),
                                    (fa, "flash_attention_bwd", "K3 bwd"),
                                    (rn, "rms_norm", "K5"), (rn, "rms_norm_bwd", "K5 bwd")))
    meshes = {shape: elastic_mesh(shape[0] * shape[1], model_parallel=shape[1], devices="cuda:0")
              for shape in MOE_MESHES}
    mesh22 = meshes[MOE_MESHES[-1]]
    checked = _rec_checked(None)
    log(f"[train-mesh-moe] {arch} d_model={cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} "
        f"of {cfg.head_dim}, {e} experts top-{cfg.top_k} of d_ff {cfg.moe_d_ff} (capacity factor "
        f"{cfg.capacity_factor}), {cfg.num_shared_experts} shared, first {cfg.first_k_dense} "
        f"dense (d_ff {cfg.dense_d_ff}), vocab {cfg.vocab_size}, {cfg.num_layers} of "
        f"{get_published_layers(arch)} layers (cut; {n_moe} moe), bf16 params, f32 moments, "
        f"remat; global B={b} S={s}, lr {TRAIN_LR}; meshes {list(meshes)} over cuda:0")

    out: dict = {}
    with _RouteLog() as routes:
        # ---- (a) one moe block's FFN alone on the same normed rows, tp 2 -------------
        _collected()
        lp = tree_map(torch.clone, lm.layer(lm.init_params(cfg, seed=0, device=dev)["moe_blocks"],
                                            0))
        gen = torch.Generator(device=dev).manual_seed(31)
        h = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
        out["layer"] = {}
        for dtype in (torch.bfloat16, torch.float32):
            out["layer"][str(dtype)[6:]] = _moe_layer_check(
                dataclasses.replace(cfg, dtype_name=str(dtype)[6:]),
                tree_map(lambda t: t if t.dtype == torch.float32 else t.to(dtype), lp), h.to(dtype),
                meshes[MOE_MESHES[0]], True, "train-mesh-moe")
        del lp, h
        _collected()
        # ---- the f32 yardstick, and (b') the f32 step split on (2, 2) ------------------
        params32 = tree_map(lambda t: t.float(), lm.init_params(cfg, seed=0, device=dev))
        cfg32 = dataclasses.replace(cfg, dtype_name="float32")
        routes.take()
        g32 = tree_map(lambda t: t.to("cpu"), loss_and_grads(params32, cfg32, batch)[1])
        (one32,) = _moe_passes(routes.take(), n_moe, 1, cfg.remat)
        sharded32 = shard_tree(params32, param_shardings(mesh22, params32))
        del params32
        _collected()
        step32 = make_sharded_train_step(cfg32, opt_cfg, mesh22)
        _, grads32 = step32.loss_and_grads(sharded32, batch)
        diff32 = _routing_diff(one32, _moe_passes(routes.take(), n_moe, mesh22.shape[0],
                                                  cfg.remat), e, s)
        flipped32 = {i: d["experts"] for i, d in enumerate(diff32) if d["experts"]}
        rel32, missed32 = {}, {}
        for (path, gs), (_, ref) in zip(tree_paths(grads32), tree_paths(g32)):
            got, ref = _agreeing(path, flipped32, gs.full(), ref.to(dev))
            rel32[path] = _rel(got, ref) if float(ref.norm()) else float(got.norm())
            if rel32[path] > MOE_STEP_F32_TOL:
                missed32[path] = rel32[path]
        log(f"[train-mesh-moe] (b') the step in f32 on (2, 2) against one device in f32: "
            f"(token, expert) assignments differing per moe layer "
            f"{[d['assignments'] for d in diff32]}; per gradient leaf ||dg||/||g|| "
            f"{ {k: float(f'{v:.3g}') for k, v in rel32.items()} }; worst "
            f"{max(rel32.values()):.3g} (bar {MOE_STEP_F32_TOL}); missed {missed32}")
        assert not missed32, missed32
        out["f32_step"] = {"routing": [d["assignments"] for d in diff32],
                           "worst": max(rel32.values())}
        del sharded32, grads32, step32
        _collected()
        # ---- one device: step 1's gradients, the optimizer (2, 2), steps 2-3 ----------
        torch.cuda.reset_peak_memory_stats()
        with _started(patches):
            for t in tally.values():
                t.clear()
            state = init_train_state(cfg, opt_cfg, seed=0, device=dev)
            (loss1, g1), wall1 = synced(lambda: loss_and_grads(state["params"], cfg, batch))
            (one,) = _moe_passes(routes.take(), n_moe, 1, cfg.remat)
            scale1 = clip_scale(opt_cfg, global_norm(g1))
            one_tally = {k: dict(v) for k, v in tally.items()}
            compared = _rec_optimizer_bitwise(cfg, state, g1, scale1, opt_cfg, mesh22)
            log(f"[train-mesh-moe] (b) (2, 2) AdamW on the one-device step-1 gradients sliced to "
                f"the placements, with its clip scale {float(scale1):.6g}, leaf by leaf against "
                f"adamw_update's arithmetic: [blocks, not bitwise equal] {compared} (bar: 0 "
                f"unequal)")
            assert all(bad == 0 for _, bad in compared.values()), compared
            step1 = make_train_step(cfg, opt_cfg)
            one_losses, walls = [float(loss1)], {"one device": [wall1]}
            for _ in range(2):
                (state, m), wall = synced(lambda: step1(state, batch))
                one_losses.append(float(m["loss"]))
                walls["one device"].append(wall)
            routes.take()
            peaks = {"one device": torch.cuda.max_memory_allocated()}
            del state
            g1 = tree_map(lambda t: t.to("cpu"), g1)
            torch.cuda.empty_cache()
            launches = {k: 0 for k in counters}
            run = {"losses": {"one device": one_losses}, "walls": walls, "peaks": peaks,
                   "splits": {}, "held": {}, "state_bytes": {}, "routing": {}}
            for shape, mesh in meshes.items():
                name = f"({shape[0]}, {shape[1]})"
                _collected()
                torch.cuda.reset_peak_memory_stats()
                run["held"][name] = torch.cuda.memory_allocated()
                sharded = shard_train_state(init_train_state(cfg, opt_cfg, seed=0, device=dev),
                                            mesh)
                run["state_bytes"][name] = _state_bytes(sharded)
                torch.cuda.empty_cache()
                step = make_sharded_train_step(cfg, opt_cfg, mesh, timed=True)
                assert (step.experts, step.attention, step.mlp) == ("experts", "heads", "columns")
                _zeroed(counters, tally)
                # ---- (b) step 1 against the one-device step --------------------------------
                (loss, grads), wall = synced(lambda: step.loss_and_grads(sharded["params"],
                                                                          batch))
                diff = _routing_diff(one, _moe_passes(routes.take(), n_moe, shape[0], cfg.remat),
                                     e, s)
                flipped = {i: d["experts"] for i, d in enumerate(diff) if d["experts"]}
                rel, missed = _grad_rules(grads, g1, g32, flipped, MESH_TRAIN_TOL)
                experts = _expert_errors(grads, g1, flipped)
                loss_rel = abs(float(loss) - one_losses[0]) / abs(one_losses[0])
                run["routing"][name] = [d["assignments"] for d in diff]
                log(f"[train-mesh-moe] {name} (b) step 1 from the same state: loss "
                    f"{float(loss):.6f} vs {one_losses[0]:.6f} (relative {loss_rel:.3g}); (token, "
                    f"expert) assignments differing from one device per moe layer "
                    f"{run['routing'][name]} of {b * s * cfg.top_k} each, rows touched "
                    f"{[d['rows'] for d in diff]}; the experts whose token sets differ (held by "
                    f"(a)), (layer, expert): ||dg||/||g|| of gate, up, down {experts}; every other "
                    f"leaf (split vs one device, split vs f32, one device vs f32) {rel}; worst "
                    f"split vs one device {max(r[0] for r in rel.values()):.3g}, worst (split - "
                    f"one device) vs f32 {max(r[1] - r[2] for r in rel.values()):.3g} (bar "
                    f"{MESH_TRAIN_TOL}: within it of one device where no routing differs; "
                    f"elsewhere the split adds at most it to one device's distance from f32, and "
                    f"is within it of one device where one device is within it of f32); missed "
                    f"{missed}")
                assert loss_rel <= MESH_TRAIN_TOL and not missed, (loss_rel, missed)
                splits = [dict(step.seconds)]
                opt_wall = synced(lambda: step.apply(sharded, grads))[1]
                splits[0].update(step.seconds)
                del grads
                walls[name] = [wall + opt_wall]
                losses = [float(loss)]
                (sharded, m), wall = synced(lambda: step(sharded, batch))
                walls[name].append(wall)
                splits.append(dict(step.seconds))
                losses.append(float(m["loss"]))
                (loss, grads), wall = synced(lambda: step.loss_and_grads(sharded["params"],
                                                                          batch))
                del grads
                routes.take()
                walls[name].append(wall)
                splits.append(dict(step.seconds))
                losses.append(float(loss))
                at = {k: c.value for k, c in counters.items()}
                mesh_tally = {k: dict(v) for k, v in tally.items()}
                peaks[name] = torch.cuda.max_memory_allocated()
                rels = [abs(a - w) / abs(w) for a, w in zip(losses, one_losses)]
                log(f"[train-mesh-moe] {name} (b) free-running losses, steps 1-3: {losses}, one "
                    f"device {one_losses}; relative {rels} (bar {MESH_TRAIN_TOL})")
                assert max(rels) <= MESH_TRAIN_TOL, rels
                # ---- (d) the kernels: routes, each position's heads, shapes checked ---------
                log(f"[train-mesh-moe] {name} (d) calls by shape {mesh_tally}; launches {at}")
                for key in tally:
                    calls = set(mesh_tally[key]) | set(one_tally[key])
                    assert calls <= checked[key], f"{key} shapes unchecked: {calls - checked[key]}"
                for key, counter in (("K3", "flash_attention"), ("K3 bwd", "flash_attention_bwd"),
                                     ("K5", "rms_norm"), ("K5 bwd", "rms_norm_bwd")):
                    assert sum(mesh_tally[key].values()) == at[counter], (key, mesh_tally, at)
                heads = {k[1:3] for key in ("K3", "K3 bwd") for k in mesh_tally[key]}
                assert heads == {(cfg.num_heads // shape[1], cfg.num_kv_heads // shape[1])}, heads
                assert at["flash_attention_tensor_core"] == at["flash_attention"] > 0, at
                assert at["flash_attention_bwd_tensor_core"] == at["flash_attention_bwd"] > 0, at
                assert at["rms_norm_resident"] == at["rms_norm"] > 0, at
                assert at["rms_norm_bwd_resident"] == at["rms_norm_bwd"] > 0, at
                for k2 in launches:
                    launches[k2] += at[k2]
                run["losses"][name] = losses
                run["splits"][name] = splits
                if mesh is mesh22:  # one more step, counted live for [dryrun]
                    (sharded, _), wall = synced(lambda: step(sharded, batch))
                    with routes.off():
                        sharded, run["counted"] = _counted_step(step, sharded, batch)
                    run["wall"] = wall
                    routes.take()
                del sharded
                torch.cuda.empty_cache()
    for name, ws in walls.items():
        log(f"[train-mesh-moe] {name} step walls (host clock, synchronized) "
            f"{[round(w, 4) for w in ws]} s -> {b * s / ws[-1]:.1f} tokens/s at the last")
    log(f"[train-mesh-moe] the sharded steps' split (s; gather / forward_backward / reduce / "
        f"optimizer; steps 1-3): {run['splits']}; state held over the positions (bytes) "
        f"{run['state_bytes']}; peak device memory (max_memory_allocated) by run: {peaks}; "
        f"allocated at each mesh's start (after a garbage collection): {run['held']}")
    del g1, g32
    run.update(cfg=cfg, opt_cfg=opt_cfg, batch=_on_meta(batch))
    log(f"[train-mesh-moe] launches over both meshes {launches}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s (host clock); card: {smi()}")
    return {"runs": {arch: run}, "launches": launches, **out}


def _moe_rows_differing(one: list, split: list, e: int, s: int) -> list[int]:
    """The batch rows whose routing differs from one device's at some moe
    layer (``split``: the data shards' routings, in order)."""
    rows = set()
    for d in _routing_diff(one, split, e, s):
        rows.update(d["rows"])
    return sorted(rows)


def _joined(split: list) -> list[tuple]:
    """The data shards' routings (``_moe_passes``) joined along the batch:
    one ``(fwd, slot_gate)`` a moe layer, as one device routes all rows."""
    return [tuple(torch.cat([shard[layer][j] for shard in split]) for j in range(2))
            for layer in range(len(split[0]))]


@contextlib.contextmanager
def _routed_as(routings: list[tuple]):
    """The one-device ``moe_route`` (``models/moe.py``) returning
    ``routings`` in call order in place of its own: a one-device run routed
    as the split was, which (c) holds the split to where the two routings
    differ.  Everything else (attention, the experts, combine, the cache)
    the run computes itself."""
    from unittest import mock

    from repro_torch.models import moe

    left = list(routings)

    def route(router, x, top_k, capacity_factor=1.25):
        fwd, slot_gate = left.pop(0)
        assert fwd.shape[0] == x.shape[0], (fwd.shape, x.shape)
        return fwd, slot_gate

    with mock.patch.object(moe, "moe_route", route):
        yield
    assert not left, len(left)


def phase_serve_mesh_moe() -> dict:
    """deepseek-moe-16b (4 of 28 layers) and arctic-480b (1 of 35) served
    by the sharded serving step with the experts split over model on
    (1, 2) and (2, 2) (arctic on (1, 2)) over cuda:0 repeated, against the
    one-device make_serve_prefill and make_serve_step, and against the
    one-device run routed as the split (see the module docstring, phase
    21d).  The kernels' counts are set to 0 before each mesh's timed
    prefill and read after its last decode step."""
    from unittest import mock

    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.distributed.sharding import param_shardings, shard_tree, tree_paths
    from repro_torch.distributed.spmd import ShardedServeStep, shard_cache
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.train.step import make_serve_prefill, make_serve_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    s, max_len, steps = SERVE_MESH_S, SERVE_MESH_MAX, SERVE_MESH_STEPS
    counters = _rec_counters()
    tally, patches = _kernel_tally(((ops, "flash_attention", "K3"),
                                    (ops, "rms_norm_kernel", "K5")))
    checked = _rec_checked(None)
    viewed, whole_calls = [], []
    real_view, real_whole = ShardedServeStep._view, ShardedServeStep._decode_whole

    def view(self, st, *args, **kwargs):
        viewed.append(id(st))
        return real_view(self, st, *args, **kwargs)

    def decode_whole(self, *args, **kwargs):
        whole_calls.append(1)
        return real_whole(self, *args, **kwargs)

    patches += [mock.patch.object(ShardedServeStep, "_view", view),
                mock.patch.object(ShardedServeStep, "_decode_whole", decode_whole)]

    def long_cache(cfg, prefilled, b):
        cache = lm.init_cache(cfg, b, max_len, dev)
        cache["k"][:, :, :, :s], cache["v"][:, :, :, :s] = prefilled["k"], prefilled["v"]
        cache["length"] = s
        return cache

    def alike(got, want, flipped: list[int]) -> float:
        """||d||/||l|| of the rows whose routing equals one device's (0 if none)."""
        rows = [r for r in range(got.shape[0]) if r not in flipped]
        return _rel(got[rows], want[rows]) if rows else 0.0

    launches = {k: 0 for k in counters}
    out: dict = {"runs": {}, "layer": {}}
    with _started(patches):
        with _RouteLog() as routes:
            for arch, layers, b, mesh_shapes in MOE_SERVE_RUNS:
                cfg = _rec_cfg(arch, layers)
                n_moe = cfg.num_layers - cfg.first_k_dense
                e = cfg.num_experts
                _collected()
                t0 = time.perf_counter()
                params = lm.init_params(cfg, seed=0, device=dev)
                torch.cuda.synchronize()
                t_init = time.perf_counter() - t0
                gen = torch.Generator(device=dev).manual_seed(43)
                batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                                 device=dev, dtype=torch.int32)}
                log(f"[serve-mesh-moe] {arch} d_model={cfg.d_model} heads {cfg.num_heads}/"
                    f"{cfg.num_kv_heads}, {e} experts top-{cfg.top_k}, {layers} of "
                    f"{get_published_layers(arch)} layers (cut), bf16, initialised in "
                    f"{t_init:.1f} s (host clock); B={b} prompts of {s}, {steps} decode steps from "
                    f"{s} in a cache of {max_len}; meshes {list(mesh_shapes)} over cuda:0")
                for t in tally.values():
                    t.clear()
                prefill1, decode1 = make_serve_prefill(cfg), make_serve_step(cfg)
                prefill1(params, batch)  # warm
                routes.take()
                (want, prefilled), wall = _synced(lambda: prefill1(params, batch))
                (one_prefill,) = _moe_passes(routes.take(), n_moe, 1, False)
                walls = {"one device": {"prefill": wall, "decode": []}}
                one = long_cache(cfg, prefilled, b)
                tokens, want_steps, one_steps = [want.argmax(-1, keepdim=True).int()], [], []
                for i in range(steps):
                    (logits, one), wall = _synced(lambda: decode1(params, one,
                                                                 {"tokens": tokens[i]}))
                    one_steps.append(_moe_passes(routes.take(), n_moe, 1, False)[0])
                    want_steps.append(logits)
                    walls["one device"]["decode"].append(wall)
                    tokens.append(logits.argmax(-1, keepdim=True).int())
                one_tally = {k: dict(v) for k, v in tally.items()}
                # ---- (a) one moe block's FFN alone on the prompt's rows (no grad) -----------
                gen = torch.Generator(device=dev).manual_seed(31)
                h = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
                out["layer"][arch] = _moe_layer_check(
                    cfg, lm.layer(params["moe_blocks"], 0), h, elastic_mesh(
                        2, model_parallel=2, devices="cuda:0"), False, "serve-mesh-moe")
                routes.take()
                del h
                run: dict = {"walls": walls, "copies": {}, "routing": {}, "errors": {}}
                for shape in mesh_shapes:
                    d, m = shape
                    name = f"({d}, {m})"
                    mesh = elastic_mesh(d * m, model_parallel=m, devices="cuda:0")
                    step = ShardedServeStep(cfg, mesh)
                    assert (step.experts, step.attention, step.mlp) == ("experts", "heads",
                                                                        "columns")
                    sharded = shard_tree(params, param_shardings(mesh, params))
                    if len(mesh_shapes) == 1:  # arctic: the sharded copy replaces it
                        del params
                        _collected()
                    step.prefill(sharded, batch)  # warm
                    routes.take()
                    _zeroed(counters, tally)
                    (got, cache), wall = _synced(lambda: step.prefill(sharded, batch))
                    walls[name] = {"prefill": wall, "decode": []}
                    at = {k: c.value for k, c in counters.items()}
                    split_prefill = _moe_passes(routes.take(), n_moe, d, False)
                    rows_prefill = _moe_rows_differing(one_prefill, split_prefill, e, s)
                    log(f"[serve-mesh-moe] {arch} {name} prefill ({step.experts}, "
                        f"{step.modes(s)}): calls by shape {tally}, launches {at}")
                    per = d * m  # one K3 launch per layer, data shard and model position
                    assert at["flash_attention_tensor_core"] == at["flash_attention"] == \
                        cfg.num_layers * per, at
                    heads = {k[1:3] for k in tally["K3"]}
                    assert heads == {(cfg.num_heads // m, cfg.num_kv_heads // m)}, heads
                    got_prefill = (got, {k: cache[k].full() for k in ("k", "v")})
                    del got
                    # ---- decode: the steps teacher-forced by the one-device tokens ----------
                    cache = shard_cache(long_cache(cfg, prefilled, b), mesh)
                    cache_ids = {id(st) for _, st in tree_paths(
                        {k: v for k, v in cache.items() if k != "length"})}
                    viewed.clear()
                    whole_calls.clear()
                    got_steps, split_steps, differing, agree, sure, n_rows = [], [], [], 0, 0, 0
                    for i in range(steps):
                        (got, cache), wall = _synced(lambda: step.decode(sharded, cache,
                                                                        {"tokens": tokens[i]}))
                        walls[name]["decode"].append(wall)
                        split_steps.append(_moe_passes(routes.take(), n_moe, d, False))
                        differing.append(_moe_rows_differing(one_steps[i], split_steps[-1], e, 1))
                        assert torch.isfinite(got).all(), (name, i)
                        agree, sure, n_rows = (a + c for a, c in zip(
                            (agree, sure, n_rows),
                            _greedy(got, want_steps[i], float((got - want_steps[i]).abs().max()))))
                        got_steps.append(got)
                    final = {k: cache[k].full() for k in ("k", "v")}
                    gathered = cache_ids & set(viewed)
                    log(f"[serve-mesh-moe] {arch} {name} decode, positions {s}-{s + steps - 1}: "
                        f"greedy tokens agreeing with one device's {agree} of {n_rows} (each of "
                        f"the {sure} whose one-device top-two gap exceeds twice its step's max "
                        f"|d| must); the one-device decode on the shard's first position "
                        f"(_decode_whole) ran {len(whole_calls)} times, cache tensors gathered "
                        f"(_view) {len(gathered)}: the cache's all-gather bytes are 0")
                    assert not whole_calls and not gathered, (whole_calls, gathered)
                    at = {k: c.value for k, c in counters.items()}
                    for k2 in launches:
                        launches[k2] += at[k2]
                    for key in tally:
                        calls = set(tally[key]) | set(one_tally[key])
                        assert calls <= checked[key], \
                            f"{key} shapes unchecked: {calls - checked[key]}"
                    assert sum(tally["K5"].values()) == at["rms_norm"]
                    assert at["rms_norm_resident"] == at["rms_norm"] > 0, at
                    if arch == MOE_TRAIN_ARCH and shape == MOE_MESHES[-1]:  # counted live
                        pos = run["counted_length"] = cache["length"]
                        with routes.off():
                            (_, cache), run["counted_decode"] = _counted(
                                step.decode, sharded, cache, {"tokens": tokens[-1]})
                            _, run["counted_prefill"] = _counted(step.prefill, sharded, batch)
                        run["copies"] = {k: {c: v for c, v in run[f"counted_{k}"]["totals"][
                            "collectives"].items() if v} for k in ("prefill", "decode")}
                        log(f"[serve-mesh-moe] {arch} {name} noted copy bytes by kind, one "
                            f"prefill / one decode step (at {pos}): {run['copies']['prefill']} / "
                            f"{run['copies']['decode']}")
                    del sharded, cache, step
                    _collected()
                    # ---- (c) the one-device run routed as the split, from the same prompts
                    # and fed the same tokens: the prefill, then the decode steps
                    if len(mesh_shapes) == 1:  # the same seed: the same parameters
                        params = lm.init_params(cfg, seed=0, device=dev)
                    with _routed_as(_joined(split_prefill)):
                        ref, ref_cache = prefill1(params, batch)
                    ref_one, ref_steps = long_cache(cfg, prefilled, b), []  # the split's start
                    with _routed_as([r for split in split_steps for r in _joined(split)]):
                        for i in range(steps):
                            logits, ref_one = decode1(params, ref_one, {"tokens": tokens[i]})
                            ref_steps.append(logits)
                    got, got_cache = got_prefill
                    errs = {"prefill logits": _rel(got, ref),
                            "prefill cache": max(_rel(got_cache[k], ref_cache[k])
                                                 for k in ("k", "v")),
                            "decode logits": [round(_rel(g, r), 6)
                                              for g, r in zip(got_steps, ref_steps)],
                            "decode cache, written slots": max(
                                _rel(final[k][:, :, :, s:s + steps],
                                     ref_one[k][:, :, :, s:s + steps]) for k in ("k", "v"))}
                    for k in ("k", "v"):  # the prompt's slots and the empty ones: untouched
                        final[k][:, :, :, s:s + steps] = ref_one[k][:, :, :, s:s + steps]
                    rest = all(torch.equal(final[k], ref_one[k]) for k in ("k", "v"))
                    plain = {"prefill logits": _rel(got, want),
                             "prefill logits, rows alike": alike(got, want, rows_prefill),
                             "decode logits": [round(_rel(g, w), 6)
                                               for g, w in zip(got_steps, want_steps)],
                             "decode logits, rows alike": [
                                 round(alike(g, w, rows), 6)
                                 for g, w, rows in zip(got_steps, want_steps, differing)]}
                    shown = [{k: v if isinstance(v, list) else round(v, 6) for k, v in x.items()}
                             for x in (errs, plain)]
                    worst = max(max(v) if isinstance(v, list) else v for v in errs.values())
                    worst_alike = max(plain["prefill logits, rows alike"],
                                      *plain["decode logits, rows alike"])
                    log(f"[serve-mesh-moe] {arch} {name} (c) rows whose routing differs from "
                        f"one device's at some layer: prefill {rows_prefill} of {b}, each decode "
                        f"step {differing}; ||d||/||ref|| against the one-device run routed as "
                        f"the split (prefill logits and cache blocks, each decode step's logits, "
                        f"the cache's written slots after the last step) {shown[0]}, worst "
                        f"{worst:.4g}, the cache's other slots bitwise its {rest}; against the "
                        f"one-device run (its own routing) {shown[1]}, worst over the rows whose routing agrees {worst_alike:.4g} (bar "
                        f"{SERVE_MESH_TOL}: every row within it of the run routed as the split, "
                        f"the rows routed alike within it of the one-device run too)")
                    assert worst <= SERVE_MESH_TOL and worst_alike <= SERVE_MESH_TOL, (errs, plain)
                    assert rest
                    run["errors"][name] = {"routed as the split": worst, "rows alike": worst_alike}
                    run["routing"][name] = {"prefill rows": rows_prefill,
                                            "decode rows": [len(r) for r in differing],
                                            "agree": agree, "rows": n_rows}
                    del got, got_cache, got_prefill, got_steps, final, ref, ref_cache, ref_one
                    del ref_steps, split_steps
                    torch.cuda.empty_cache()
                for name, w in walls.items():
                    log(f"[serve-mesh-moe] {arch} {name}: prefill {w['prefill']:.4f} s, decode "
                        f"step mean {sum(w['decode']) / len(w['decode']):.4f} s (min "
                        f"{min(w['decode']):.4f}, max {max(w['decode']):.4f}; host clock, "
                        f"synchronized)")
                run.update(cfg=cfg, batch=_on_meta(batch), max_len=max_len)
                out["runs"][arch] = run
                del one, prefilled, params
                _collected()
    log(f"[serve-mesh-moe] launches over both runs' meshes' timed prefill and decode steps "
        f"{launches}; phase wall {time.perf_counter() - t_phase:.1f} s (host clock); card: {smi()}")
    out["launches"] = launches
    return out


PEAK_BAR = (0.90, 1.10)  # measured over planned peak of a one-device train step
SWEEP_MESH = "single"  # the production sweep's meshes in [dryrun] (--mesh both takes >90 s)


def _start_sweep(outdir: str):
    """The dry-run's production sweep as a process of its own (it touches
    no device), its output to a file in ``outdir``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = open(os.path.join(outdir, "sweep.log"), "w")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
                             SWEEP_MESH, "--no-hlo", "--out", outdir], stdout=out,
                            stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    return proc, out, time.perf_counter()


def _held_to_meta(name: str, counted: dict, planned: dict, wall: float, peak: bool) -> dict:
    """(a), (c), (d) for one step: the live count against the plan."""
    from repro_torch.perf import hlo_cost

    live = counted["totals"]
    same = {k: (live[k], planned[k]) for k in ("flops", "bytes", "collective_bytes")}
    log(f"[dryrun] (a) {name}: counted live on the card / on meta: "
        + ", ".join(f"{k} {a} / {b}" for k, (a, b) in same.items())
        + f"; transcendentals {live['transcendentals']} / {planned['transcendentals']}; kernel "
          f"calls {live['kernels']} / {planned['kernels']}; collectives "
          f"{live['collective_counts']} / {planned['collective_counts']}")
    assert all(a == b for a, b in same.values()), (name, same)
    assert live["kernels"] == planned["kernels"], (name, live["kernels"], planned["kernels"])
    ratio = counted["peak"] / planned["peak_bytes"]
    log(f"[dryrun] (c) {name}: max_memory_allocated {counted['peak']} B against the planned "
        f"peak_bytes {planned['peak_bytes']} B (arguments {planned['argument_bytes']} B planned, "
        f"{counted['allocated_before']} B allocated before the step): ratio {ratio:.4f}"
        + (f" (bar {PEAK_BAR[0]}-{PEAK_BAR[1]})" if peak else " (not asserted: its positions run "
           "one after another on one card)"))
    if peak:
        assert PEAK_BAR[0] <= ratio <= PEAK_BAR[1], (name, ratio)
    roof = hlo_cost.roofline_terms(planned)
    log(f"[dryrun] (d) {name}: roofline bound_s {roof['bound_s']:.4f} ({roof['dominant']}; "
        f"compute {roof['compute_s']:.4f}, memory {roof['memory_s']:.4f}, collective "
        f"{roof['collective_s']:.4f}), step wall {wall:.4f} s (host clock, synchronized): "
        f"wall / bound {wall / roof['bound_s']:.3f}")
    return {"flops": live["flops"], "bytes": live["bytes"],
            "collective_bytes": live["collective_bytes"], "peak": counted["peak"],
            "planned_peak": planned["peak_bytes"], "peak_ratio": ratio,
            "bound_s": roof["bound_s"], "dominant": roof["dominant"], "wall_s": wall}


def _hook_cost(reps: int = 2000) -> dict[str, float]:
    """Host microseconds per call of K5 at a decode step's rows ([4, 5120]
    bf16): its wrapper called directly, as the port calls it (the meta
    route's note and device test included), and through a
    ``torch.library.custom_op`` around it with a fake for ``meta``, the
    dispatcher route the planner could have taken instead; each the
    fastest of two synchronized runs of ``reps`` calls, in turns."""
    from repro_torch.kernels import rms_norm as rn

    dev = torch.device("cuda")
    x = torch.randn((4, 5120), device=dev).to(torch.bfloat16)
    scale = torch.zeros(5120, dtype=torch.bfloat16, device=dev)

    @torch.library.custom_op("atlas_probe::rms_norm", mutates_args=())
    def op(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return rn.rms_norm(x, scale)

    @op.register_fake
    def _(x, scale):
        return torch.empty_like(x)

    took: dict[str, list] = {}
    for name, fn in (("direct", rn.rms_norm), ("custom_op", op)) * 2:
        fn(x, scale)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x, scale)
        torch.cuda.synchronize()
        took.setdefault(name, []).append((time.perf_counter() - t0) / reps * 1e6)
    return {k: min(v) for k, v in took.items()}


def _held_serve_counts(serve_mesh: dict) -> dict:
    """[serve-mesh]'s (2, 2) prefill and decode step, counted live there,
    held to the planner's count on meta (one data shard per row count)."""
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.launch import dryrun
    from repro_torch.perf import hlo_cost

    out = {}
    mesh = elastic_mesh(4, model_parallel=2, devices="cuda:0")
    prompt = serve_mesh["batch"]
    for kind, batch, max_len in (("prefill", prompt, SERVE_MESH_S),
                                 ("decode", {k: v[:, :1] for k, v in prompt.items()},
                                  SERVE_MESH_MAX)):
        t0 = time.perf_counter()
        planned = hlo_cost.analyze(dryrun.count_serve_step(serve_mesh["cfg"], kind, batch, mesh,
                                                           max_len))
        name = f"{MESH_TRAIN_ARCH} (2, 2) serve {kind}"
        log(f"[dryrun] {name} planned on meta (one data shard per row count) in "
            f"{time.perf_counter() - t0:.2f} s (host clock)")
        walls = serve_mesh["walls"]["(2, 2)"]
        wall = walls["prefill"] if kind == "prefill" else sum(walls["decode"]) / len(walls["decode"])
        out[name] = _held_to_meta(name, serve_mesh["counted"][f"(2, 2) {kind}"], planned, wall,
                                  peak=False)
    return out


def _held_rec_counts(train_rec: dict, serve_rec: dict) -> dict:
    """[train-mesh-rec]'s and [serve-mesh-rec]'s (2, 2) steps, counted live
    there, held to the planner's count of the same steps on meta (one data
    shard per row count, one optimizer position per signature)."""
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.launch import dryrun
    from repro_torch.perf import hlo_cost

    out = {}
    d, m = REC_MESHES[-1]
    mesh = elastic_mesh(d * m, model_parallel=m, devices="cuda:0")
    for arch, run in train_rec["runs"].items():
        t0 = time.perf_counter()
        planned = hlo_cost.analyze(dryrun.count_train_step(run["cfg"], run["opt_cfg"],
                                                            run["batch"], mesh))
        name = f"{arch} ({d}, {m}) train"
        log(f"[dryrun] {name} planned on meta in {time.perf_counter() - t0:.2f} s (host clock)")
        out[name] = _held_to_meta(name, run["counted"], planned, run["wall"], peak=False)
    for arch, run in serve_rec["runs"].items():
        prompt = run["batch"]
        seq = next(iter(prompt.values())).shape[1]
        walls = run["walls"][f"({d}, {m})"]
        for kind, batch, max_len, wall in (
                ("prefill", prompt, seq, walls["prefill"]),
                ("decode", {k: v[:, :1] for k, v in prompt.items()}, run["max_len"],
                 sum(walls["decode"]) / len(walls["decode"]))):
            t0 = time.perf_counter()
            # at the live call's length: it picks the block the new keys go to
            planned = hlo_cost.analyze(dryrun.count_serve_step(
                run["cfg"], kind, batch, mesh, max_len, length=run["counted_length"]))
            name = f"{arch} ({d}, {m}) serve {kind}"
            log(f"[dryrun] {name} planned on meta in {time.perf_counter() - t0:.2f} s (host clock)")
            out[name] = _held_to_meta(name, run[f"counted_{kind}"], planned, wall, peak=False)
    return out


def _held_moe_counts(train_moe: dict, serve_moe: dict) -> dict:
    """[train-mesh-moe]'s (2, 2) step and [serve-mesh-moe]'s (2, 2) prefill
    and decode step of deepseek-moe-16b, counted live there, held to the
    planner's count on meta; and the decode's copies, planned in twice the
    cache, equal to the live ones: no cache block is gathered."""
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.launch import dryrun
    from repro_torch.perf import hlo_cost

    run = serve_moe["runs"][MOE_TRAIN_ARCH]
    out = _held_rec_counts(train_moe, {"runs": {MOE_TRAIN_ARCH: run}})
    d, m = MOE_MESHES[-1]
    longer = hlo_cost.analyze(dryrun.count_serve_step(
        run["cfg"], "decode", {k: v[:, :1] for k, v in run["batch"].items()},
        elastic_mesh(d * m, model_parallel=m, devices="cuda:0"), 2 * run["max_len"],
        length=run["counted_length"]))["collectives"]
    live = run["counted_decode"]["totals"]["collectives"]
    log(f"[dryrun] {MOE_TRAIN_ARCH} ({d}, {m}) serve decode: copy bytes by kind counted live in "
        f"{run['max_len']} slots {live}, planned in {2 * run['max_len']} {longer}: equal, so no "
        f"cache block is gathered")
    assert live == longer, (live, longer)
    return out


def phase_dryrun(train: dict, train_mesh: dict, serve_mesh: dict, sweep, train_rec: dict,
                 serve_rec: dict, train_moe: dict, serve_moe: dict) -> dict:
    """The planner against the card (see the module docstring, phase 22)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.distributed.sharding import batch_shardings
    from repro_torch.distributed.spmd import make_sharded_train_step, shard_train_state
    from repro_torch.launch import dryrun
    from repro_torch.perf import hlo_cost
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    out = {}
    for arch, run in train["runs"].items():
        t0 = time.perf_counter()
        planned = hlo_cost.analyze(dryrun.count_train_step(run["cfg"], run["opt_cfg"],
                                                            run["batch"]))
        log(f"[dryrun] {arch} ({run['cfg'].num_layers} layers) planned on meta in "
            f"{time.perf_counter() - t0:.2f} s (host clock)")
        out[arch] = _held_to_meta(arch, run["counted"], planned, run["wall"], peak=True)

    # qwen2-7b, [train-mesh]'s cut: one device, then the (4, 2) mesh
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(MESH_TRAIN_ARCH), num_layers=MESH_TRAIN_LAYERS)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    batch = make_global_batch(0, 0, MESH_TRAIN_B, MESH_TRAIN_S, cfg.vocab_size, device=dev)
    meta_batch = _on_meta(batch)
    torch.cuda.empty_cache()
    step1 = make_train_step(cfg, opt_cfg)
    state = init_train_state(cfg, opt_cfg, seed=0, device=dev)
    state, _ = step1(state, batch)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step1(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    state, counted = _counted_step(step1, state, batch)
    planned = hlo_cost.analyze(dryrun.count_train_step(cfg, opt_cfg, meta_batch))
    out[f"{MESH_TRAIN_ARCH} one device"] = _held_to_meta(
        f"{MESH_TRAIN_ARCH} one device", counted, planned, wall, peak=True)

    mesh = elastic_mesh(8, model_parallel=MESH_TRAIN_MESHES[0][1], devices="cuda:0")
    sharded = shard_train_state(state, mesh)
    del state
    torch.cuda.empty_cache()
    step42 = make_sharded_train_step(cfg, opt_cfg, mesh)
    sharded, _ = step42(sharded, batch)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded, _ = step42(sharded, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sharded, counted = _counted_step(step42, sharded, batch)
    del sharded
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    planned = hlo_cost.analyze(dryrun.count_train_step(cfg, opt_cfg, meta_batch, mesh))
    log(f"[dryrun] {MESH_TRAIN_ARCH} (4, 2) planned on meta (one shard and one position per "
        f"signature) in {time.perf_counter() - t0:.2f} s (host clock)")
    out[f"{MESH_TRAIN_ARCH} (4, 2)"] = _held_to_meta(f"{MESH_TRAIN_ARCH} (4, 2)", counted,
                                                     planned, wall, peak=False)
    # (b) the plan's argument bytes over the positions: the state and the batch's blocks
    per_position = dryrun.train_argument_bytes(cfg, opt_cfg, mesh, meta_batch)
    held = train_mesh["state_bytes"][MESH_TRAIN_MESHES[0]]
    placements = batch_shardings(mesh, batch)
    batch_blocks = sum(_nbytes(v[placements[k].block(tuple(v.shape), p)])
                       for k, v in batch.items() for p in range(mesh.size))
    log(f"[dryrun] (b) (4, 2): planned argument bytes {per_position} B a position x "
        f"{mesh.size} = {per_position * mesh.size} B; [train-mesh]'s state held over the "
        f"positions {held} B + the batch's blocks {batch_blocks} B = {held + batch_blocks} B")
    assert per_position * mesh.size == held + batch_blocks, (per_position, held, batch_blocks)

    out.update(_held_serve_counts(serve_mesh))
    out.update(_held_rec_counts(train_rec, serve_rec))
    out.update(_held_moe_counts(train_moe, serve_moe))

    # the host cost of the kernels' meta route against a custom_op's dispatch
    hook = _hook_cost()
    calls = 4 * get_config("qwen3-14b").num_layers + 1  # ln1, ln2, q- and k-norm a layer; final
    log(f"[dryrun] K5 at [4,5120] bf16, host us per call (synchronized, fastest of 2 x 2000): "
        f"the wrapper directly {hook['direct']:.2f}, through a torch.library.custom_op "
        f"{hook['custom_op']:.2f}; qwen3-14b's decode step makes {calls} K5 calls: "
        f"+{(hook['custom_op'] - hook['direct']) * calls / 1e3:.3f} ms a step through the "
        f"custom_op")
    out["hook_us"] = hook

    # (e) the production sweep
    proc, fh, t_sweep = sweep
    rc = proc.wait(timeout=600)
    fh.close()
    outdir = os.path.dirname(fh.name)
    lines = open(fh.name).read().splitlines()
    recs = [json.load(open(os.path.join(outdir, f))) for f in sorted(os.listdir(outdir))
            if f.endswith(".json")]
    counts = {k: sum(r["status"] == k for r in recs) for k in ("ok", "skip", "fail")}
    skipped = sorted((r["arch"], r["shape"]) for r in recs if r["status"] == "skip")
    full_attention = sorted((r["arch"], "long_500k") for r in recs if r["shape"] == "long_500k"
                            and not get_config(r["arch"]).sub_quadratic)
    log(f"[dryrun] (e) the sweep (--mesh {SWEEP_MESH} --no-hlo, published configs): exit {rc}, "
        f"{counts} of {len(recs)} cells; {lines[-1] if lines else ''}; its process "
        f"{time.perf_counter() - t_sweep:.1f} s from its start (host clock, beside [train] and "
        f"[train-mesh]); skipped {skipped}")
    assert rc == 0 and counts["fail"] == 0 and counts["ok"] > 0, (rc, counts)
    assert skipped == full_attention, (skipped, full_attention)
    print(json.dumps({"dryrun_phase": {**out, "sweep": counts}}), flush=True)
    log(f"[dryrun] card: {smi()}")
    return out


_TRAIN_FAMILIES = {  # device kernel names of K3, K4 and K5 forward and backward, every route
    "K3 fwd": ("flash_kernel", "flash_tc_kernel"),
    "K3 bwd": ("dq_kernel", "dkdv_kernel", "dkdv_sum_kernel", "dq_tc_kernel", "dkdv_tc_kernel",
               "dkdv_tc_wide_kernel", "dkdv_tc_sum_kernel"),
    "K4 fwd": ("ssd_kernel", "chunk_states_kernel", "state_pass_kernel", "chunk_scan_kernel"),
    "K4 bwd": ("ssd_bwd_states_kernel", "ssd_bwd_chunk_kernel", "ssd_bwd_head_sum_kernel",
               "ssd_bwd_tc_states_kernel", "ssd_bwd_tc_carry_kernel", "ssd_bwd_tc_chunk_kernel",
               "ssd_bwd_tc_da_kernel"),
    "K5 fwd": ("rms_kernel", "rms_resident_kernel"),
    "K5 bwd": ("rms_bwd_kernel", "rms_bwd_reduce_kernel", "rms_bwd_resident_kernel",
               "rms_bwd_partial_sum_kernel"),
    "K6 fwd": ("rglru_chunk_kernel",),
    "K6 bwd": ("rglru_chunk_bwd_kernel",),
}


def _train_step_split(step, state, batch) -> str:
    """One train step's wall time (host clock) beside the card's busy time
    in it (kernel self time, torch.profiler) and K3's, K4's and K5's
    forward and backward shares of that busy time."""
    t0 = time.perf_counter()
    events = _device_kernels(lambda: step(state, batch))
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms <= 0:
        return f"wall {wall_ms:.2f} ms, device busy not measured (no device time in the trace)"
    shares = {
        k: sum(e.self_device_time_total for e in events
               if any(name in e.key for name in names)) / 1e3
        for k, names in _TRAIN_FAMILIES.items()
    }
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return (f"wall {wall_ms:.2f} ms (traced), device busy {busy_ms:.2f} ms "
            f"({busy_ms / wall_ms:.3f} of the wall) in {sum(e.count for e in events)} device "
            f"kernels; of the busy time " + ", ".join(
                f"{k} {v:.3f} ms ({v / busy_ms:.3f})" for k, v in shares.items())
            + "; the 8 largest by device time: " + "; ".join(
                f"{e.key[:70]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms" for e in top))


_KERNEL_FAMILIES = {  # device kernel names of K3, K4, K5 (both routes each) and K6
    "K3": ("flash_kernel", "flash_tc_kernel"),
    "K4": ("ssd_kernel", "chunk_states_kernel", "state_pass_kernel", "chunk_scan_kernel"),
    "K5": ("rms_kernel", "rms_resident_kernel"),
    "K6": ("rglru_chunk_kernel",),
}


def _device_kernels(fn, reps: int = 1) -> list:
    """torch.profiler's per-kernel averages (with device time) over
    ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.self_device_time_total > 0]


def _prefill_split(cfg, params, prompts) -> str:
    """One wave's prefill: its wall time (host clock, untraced) beside the
    card's busy time in it (kernel self time from torch.profiler) and the
    share of K3, K4 and K5 in that busy time."""
    from repro_torch.models import lm

    inputs = _left_padded(prompts, torch.device("cuda"))  # tokens or embeddings
    lm.prefill(params, cfg, inputs)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm.prefill(params, cfg, inputs)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_kernels(lambda: lm.prefill(params, cfg, inputs))
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms <= 0:
        return f"wall {wall_ms:.2f} ms, device busy not measured (no device time in the trace)"
    shares = {
        k: sum(e.self_device_time_total for e in events
               if any(name in e.key for name in names)) / 1e3
        for k, names in _KERNEL_FAMILIES.items()
    }
    return (f"B={inputs.shape[0]} S={inputs.shape[1]}: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms in {sum(e.count for e in events)} device kernels; of it "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in shares.items()))


def _decode_step_split(cfg, params, batch: int, pos: int, steps: int = 3) -> str:
    """One decode step's wall time (host clock, untraced) beside the
    card's busy time in it (kernel self time from torch.profiler), the
    number of device kernels it runs and the idle share that leaves.  It
    feeds token 0, or to a model that takes embeddings token 0's row of
    ``lm_head``, as ServingEngine's decode does (``[B, 1, d_model]``)."""
    from repro_torch.models import lm

    dev = torch.device("cuda")
    cache = lm.init_cache(cfg, batch, pos + 2 * steps + 1, dev)
    cache["length"] = pos
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    if cfg.input_mode != "tokens":
        tok = params["lm_head"].T[tok[:, 0].long()].to(torch.float32)[:, None]
    lm.decode_step(params, cfg, cache, tok)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        lm.decode_step(params, cfg, cache, tok)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = _device_kernels(lambda: lm.decode_step(params, cfg, cache, tok), steps)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    kernels = sum(e.count for e in events) / steps
    if busy_ms <= 0:
        return f"wall {wall_ms:.2f} ms, device busy not measured (no device time in the trace)"
    return (f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms in {kernels:.0f} device "
            f"kernels, idle share {1 - busy_ms / wall_ms:.3f}")


def phase_examples(workdir: str) -> None:
    """The examples on the card, each in a process of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {
        "distributed_gnn": ["examples/torch_distributed_gnn.py"],
        "serve_lm": ["examples/torch_serve_lm.py", "--arch", "recurrentgemma-9b", "--batch", "2",
                     "--prompt-len", "16", "--tokens", "4"],
        "train_lm": ["examples/torch_train_lm.py", "--steps", "3", "--batch", "2", "--seq", "16",
                     "--ckpt", os.path.join(workdir, "ckpt"), "--ckpt-every", "3"],
    }
    for name, args in runs.items():
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=300)
        lines = out.stdout.strip().splitlines()
        log(f"[examples] {name}: exit {out.returncode} in {time.perf_counter() - t0:.1f}s "
            f"(host clock, the process's start included): {' | '.join(lines[-4:])}")
        assert out.returncode == 0 and lines[-1] == "== OK", f"{name}: {out.stdout}{out.stderr}"
        if name == "serve_lm":
            launched = json.loads(next(ln for ln in lines if "kernel launches" in ln)
                                  .split("kernel launches", 1)[1])
            assert all(launched[k] > 0 for k in ("K3", "K5", "K6")), launched


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vertices", type=int, default=200_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    walls: dict[str, float] = {}

    def mark(name: str) -> None:
        """The host-clock wall since the last mark, under ``name``."""
        walls[name] = round(time.perf_counter() - t_start - sum(walls.values()), 1)

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    phase_build()
    mark("build")
    phase_k1(args.vertices)
    k2 = phase_k2(args.vertices)
    mark("K1, K2")
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        by_model, k1, e2e = phase_e2e(args.vertices, workdir)
        phase_publish(e2e, workdir)  # after infer's timed window
        phase_dist(e2e, workdir)
        mesh = phase_mesh(args.vertices)
        phase_gather(e2e)
        del e2e
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # [e2e]'s three models, GraphSAGE, GCN and GIN
    for entry in (k1, k2):
        entry["launches_by_model"] = {kind: n[entry["name"]] for kind, n in by_model.items()}
        entry["launches"] = sum(entry["launches_by_model"].values())
    k1["mesh_launches"] = mesh["launches"]["edge_block_spmm"]
    k2["mesh_launches"] = mesh["launches"]["fused_graduate"]
    mark("e2e, publish, dist, mesh, gather")
    k5s = phase_k5()
    k5, k5_general = k5s["rms_norm"], k5s["rms_norm_general"]
    k3 = phase_k3()
    k4 = phase_k4()
    k6 = phase_k6()
    mark("K5, K3, K4, K6")
    phase_lm_check()
    mark("lm-check")
    served = phase_lm_serve()
    mark("lm-serve")
    for entry in (k3["flash_attention"], k4, k6["rglru_scan"]):
        entry["launches"] = served["total"][entry["name"]]
    # K5's launches by route: the general ones musicgen's and starcoder2's
    for entry, route in ((k5, "rms_norm_resident"), (k5_general, "rms_norm_general")):
        entry["launches"] = served["total"][route]
        entry["launches_by_model"] = {arch: n[route] for arch, n in served["by_arch"].items()
                                      if n[route]}
    # the windowed K3's launches: recurrentgemma's, all on the tensor-core route
    k3["flash_attention_windowed"]["launches"] = \
        served["by_arch"]["recurrentgemma-9b"]["flash_attention_tc"]
    k5_bwd = phase_k5_bwd()
    k3_bwd = phase_k3_bwd()
    k4_bwd = phase_k4_bwd()
    mark("K5-bwd, K3-bwd, K4-bwd")
    workdir = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        phase_train_check(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    mark("train-check")
    sweep_dir = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    shutil.rmtree(sweep_dir, ignore_errors=True)
    os.makedirs(sweep_dir)
    sweep = _start_sweep(sweep_dir)
    try:
        train = phase_train()
        mark("train")
        workdir = os.path.join(ROOT, "build", "chip_smoke_train_mesh")
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        try:
            train_mesh = phase_train_mesh(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        mark("train-mesh")
        serve_mesh = phase_serve_mesh()
        mark("serve-mesh")
        train_rec = phase_train_mesh_rec()
        mark("train-mesh-rec")
        serve_rec = phase_serve_mesh_rec()
        mark("serve-mesh-rec")
        train_moe = phase_train_mesh_moe()
        mark("train-mesh-moe")
        serve_moe = phase_serve_mesh_moe()
        mark("serve-mesh-moe")
        phase_dryrun(train, train_mesh, serve_mesh, sweep, train_rec, serve_rec, train_moe,
                     serve_moe)
        mark("dryrun")
    finally:
        if sweep[0].poll() is None:
            sweep[0].kill()
            sweep[0].wait()
        sweep[1].close()
        shutil.rmtree(sweep_dir, ignore_errors=True)
    workdir = os.path.join(ROOT, "build", "chip_smoke_examples")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        phase_examples(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    mark("examples")
    for entry in (k3_bwd["flash_attention_bwd"], k4_bwd, k5_bwd, k6["rglru_scan_bwd"]):
        # summed over [train]'s runs, and each run's
        entry["launches"] = train["launches"][entry["name"]]
        entry["launches_by_model"] = train["by_model"][entry["name"]]
    # the windowed K3 backward's launches: recurrentgemma's, all on the tensor-core route
    k3_bwd["flash_attention_windowed_bwd"]["launches"] = \
        train["by_model"]["flash_attention_bwd_tensor_core"]["recurrentgemma-9b"]
    # [train-mesh]'s sharded steps: K3 on the tensor cores at 14/2 heads, K5 resident at 3584
    for entry in (k3["flash_attention"], k3_bwd["flash_attention_bwd"], k5, k5_bwd):
        entry["train_mesh_launches"] = train_mesh["launches"][entry["name"]]
    # [serve-mesh]'s sharded prefill and decode: K3 on the tensor cores at 14/2 heads, K5 resident
    for entry in (k3["flash_attention"], k5):
        entry["serve_mesh_launches"] = serve_mesh["launches"][entry["name"]]
    # [train-mesh-rec]'s and [serve-mesh-rec]'s split ssm and hybrid steps: K3 (windowed, on
    # the tensor cores at recurrentgemma's sequence blocks), K4 (tensor cores, 40 heads a B/C
    # row), K5 (resident) and K6 (2048 channels)
    for entry in (k3["flash_attention_windowed"], k3_bwd["flash_attention_windowed_bwd"], k4,
                  k4_bwd, k5, k5_bwd, k6["rglru_scan"], k6["rglru_scan_bwd"]):
        entry["train_mesh_rec_launches"] = train_rec["launches"][entry["name"].replace(
            "_windowed", "")]
    for entry in (k3["flash_attention_windowed"], k4, k5, k6["rglru_scan"]):
        entry["serve_mesh_rec_launches"] = serve_rec["launches"][entry["name"].replace(
            "_windowed", "")]
    # [train-mesh-moe]'s and [serve-mesh-moe]'s split moe steps: K3 on the tensor cores at each
    # position's heads (deepseek-moe's 8/8, arctic's 28/4), K5 resident at 2048 and 7168
    for entry in (k3["flash_attention"], k3_bwd["flash_attention_bwd"], k5, k5_bwd):
        entry["train_mesh_moe_launches"] = train_moe["launches"][entry["name"]]
    for entry in (k3["flash_attention"], k5):
        entry["serve_mesh_moe_launches"] = serve_moe["launches"][entry["name"]]
    log(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f} s (host clock, "
        f"the kernels' build included); walls by phase (s) {walls}")
    log(json.dumps({"kernels": [k1, k2, k3["flash_attention"], k4, k5, k5_general,
                                k3_bwd["flash_attention_bwd"],
                                k4_bwd, k5_bwd, k3["flash_attention_windowed"],
                                k3_bwd["flash_attention_windowed_bwd"], k6["rglru_scan"],
                                k6["rglru_scan_bwd"]]}))
    log(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
