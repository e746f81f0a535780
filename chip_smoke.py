#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repo root, on a machine with one NVIDIA GPU

Phases, each printed as it runs; any failure raises and exits nonzero:
  1. device   — torch's device name and nvidia-smi's name and power limit;
  2. build    — nvcc builds kernels K1 (embedding bag), K2 (dot interaction),
                K3 (hot-cache probe + gather + pool), K4 (swap-in scatter),
                K5 (top-k neighbor select), K6 (flash attention), K6' (its
                backward) and K7 (flash decode) from src/repro_torch/csrc/,
                one nvcc per source, all in parallel (with K1''s planted
                fault for phase 5f and K6''s for phase 9g beside them), and
                prints each kernel's -Xptxas -v registers, spills and
                performance warnings; a spill in K6''s bf16 kernels fails;
  3. kernels  — each kernel against its plain PyTorch version on the card, at
                the main paths' shapes (TF32 off): K1 in its masked and
                weighted modes, f32 and bf16, with NaN in the rows behind
                zero-weight slots (masked: finite; weighted: NaN where the
                plain version has it), and at nnz 1, 3, 4, 8, 1003 bags,
                ids outside [0, V), D 17 and 256; K1/K2 in f32 and bf16 (K2
                also at every serve bucket [32..1024, 17, 64] and at
                [3, 40, 512], and timed at the buckets beside torch.bmm); K3
                on dlrm-flexemr's 2048-request batch over a 2^18-slot cache,
                f32 and bf16 rows, and at nnz 1, 3, 4, 8, 1003 bags, caches
                of 1, 4 and 1024 slots, ids cold, negative and past every
                row, D 17; K4 at the cache build's writes and with
                repeated slots, into f32 and bf16 rows, with slots outside
                [0, C) mixed in, with one write, from bf16 rows and at a
                width of 17 (the element-wise copy); K5 in f32 and f64,
                bit for bit, on scores with ties, -inf, NaN, -0.0 and
                +0.0, all-NaN and all -inf rows, at the miner's [64, 16],
                [2048, 16], the TPU-shaped [4096, 128] and L 1, 15, 16, 17,
                31, 32, 33, 128 with k 1 and L.  CUDA-event medians of the kernel, its plain
                version and one PyTorch call computing the same function
                (none for K3), beside the bound from bytes and operations
                (K1's masked bound counts the live slots' rows, its
                weighted bound every slot's);
  4. forward  — ``R.forward`` of dlrm-flexemr at its published config
                (26 fields x 64, 150M-row f32 table made on the card) on
                2048 synthetic requests: finite scores, allclose to the plain
                forward, K1 (every launch in its masked mode) and K2 launched;
  4b. cached_forward — the same model with a 2^18-slot ``HashCacheState``:
                built by ``make_hash_cache_from_table`` from the hot ids of 4
                warm-up batches (K4), ``R.forward(..., cache=...)`` on the
                phase-4 batch (K3, K1 masked, K2) allclose to the uncached forward,
                one refresh (``cache_insert`` threshold 2 + ``decay_freq``,
                K4 again) and a second forward; then device medians of the
                cached and uncached forward, timed in turns, and each one's
                device busy time and kernels in a profiled window;
  4c. sharded_forward — with phase 4's table, batch, cache and outputs
                shared through CUDA IPC (the table held once), 4 ranks
                spawned by ``launch.mesh.spawn`` on the one card over gloo
                (collectives staged through host memory), mesh (data 1,
                model 4): the 2^18-slot hash cache built from each rank's
                shard (``gather_rows`` over model, K4) bit-equal to the build
                from the whole table; each rank's lookup and
                ``R.forward(mesh=...)`` in
                baseline, hierarchical at num_chunks 1 and 2, mesh2d, and
                hierarchical with the 2^18-slot hash cache, its pooled
                block and scores slice allclose to phase 4's (rtol 1e-5,
                atol 1e-6); K1 (not on baseline's raw-row path) and K2 on
                every rank, K3 with the cache; the bytes counted at the
                collectives: the ring model's, baseline exactly 4x (the
                padded nnz) hierarchical; each case's wall time (host
                staging: no interconnect time); then the hierarchical lookup
                at one NCCL rank, bit-equal to the one-device lookup;
  4d. sharded_train — in the same 4 ranks, mesh (data 2, model 2):
                dlrm-100m at the global batch of 256, 3 steps of
                ``make_train_step(mesh=...)`` in the paper layout and in
                mesh2d against 3 one-device steps on the card (params and
                optimizer state, rtol 1e-4, atol 1e-6; K1, K1', K2, K2' on
                every rank); the one-device run's checkpoint of step 1
                restored under the mesh is bit-equal to the same state cut
                from memory, and so are both after one more step;
  5. serve    — ``repro_torch.launch.serve.run`` with its defaults (8 servers,
                pooled engine, depth 2, closed loop) on 400 requests: every
                request retired, finite scores, K2 launched once per batch;
  5b. serve_prefetch — a ``FlexEMRServer`` built as ``launch.serve.run``
                builds it, plus a ``PrefetchEngine`` whose miner selects on
                the card (K5), on 400 requests of co-occurrence traffic: every
                request retired, finite scores, rows prefetched, K5 launched;
  5c. serve_open_loop — ``launch.serve.run`` with ``--arrival poisson`` at half
                of phase 5's measured rate for 2 s: every arrival retired or
                shed, finite scores, K2 launched once per batch; offered and
                achieved rate, p50/p99, the driver's lag, the SLO summary;
  5d. serve_chaos — launch.serve's server on dlrm-serve over one bucket of 64,
                12 batches pre-filled from seed 0, driven by explicit admits
                and retires, fault-free and then under a kill-engine,
                drop-and-restore-shard, straggler-storm (x8) and reshard
                8 -> 16 schedule: scores bit-equal batch by batch, every
                fault fired once and recovered, the reshard's moved rows
                equal to ``reshard_tables``' count on the host, and a second
                run of the schedule with the same firing log;
  5e. serve_reshard — ``launch.serve.run --chaos-seed 0 --reshard-to 12`` on
                400 requests: every request retired with a finite score and
                the reshard to 12 in ``out["chaos"]``;
  5f. train  — dlrm-100m (``launch.train``'s model: 26 fields x 64, 1,272,000
                rows): K1' (the table's gradient) against its plain version
                on the trainer's batch of 256 (masked, repeated rows, twice
                bit-equal, rows padding alone names left 0; bit for bit
                against the plain version on the CPU, K1's tolerance against
                the card's, whose index_add_ adds with atomics) and at nnz 1, 3,
                4, 1003 bags, ids outside [0, V), D 17 and 64 (masked: NaN
                in the all-padding bags' gradient); K1' into a buffer
                filled with NaN first (its output is torch.empty: every row
                must be written), and a planted fault that the bit check
                must refuse (a build whose fill skips the last row, which
                no live slot names); one row named by every slot (a run of
                26,624), every slot masked (all zeros), a table of
                16,777,216 rows (4.3 GB); K2' at
                [256, 27, 64] and every serve bucket; each timed beside its
                plain version, ``index_add_`` / ``torch.bmm`` and its bound;
                one train step on the card (K1 masked, K1', K2, K2' once
                each) against the same step on the CPU with NaN in the rows
                padding alone names: finite loss, every gradient leaf, then
                params and optimizer state; the step's device time in a
                profiled window (K1' one kernel, no library sort in it); 12
                steps on two alternating fixed batches (the loss must fall); ``launch.train`` at its defaults (200
                steps, K1 masked, K1', K2 and K2' once a step), and the
                restart through its flags: ``--steps 100 --ckpt-dir`` saves
                step 99, ``--resume --steps 200`` runs 100-199 and ends at
                the straight run's last loss (rtol 1e-5);
  5g. recsys_archs — after the DLRM state is freed: K1 (masked and
                weighted) and K1' against their plain versions at the other
                archs' widths and bag shapes (D 8, 16, 32, 40, 256; nnz 8
                and 1; serve_p99's batch of 512 and train_batch's 65,536);
                then wide-deep, two-tower-retrieval, mind, autoint, dcn-v2
                and deepfm from the registry, each at its published config
                (tables made on the card, 78.98 GB for wide-deep), one
                ``R.forward`` on 512 requests: finite scores, the lookup
                against ``lookup_reference`` (mind: its raw rows against
                indexing), the scores against the plain lookup and the
                dense stage on the CPU, K1 masked once a lookup (twice for
                wide-deep and deepfm, none for mind), the device median
                and, in a profiled window, the busy time and K1's share;
                K1 timed at wide-deep's and two-tower's forward shapes
                beside ``F.embedding_bag``; ``retrieval_topk`` (8 queries,
                1,000,448 candidates of 256) and ``mind_retrieval`` (1
                user, 1,000,448 distinct items), k 100, values and each
                index's score against the CPU's scores; then one
                ``make_train_step`` of each at 65,536 with every table
                capped at 1,000,000 rows (finite loss and gradients, K1
                and K1' once a lookup, the step's device time and peak
                memory; K1' on the step's own Zipf batch at wide-deep's
                step, its wide table's and two-tower's, bit-equal on the
                touched rows to host sums in slot order
                (``k1b_hold_slot_order``: its hot runs hold thousands of
                slots), 0.0 elsewhere, two launches bit-equal, then timed
                beside ``index_add_``), and the loss and gradients at
                1,024 with 100,000-row tables against the CPU;
  5g2. recsys_cells — after phase 5g: the seven recsys registry ids'
                cells (dlrm-flexemr and 5g's six x train_batch,
                serve_p99, serve_bulk, retrieval_cand) under a real mesh
                of 4 gloo ranks of the card at (data 2, model 2): each
                rank takes its blocks of the cell's global arguments by
                its ``in_shardings`` (``CellBuild.blocks``) and calls the
                cell's step, held against one device's run of the cell
                built with ``mesh=None`` on the card, on the same params
                (tables made on the card from a seed, capped at 1,000,000
                rows, a train cell's halved further until its table
                gradient's all-reduce fits half of 256 MB; batches and
                candidate counts halved from the cell's own until a
                rank's ring-model bytes fit 256 MB; the params, batches
                and one device's outputs shared through CUDA IPC): serve
                scores at 4c's tolerance (two-tower's atol over its
                temperature), retrieval values and indices equal on
                tie-free scores, train loss, gradients and optimizer
                state at 4d's and the params against the optimizer on the
                rank's own gradients; K1 masked once a lookup (twice for
                wide-deep and deepfm, none for mind), K1' once a lookup in
                training, K2 for the DLRM and K2' in its train step, each
                rank's bytes = ``recsys_cell_ring_bytes``; paths
                ``recsys_cells.<arch>.<shape>``;
  5g3. demos — after phase 5g2: the port's README demos
                (examples/torch_*.py) at their defaults, each run on the
                card and again on the CPU from the card's initial params
                (the CPU takes the plain versions): quickstart on one
                device and on 4 gloo ranks of the card (mesh (data 2,
                model 2)), hotcache, prefetch, elastic_reshard, and
                serve_dlrm with --requests 2000 --trace --metrics-out;
                every integer counter of a demo equal between the two
                runs (routing table, rdma-pool p99, subrequests, steals;
                hit and lookup counts, bytes, cached and admitted rows;
                prefetch issued and hits; reshard rows; serve batches,
                bytes and engine counters), the pooled lookups at K1's
                tolerance (rtol = atol = 1e-5), the elastic loss and
                scores after 10 steps at 1e-5 and its score drift under
                1e-5 on both; launches: K1 masked 3 times on one device
                and twice a rank, none on the hotcache demo, K5 on the
                prefetch demo, K1 and K2 12 times and K1' and K2' 10 on
                the elastic demo, K2 once a batch on serve, whose trace
                ``tools/trace_export.py --attribution`` reads at coverage
                100.00%; each demo's wall time beside the card's name and
                power limit; paths ``demo_*``;
  5h. gnn   — after phase 5g: graphsage-reddit from the registry at its
                four published shapes on one device, f32, TF32 off, none
                launching a hand kernel (the aggregation is index_select
                and index_add_, as the reference's is XLA's take and
                segment_sum): full_graph_sm (Cora's 2,708 nodes, 10,556
                edges padded to 10,752, d 1,433, 7 classes) and molecule
                (128 graphs of 30 nodes and 64 edges, d 32): the step-1
                loss and gradients, then 3 Adam steps of the cell, card
                against CPU, each from the CPU's params and state of the
                step before (rtol 1e-5, atol 1e-6 times a leaf's largest
                magnitude past 1; the params with Adam's freedom near that
                step's zero gradients, the moments);
                minibatch_lg: Reddit's 232,965 nodes and 114,615,892 edges
                made on the host and grouped by ``edges_to_csr`` (seconds
                printed), one ``sample_block`` of 1,024 targets at fanout
                (15, 10) (169,984 nodes, 409 MB of features), the same
                checks; ogb_products: 2,449,029 nodes and 61,859,140 edges
                (padded to 61,859,328) made on the card from a seed
                (power-law destinations, uniform sources), one forward
                (finite, device time), 256 nodes' logits against float64
                on the CPU over their two-hop in-neighbourhoods, 3 train
                steps (finite losses, device and busy time, the profiler's
                kernels, peak memory); ``smoke("cuda")``;
  5i. gnn_sharded — 4 gloo ranks on the one card (``launch.mesh.spawn``),
                mesh (data 2, model 2), at ogb_products' widths on a tenth
                of its graph (244,903 nodes padded to 244,904, 6,185,914
                edges padded to 6,185,984, nodes relabelled at random): the
                edge-sharded forward (logits at rtol = atol = 1e-5) and one
                train step (loss and gradients at 5f's tolerance, the
                params after Adam with its freedom) against one device on
                the card; ``forward_full_graph_partitioned`` in f32 and
                bf16 comm against one device's plain version of its
                arithmetic (node states rounded to the comm dtype before
                the gather) at 1e-4, the reference's own tolerance, its gap
                to the f32 forward reported; the minibatch_lg cell's step
                on four blocks sampled in 5h, one a rank, against one
                device running the same four; every rank's bytes equal to
                the ring model's (edge-sharded: every layer's sums and the
                counts once; partitioned: h a layer), the edge-sharded
                forward's over the partitioned bf16 one's printed;
  6. lm_kernels — after phase 5g: K6 against its plain
                version at stablelm-3b's prefill layer [4, 4096, 32, 32, 80]
                causal in bf16 and f32, at lm_f32's [2, 1024, 32, 32, 80]
                causal in f32, at qwen2-72b's GQA heads
                [1, 4096, 64, 8, 128], at dh 128 without GQA
                [1, 4096, 32, 32, 128], at a ragged S (bf16 causal at dh
                64, 80 and 96, bf16 full), the same in f32 (3xTF32) and f32
                at a ragged S causal at dh 64, 80, 96 and full at 128;
                K7 at the decode
                path's caches [4, 4128, 32, 80] with NaN past cache_len
                4097, at cache_len 1, in f32 and with GQA, and at g = 4
                (q [2, 32, 128], 8 KV heads) with cache_len on an edge of
                the kernel's split over S, one past it and the whole cache;
                K6 and K7 at each MoE / wide path's own layer (olmoe's 16/16
                heads in bf16 and lm_moe_f32's f32, arctic's 56/8: groups of
                7, qwen2's 64/8, llama3's 128/8, all at dh 128); bf16 at the
                reference sweep's rows at head dims 16 and 32 (K6 [2, 64, 4,
                2, 16] causal and [1, 128, 4, 4, 32] full; K7 q [2, 8, 16]
                over [2, 128, 2, 16] at cache_len 100 and q [1, 4, 32] over
                [1, 256, 4, 32] at 256) and K7 at lm_small_bf16's decode
                step, each timed;
                bf16 to two output ulps plus 2^-5 of the row's RMS, a check
                shown to refuse planted faults (one KV tile of 64 skipped,
                bf16 and f32, and bf16 at dh 32; K7's middle chunk dropped);
                K7's shard mode (``flash_decode_partial``) in f32 and bf16
                on lm_sharded_decode's [4, 1032, 16, 128] shard, and in
                bf16 on shards of 256 positions at dh 16 (4 heads over 1)
                and 32 (8 over 4), each starting below, inside, at and past
                cache_len, NaN from cache_len on: its max and sum, and its
                sum over its sum, against the plain version; an empty shard
                must give m = -inf, l = 0, acc = 0; the first shard timed
                by events and by the profiler (the kernel's own device
                time: the events also hold the wrapper's enqueue when the
                host trails), beside
                ``aten._scaled_dot_product_efficient_attention`` with its
                logsumexp (= m + log l) on the same shard.
                CUDA-event medians of each kernel, its plain version and
                ``F.scaled_dot_product_attention`` (timed only, never called
                by the port), and of kernel and library at the repo's own
                lengths (prefill_32k at B = 1, decode_32k at B = 8).
                K6 bf16's persistent walk (``k6_walk_checks``): at the
                trainer's layer [256, 128, 8, 4, 32] and at stablelm-3b's
                prefill, two launches bit-equal, the output into a
                NaN-filled buffer, and a planted build whose walk stops one
                unit short (``K6_PLANT``, built beside the kernels) refused
                there; at the trainer's, device times (``device_ms``) with
                and without the logsumexp beside SDPA's forward and the
                bound; the host's enqueue of one call at lm-small's layer
                split into the wrapper, its C launch function and the
                library's maps and attribute (``k6_host_split``), on a line
                of its own;
  7. lm_prefill — stablelm-3b at full width and depth (bf16 weights made on
                the card from seed 0), ``transformer.prefill`` of 4 prompts
                of 4,096 tokens: finite last logits, K6 launched once per
                layer; wall time of the first call, device median, tokens/s,
                and the kernels' device time in one profiled call;
  8. lm_decode — the caches padded to 4,128 positions, 32 greedy
                ``decode_step``s (argmax fed back, ``pos`` on the card, no
                host sync in the loop): finite logits, K7 launched 32 x 32
                times; per-step wall median (CUDA events around each step
                measure the host's enqueue pace: the device runs ahead of
                it), tokens/s, and the device's busy time and the kernels'
                time per step over two profiled steps;
  9. lm_checks — in f32 compute on the card, TF32 off: a 2-layer cut of the
                same weights (prefill 256, 4 decode steps) against the same
                on the CPU (plain versions), and the full depth (prefill
                1,024, 4 decode steps) against one ``forward`` over all
                1,028 tokens; the card's half is the ``lm_f32`` path, which
                must launch K6 (in f32 only) and K7;
  9b. lm_moe_prefill — olmoe-1b-7b at full width and depth (6,919,096,320
                parameters, 13.84 GB in bf16, made on the card from seed
                0), ``prefill`` of 4 prompts of 4,096 tokens (capacity
                2,560 a expert, about 33 TFLOP of expert products): finite
                logits, K6 once a layer; first-call wall, device median,
                tokens/s, the kernels' time in a profiled call, and the
                share of dropped assignments (one more call under
                ``RoutingLog``);
  9c. lm_moe_decode — 32 greedy ``decode_step``s against caches of 4,128
                positions: K7 16 x 32 times, finite logits; step wall
                median, device busy time, beside the bound of reading every
                expert (12.9 GB) once a step;
  9d. lm_moe_checks — f32 compute, TF32 off: a 2-layer cut at olmoe's
                widths on the card against the same on the CPU, then the
                full depth's decode against one ``forward`` (capacity
                factor E / K: nothing drops); routing first (a token whose
                top-k set or kept experts differ is a near tie, counted
                with its margin and left out), the rest at 1e-4 and 1e-3
                (the ``lm_moe_f32`` path: K6 in f32 only, and K7);
  9e. lm_sharded_decode — on 4 gloo ranks of the one card
                (``launch.mesh.spawn``, the params and caches shared through
                CUDA IPC), each rank holding its blocks of the params in the
                decode cell's layout (``mesh_param_specs``): olmoe's widths
                at 2 layers in f32, heads and experts over model, at mesh
                (1, 4) at B = 4, positions over model, and (2, 2) at B = 1,
                positions over both axes (long_500k's layout) against
                32,768 positions, 8 steps at 1e-4; qwen2-72b at full width,
                2 layers, bf16 weights with FSDP over data, at mesh (2, 2)
                in both layouts (B = 4 over data: weights gathered at use;
                B = 1: partial products summed over data), 3 steps in
                bf16 compute (TP_BF16_TOL) and 3 in f32 (TP_F32_TOL); full, partial and empty shards and NaN past the
                steps' rows; each rank's logits block against one device's
                decode on the card, K7's shard mode once a layer a step on
                every rank, the bytes the ring model's, each rank's param
                bytes a share of the whole (a quarter of qwen2's layer
                matrices, half its embedding and head);
  9f. lm_moe_wide — each with everything before it freed: arctic-480b cut to
                2 of its 35 layers (55.4 GB: 56 heads in groups of 7, 128
                experts top-2 beside the dense FFN), qwen2-72b to 2 of 80
                (QKV bias, 64/8 heads) and llama3-405b to 1 of 126, at full
                width: prefill of 1 x 4,096 (K6 once a layer), 8 decode
                steps (K7 once a layer a step), finite logits; device
                median, step wall median and busy time beside the bound of
                reading the weights;
 9g. lm_train_kernels — K6 writing its row logsumexp and K6' (its
                backward, ``flash_attention_backward.cu``) against their
                plain versions: lm-small's layer [8, 128, 8, 4, 32] f32
                and bf16, and at the trainer's batch [256, 128, 8, 4, 32],
                lm_smoke's head dim 16 (4 and 1 KV heads) in both dtypes,
                bf16 at dh 16 with a ragged S of 1,000 and at dh 32 full,
                stablelm-3b's train layer
                [2, 4096, 32, 32, 80] and olmoe-1b-7b's [1, 4096, 16, 16,
                128] in bf16, f32 at dh 80 (also with groups of 4), ragged S
                (45, 1000), full attention, groups 1, 2, 4 and 8, every head
                dim of each dtype; f32 at 2e-5, bf16 by
                ``assert_close_rows``; the logsumexp at 2e-5; K6' twice
                bit-equal (lm-small's in both dtypes, stablelm's, olmoe's,
                f32 dh 80 in groups), and a planted build whose dK/dV loop
                skips a query tile refused (lm-small's f32 and bf16,
                stablelm's);
                timed beside its plain version, the backward alone
                of ``F.scaled_dot_product_attention(..., enable_gqa=True)``
                and its bound (five products of 2 B H dh a kept pair; f32
                at three tf32 products each, the FMA bound beside it), and
                K6 with and without its logsumexp, its plain version and
                SDPA's forward; each of K6''s three launches (D, dK/dV, dQ)
                timed from a profiler window; the host time of a bf16 K6'
                call at lm-small's layer by part (``k6b_host_split``) on a
                line of its own;
  9h. lm_train_small — lm-small (``launch.train.make_lm_small``): one
                step's loss and every gradient leaf on the card against the
                CPU (64 sequences of the trainer's first batch, rtol 1e-5,
                atol 1e-6 times a leaf's largest magnitude past 1), K6 and
                K6' as the remat predicts (3 L - G and L a step, here 10
                and 4); then ``launch.train --model lm`` for 50 steps of 256
                x 128 tokens, whose closing assert needs the loss to fall;
  9h2. lm_small_bf16 — lm-small and lm_smoke's widths (the registry's
                smoke cut of qwen2-72b: dh 16, 4 heads over 1, QKV bias) in
                the reference's default bf16 compute (f32 params from seed
                0): a prefill of 8 x 128 (lm_smoke 4 x 16; K6 once a layer),
                16 greedy decode steps (K7 once a layer a step) and a train
                step at the trainer's 256 x 128 (lm_smoke 4 x 16; K6 with
                its logsumexp 3 L - G and K6' L times a microbatch), each
                with the other kernels' counts at 0, against the same on
                the CPU (the plain versions; the decode fed the card's
                tokens): logits and caches by rows at TP_BF16_TOL, the loss
                at TP_BF16_LOSS_RTOL, every gradient leaf by rows at
                TP_BF16_GRAD_TOL;
  9i. lm_train — stablelm-3b at full width and depth, f32 params (the
                train cell's rule), bf16 compute, Adam updating in place,
                3 steps on one fixed batch of 2 x 4,096 (train_4k's 256
                sequences cut to 2): the loss must fall; K6 88 and K6' 32
                times a step; step wall, tokens/s, peak memory, one
                profiled step's busy time and K6/K6''s share; then a
                2-layer f32 cut of the trained weights, card vs CPU;
  9j. lm_moe_train — olmoe-1b-7b at full width, 4 of its 16 layers, its 2
                microbatches, 2 steps of 2 x 4,096 (K6 16 and K6' 8 a
                step), the same report; a 2-layer f32 cut card vs CPU,
                its routing compared first (``routing_differs``);
  9k. lm_registry — ``smoke("cuda")`` of each of the five LM ids: a train
                step (K6 and K6' in f32 at head dim 16) and a decode step
                (K7 in f32 at head dim 16);
  9l. lm_tp_prefill — qwen2-72b serving at full width (bf16, its own
                seq_shard and fsdp_serve), 2 of its 80 layers: one device's
                ``prefill`` of 2 x 4,096 and 8 ``decode_step``s first, kept
                in host shared memory; then 4 gloo ranks
                (``launch.mesh.spawn``, the params shared through CUDA IPC)
                at mesh (data 2, model 2), one prompt a data rank: each
                rank's ``prefill(mesh=...)`` (K6 at [1, 4096, 32, 4, 128]),
                ``caches_for_decode`` and 8 ``decode_step``s under the mesh
                (K7's shard mode), every block of the last logits, the
                caches and the steps' logits against one device's by
                ``limit_share`` (rtol 2^-6 plus 2^-3 of the row's RMS),
                K6 and K7 counted by the wrappers and the profiler (K6 L,
                K7's shard mode L x 8 a rank; a trace with no device events
                fails), bytes
                equal to the ring model's; the same in f32 compute at 1
                layer and 2 x 1,024 at 1e-4, beside the card's own f32
                floor (each prompt alone against the batch);
  9m. lm_tp_train — stablelm-3b at full width, 2 of its 32 layers in one
                remat group, the train cell's rule (f32 params, bf16
                compute, Adam in place): one device's step-1 gradients and
                3 steps of 2 x 4,096 first, in host shared memory; then 4
                gloo ranks at mesh (data 2, model 2), at its own seq_shard
                (off) and on: each rank's step-1 gradient blocks
                (``loss_and_grads(mesh=...)``, profiled: K6 with its
                logsumexp and K6' at [1, 4096, 16, 16, 80]) and 3 steps of
                ``make_train_step(mesh=...)``, the losses within 1e-3 of one
                device's, the step-1 gradient blocks by ``limit_share``
                (TP_BF16_GRAD_TOL), K6 3 L - G and K6' L a step by the
                wrappers and L and 3 L - G in the profiled step-1 call,
                bytes equal to the ring model's; the same in f32 compute at
                2 x 1,024, where
                the losses, every gradient block and every param block
                after the steps hold at 9i's card-vs-CPU tolerance;
 9n. dryrun — the dry run (``launch.dryrun``, ``launch.hlo_analysis``):
                ``run_cell`` of stablelm-3b train_4k and dlrm-flexemr
                train_batch on the 16x16 ``DryMesh`` (per-device memory
                beside 80 GB, the roofline terms); one lm-small train step
                (K6 f32, K6' f32) and decode step (K7), one dlrm-100m
                train step (K1 masked, K2, K1', K2'), its cached forward
                over a 2^12-slot hash cache (K3) with K4's swap-in of the
                cache's rows, and K5 at the miner's shape, each traced on
                the card and on meta: equal FLOPs by class, launches by
                kernel (equal to the wrappers' counts) and collective
                bytes, memory bytes equal but for named scratch fills;
                stablelm-3b's train step of 9i traced on meta, its bound
                on the H100 SXM data sheet beside 9i's busy time;
 10. the ``{"kernels": [...]}`` line (K1's and K2's entries add a
     ``backward`` part for K1' and K2'; K1's entry adds its weighted mode's
     times and bound, its times at 5g's forward shapes (``forward_shapes``)
     and K1''s at 5g's train steps (``backward.train_shapes``), K6's its f32 times at lm_f32's shape and at
     lm_prefill's, each with the 3xTF32 bound and the f32 FMA one, and its
     f32 launches and its times with and without the row logsumexp (``lse``),
     K7's its shard mode's times and launches as ``partial``; K6' has an
     entry of its own, ``flash_attention_backward``, with its cases), then
     as the last line
     ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Each path (4, 4b, 4c and 4d on each rank, summed over the ranks in the
kernels line, 5, 5b, 5c, 5d's run under faults, 5e, 5f's defaults run,
5g's ``recsys_forward.<arch>``, ``recsys_train.<arch>``,
``retrieval.two_tower`` and ``retrieval.mind``, 5h's ``gnn.<shape>``,
``gnn.ogb_products.forward`` and ``gnn.registry`` and 5i's
``gnn_sharded`` (summed over its ranks; these must launch no hand
kernel), 7, 8, and 9 as
``lm_f32``: K6 and K7 in f32 on the card, 9b, 9c, 9d as ``lm_moe_f32``,
9e summed over its ranks and cases, 9f as ``lm_wide_prefill.<arch>`` and
``lm_wide_decode.<arch>``, 9h's ``launch.train`` run, 9h2's prefill,
decode and train step as ``lm_small_bf16.<config>.<part>``, 9i's and 9j's steps,
9k as ``lm_registry.<arch>``, 9l and 9m as ``lm_tp_prefill`` and
``lm_tp_train``, summed over their ranks and passes, 9n's card runs as
``dryrun.<program>``) runs with the launch
counts set to 0 just before it and read just after; comparisons and
timings run outside those windows.
It imports nothing of the JAX package.  Without a GPU, or without the repo's
``src/`` beside it, it exits nonzero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

IMPORTED_AT = time.time()  # a spawned rank's start, before its arguments arrive
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_TENSOR_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_TENSOR_FLOP_PER_S = 495e12  # H100 SXM tf32 tensor cores, dense (K6 f32 runs 3 products)
FORWARD_BATCH = 2048
SERVE_BUCKETS = (32, 64, 128, 256, 512, 1024)  # data/pipeline.BucketBatcher's defaults
SERVE_FIELDS = 17  # dlrm-serve's 16 fields + the bottom MLP's output
SERVE_REQUESTS = 400
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2: every timed launch starts cold
HOT_SLOTS = 1 << 18  # the cached forward's hash cache (67 MB of f32 rows)
MAX_PROBES = 8
WARMUP_BATCHES = 4
MINER_ROWS = 64  # K5's timed shape: about one cache plan's triggers
K5_EDGE_WIDTHS = (1, 15, 16, 17, 31, 32, 33, 128)
FORWARD_TURNS = 6  # cached/uncached forward timing pairs, alternating order
PREFETCH_CACHE_ROWS = 256  # the serve_prefetch controller's row cap
PREFETCH_REFRESH_EVERY = 4  # batches between cache plans
PREFETCH_BURST = 8  # requests submitted between serving steps
OPEN_LOOP_SECONDS = 2  # serve_open_loop's --duration; --qps is half of serve's rate
CHAOS_BUCKET = 64  # serve_chaos's one batcher bucket
CHAOS_BATCHES = 12  # batches pre-filled for each serve_chaos run
CHAOS_SHARDS = 8  # launch.serve's --num-servers default
CHAOS_RESHARD_TO = 16
CHAOS_WAIT_S = 5.0  # batcher deadline: a pre-filled queue always gives full buckets
CHAOS_WATCHDOG_S = 10.0  # ChaosInjector's retire watchdog (raises after 2x this)
RESHARD_TO = 12  # serve_reshard's --reshard-to
TRAIN_STEPS = 200  # launch.train's defaults: dlrm-100m, batch 256, 200 steps
TRAIN_BATCH = 256
TRAIN_RESUME_AT = 100  # the restart check: --steps 100, then --resume --steps 200
TRAIN_FIT_STEPS = 12  # two alternating fixed batches (tests/test_system.py's design)
TRAIN_GRAD_TOL = (1e-5, 1e-6)  # loss and gradients, card vs CPU: f32, other sum orders
# K1' against its plain version on the card, whose index_add_ adds with
# atomics in a varying order: rows of up to 49 unit-scale terms differ by a
# few 1e-6 (K1's own tolerance); against the plain version on the CPU, which
# adds in slot order as K1' does, bit for bit.
K1B_TOL = (1e-5, 1e-5)
# K1''s planted fault: its fill made to skip the table's last row, which no
# live slot of the trainer's batch names (the phase checks that)
K1B_PLANT = ("      if (jq < total && !((word >> (r & 31)) & 1u))",
             "      if (jq < total && !((word >> (r & 31)) & 1u) && r != a.num_rows - 1)")
K1B_BIG_ROWS = 16_777_216  # K1' into a 4.3 GB table: a bitmap of 2^24 rows
TRAIN_STEP_TOL = (1e-4, 1e-6)  # params and optimizer state after the step
# sharded_forward: dlrm-flexemr's lookup and forward on 4 gloo ranks of the
# one card, mesh (data 1, model 4), each case against phase 4's one-device
# pooled embeddings and scores
SHARDED_RANKS = 4
SHARDED_FWD_MESH = (1, 4)
SHARDED_FWD_CASES = (  # (name, mode, num_chunks, with phase 4b's hash cache)
    ("baseline", "baseline", 1, False),
    ("hierarchical", "hierarchical", 1, False),
    ("hierarchical_chunks2", "hierarchical", 2, False),
    ("mesh2d", "mesh2d", 1, False),
    ("hierarchical_hash_cache", "hierarchical", 1, True),
)
SHARDED_FWD_TOL = (1e-5, 1e-6)
# sharded_train: dlrm-100m at the trainer's global batch of 256, mesh
# (data 2, model 2), 3 steps in the paper layout and in mesh2d against 3
# steps on one device on the card (phase 5f's step tolerance)
SHARDED_TRAIN_MESH = (2, 2)
SHARDED_TRAIN_STEPS = 3
SHARDED_TIMEOUT_S = 300
# recsys_archs: the six other recsys archs of the registry at their published
# configs (largest table first: wide-deep's 79 GB must find the card empty)
RECSYS_ARCH_IDS = ("wide-deep", "two-tower-retrieval", "mind", "autoint", "dcn-v2", "deepfm")
RECSYS_TRAIN_ROWS = 1_000_000  # each table capped for the train_batch step
RECSYS_CHECK_BATCH = 1024  # the card-vs-CPU step: batch and table cap
RECSYS_CHECK_ROWS = 100_000
# K1 and K1' at this slice's widths and bag shapes, (D, nnz, fields): the
# wide table, autoint/dcn/deepfm, wide-deep's emb, fuse_wide's 40, two-tower
RECSYS_K1_WIDTHS = ((8, 8, 40), (16, 1, 39), (32, 8, 40), (40, 8, 40), (256, 1, 4))
RECSYS_K1_ROWS = 1_000_000
# phase 5g2 (recsys_cells): the seven recsys registry ids' cells on
# RECSYS_CELL_RANKS gloo ranks of the one card at mesh (data 2, model 2),
# each against one device's run of the same cell (mesh=None) on the card.
# Every table capped at RECSYS_CELL_ROWS (5g's train cap); a train cell's
# tables halved from there until the all-reduce over data of a rank's table
# gradient takes at most half of RECSYS_CELL_MAX_BYTES; a cell's batch (a
# retrieval's candidate count) halved from its own until the rank's bytes
# by the ring model fit RECSYS_CELL_MAX_BYTES: gloo stages each collective
# through host memory
RECSYS_CELL_IDS = ("dlrm-flexemr",) + RECSYS_ARCH_IDS
RECSYS_CELL_RANKS = 4
RECSYS_CELL_MESH = (2, 2)  # (data, model)
RECSYS_CELL_ROWS = 1_000_000
RECSYS_CELL_MAX_BYTES = 256e6
RECSYS_CELL_QUERIES = 8  # the two-tower retrieval cell's queries (recsys_common's)
RECSYS_CELL_SERVE_TOL = SHARDED_FWD_TOL  # 4c's: scores and top-k values
RECSYS_CELL_TRAIN_TOL = TRAIN_STEP_TOL  # 4d's: loss, gradients, state, params
RECSYS_CELL_TIMEOUT_S = 600
# phase 5g3 (demos): the README demos, card against CPU
DEMO_RANKS = 4  # demo_quickstart_ranks: gloo ranks of the one card, mesh (data 2, model 2)
DEMO_K1_TOL = (1e-5, 1e-5)  # K1's own (phase 3): the quickstart's pooled lookups
DEMO_SCORE_TOL = (1e-5, 1e-5)  # the elastic demo's loss and scores after 10 steps
DEMO_SERVE_ARGS = ("--requests", "2000")
# launch.serve's summary keys that no clock decides: equal on card and CPU
DEMO_SERVE_COUNTERS = ("batches", "requests", "submitted", "nonfinite_scores", "hit_rate",
                       "network_bytes", "bytes_request", "bytes_no_cache", "bytes_swap_in")
DEMO_ENGINE_COUNTERS = ("batches", "subrequests", "wire_response_bytes", "wire_request_bytes",
                        "pooled_segment_wrs", "pooled_segments", "pooled_rows", "doorbells",
                        "virtual_steals", "p50_latency_us", "p99_latency_us", "deduped_rows",
                        "range_wrs")
LM_BATCH = 4  # prompts of the lm_prefill / lm_decode paths
LM_PROMPT = 4096  # tokens per prompt
LM_DECODE_STEPS = 32
LM_CACHE = 4128  # decode cache positions: the prompt + 32, padded
LM_CUT_LAYERS = 2  # the f32 check of the card path against the CPU path
LM_CUT_PROMPT = 256
LM_DEPTH_PROMPT = 1024  # the f32 check of decode against forward, full depth
LM_CHECK_STEPS = 4
LM_LONG_DECODE_BATCH = 8  # decode_32k's batch of 128 cut to one card (LM_SHAPES)
LM_GQA_HEADS = (64, 8, 128)  # qwen2-72b's query heads, KV heads, head dim
LM_RAGGED_SEQ = 1037  # no multiple of a 64-row tile
# K6/K7 against their plain versions.  f32: rtol = atol = 2e-5, the
# reference's.  bf16, by ``assert_close_rows``: rtol 2^-6 (two output ulps)
# plus 2^-5 of the RMS of the element's row (its head's dh values), for the
# probabilities that kernel and plain version round to bf16 at different
# points.  A fixed atol cannot do: |out| falls as 1/sqrt(keys), to about
# 0.02 at 4,096 keys, so an atol that covers a 4-key row would accept a
# kernel that skips a KV tile of a long row (phase 6 checks that this one
# does not).
LM_F32_TOL = (2e-5, 2e-5)
LM_BF16_TOL = (1.6e-2, 3.2e-2)
LM_KV_TILE = 64  # the KV tile of the planted faults
# The MoE LM paths (olmoe-1b-7b at full width and depth; the same prompts,
# steps and cache as lm_prefill / lm_decode) and their checks: routing
# first (a token whose top-k set or kept experts differ is a near tie,
# counted and left out), then the outputs at the lm_checks tolerances.
MOE_CUT_TOL = (1e-4, 1e-4)
# A routing difference is a near tie only where the k-th router probability
# leads the next by under this (f32 compute), and near ties are rare: at
# most this share of the tokens may differ.
MOE_TIE_MARGIN = 1e-4
MOE_TIE_SHARE = 0.01
MOE_DEPTH_TOL = (1e-3, 1e-3)
# lm_moe_wide: the wide configs at full width, depth cut to fit the card
WIDE_CUTS = (("arctic-480b", 2), ("qwen2-72b", 2), ("llama3-405b", 1))
WIDE_BATCH, WIDE_DECODE_STEPS = 1, 8  # prompts of LM_PROMPT tokens
WIDE_CACHE = 4112  # the prompt + 8, padded to 16
# lm_sharded_decode: on 4 gloo ranks of the one card, each rank holding its
# blocks of the params in the decode cell's layout (``mesh_param_specs``),
# the logits' blocks against one device's decode on the card.  olmoe's
# widths at 2 layers in f32 compute, heads and experts over model (its
# cell's ``fsdp_serve`` is off), 8 steps; qwen2-72b at full width, 2
# layers, bf16 weights with FSDP over data (its cell's ``fsdp_serve``), 3
# steps in bf16 compute and again in f32 compute (``qwen2_f32``, the same
# weights; a B = 4 step gathers its weights through host memory, the
# phase's slowest part).  (name, config, mesh, batch, batch axes, sequence
# axes, cache positions, first position: shards full, partial and empty)
SHARDED_DECODE_LAYERS = 2
SHARDED_DECODE_TIMEOUT_S = 600  # qwen2's weight gathers go through host memory
SHARDED_DECODE_STEPS = {"olmoe": 8, "qwen2": 3, "qwen2_f32": 3}
SHARDED_DECODE_CASES = (
    ("model_b4", "olmoe", (1, 4), 4, ("data",), ("model",), 4128, 2500),
    ("all_axes_b1", "olmoe", (2, 2), 1, (), ("data", "model"), 32768, 20000),
    ("qwen2_fsdp_b4", "qwen2", (2, 2), 4, ("data",), ("model",), 4096, 2500),
    ("qwen2_fsdp_b1", "qwen2", (2, 2), 1, (), ("data", "model"), 32768, 20000),
    ("qwen2_f32_fsdp_b4", "qwen2_f32", (2, 2), 4, ("data",), ("model",), 4096, 2500),
    ("qwen2_f32_fsdp_b1", "qwen2_f32", (2, 2), 1, (), ("data", "model"), 32768, 20000),
)
K7P_SHARD = 1032  # K7's shard mode checked and timed on model_b4's shard
K7P_SMALL = 256  # and checked in bf16 at head dims 16 and 32 on shards of this length
# LM training (phases 9g-9k).  K6 with its row logsumexp and K6' against
# their plain versions, (B, S, H, Hkv, dh, dtype, causal, timed): the
# trainer's lm-small layer, lm_smoke's head dim 16 (GQA as the registry's
# smokes cut it), both in f32 and in the reference's default bf16 compute,
# stablelm-3b's and olmoe-1b-7b's train layers at 2 x 4,096 and 1 x 4,096,
# f32 at dh 80, ragged S, full attention, groups 1 to 8, and every head dim
# each dtype takes.
LMT_KERNEL_CASES = {
    "lm-small f32": (8, 128, 8, 4, 32, "f32", True, True),
    "lm-small b256 f32": (256, 128, 8, 4, 32, "f32", True, True),
    "lm_smoke f32": (4, 16, 4, 4, 16, "f32", True, False),
    "lm_smoke gqa f32": (4, 16, 4, 1, 16, "f32", True, False),
    "lm-small bf16": (8, 128, 8, 4, 32, "bf16", True, True),
    "lm-small b256 bf16": (256, 128, 8, 4, 32, "bf16", True, True),
    "lm_smoke bf16": (4, 16, 4, 4, 16, "bf16", True, False),
    "lm_smoke gqa bf16": (4, 16, 4, 1, 16, "bf16", True, False),
    "ragged 1000 dh16 bf16": (1, 1000, 4, 2, 16, "bf16", True, False),
    "full dh32 bf16": (2, 300, 4, 2, 32, "bf16", False, False),
    "stablelm bf16": (2, 4096, 32, 32, 80, "bf16", True, True),
    "olmoe bf16": (1, 4096, 16, 16, 128, "bf16", True, True),
    "dh80 f32": (2, 1024, 32, 32, 80, "f32", True, True),
    "dh80 gqa f32": (2, 1024, 32, 8, 80, "f32", True, False),
    "ragged 45 f32": (2, 45, 8, 2, 32, "f32", True, False),
    "ragged 1000 bf16": (2, 1000, 8, 2, 64, "bf16", True, False),
    "ragged 1000 dh16 f32": (1, 1000, 4, 2, 16, "f32", True, False),
    "full bf16": (2, 1000, 8, 8, 80, "bf16", False, False),
    "full f32": (2, 45, 4, 2, 16, "f32", False, False),
    "full dh96 f32": (1, 300, 4, 4, 96, "f32", False, False),
    "groups 1 bf16": (1, 512, 8, 8, 64, "bf16", True, False),
    "groups 2 dh96 bf16": (1, 512, 8, 4, 96, "bf16", True, False),
    "groups 4 bf16": (1, 512, 8, 2, 64, "bf16", True, False),
    "groups 8 dh128 bf16": (1, 512, 8, 1, 128, "bf16", True, False),
    "groups 8 dh64 f32": (1, 300, 8, 1, 64, "f32", True, False),
    "dh128 f32": (1, 512, 4, 2, 128, "f32", True, False),
}
# K6''s bf16 gradients: LM_BF16_TOL plus a floor (``limit_share``'s
# ``head_floor``) of 2^-12 of the RMS of the element's (b, head), for rows
# that are 0 exactly: causal dq's first row, one key, where dP = D and both
# versions leave f32 noise (about 5e-7 at stablelm's layer, 2^-17 of the
# head's RMS); the floor stands 16x above that and 16x below bf16's ulp of a
# typical element.
K6B_FLOOR = 2.0**-12
# K6''s planted fault: its dK/dV loops (f32 and bf16) skip the first query
# tile they visit (a causal key tile's diagonal tile)
K6B_PLANT = ("  return causal ? j * ratio : 0;", "  return (causal ? j * ratio : 0) + 1;")
# K6's planted fault (bf16): its tile walk stops one unit short, so the last
# unit's rows of the last (b, h) are never written (phase 6 runs it into a
# NaN-filled buffer, at the trainer's layer and at stablelm-3b's prefill)
K6_PLANT = ("  const long long n_units = walk.units();",
            "  const long long n_units = walk.units() - 1;")
K6_HOST_CALLS = 200  # calls a part of the host-enqueue split averages over
K6_STABLELM = ((4, 4096, 32, 80), 32)  # stablelm-3b's prefill layer (LM_BATCH x LM_PROMPT)
# The cases where K6' runs twice and must give equal bits, and those that
# also hold the planted fault
K6B_TWICE = ("lm-small f32", "stablelm bf16", "dh80 gqa f32", "lm-small bf16", "olmoe bf16")
K6B_PLANTED = ("lm-small f32", "stablelm bf16", "lm-small bf16")
# K6''s three launches by the names of their kernels (device_busy's filter)
K6B_LAUNCHES = ("bwd_delta", "bwd_dkdv", "bwd_dq")
LMT_SMALL_STEPS, LMT_SMALL_BATCH, LMT_SMALL_SEQ = 50, 256, 128  # launch.train --model lm
LMT_SMALL_CHECK = 64  # sequences of the trainer's first batch in the card-vs-CPU step
# K6's bf16 cases of phase 6 that run twice (bit-equal) and hold the planted
# fault: the trainer's layer (lm-small at its batch) and stablelm-3b's prefill
K6_TRAINER = ((LMT_SMALL_BATCH, LMT_SMALL_SEQ, 8, 32), 4)
# lm_small_bf16 (phase 9h2): lm-small's and lm_smoke's widths in bf16
# compute, card vs CPU on the same params and inputs: a prefill of
# LMB_PREFILL (lm-small; lm_smoke at its smoke's batch, LMB_SMOKE), that
# many greedy decode steps (the CPU fed the card's tokens), a train step at
# the trainer's batch (lm_smoke: LMB_SMOKE).  Logits and caches by rows at
# TP_BF16_TOL, the loss at TP_BF16_LOSS_RTOL, every gradient leaf by rows at
# TP_BF16_GRAD_TOL: both sides round at the same points, but the card's
# products sum in other orders than the CPU's, and K6, K6' and K7 round P to
# bf16 in their own order.
LMB_PREFILL, LMB_SMOKE, LMB_DECODE_STEPS = (8, 128), (4, 16), 16
LMT_BATCH, LMT_SEQ, LMT_STEPS = 2, 4096, 3  # stablelm-3b: train_4k's batch of 256 cut to 2
LMT_MOE_LAYERS, LMT_MOE_STEPS = 4, 2  # olmoe-1b-7b at full width, 4 of its 16 layers
LMT_CUT_LAYERS, LMT_CUT_BATCH, LMT_CUT_SEQ = 2, 1, 256  # the f32 cuts, card vs CPU
LM_IDS = ("stablelm-3b", "olmoe-1b-7b", "qwen2-72b", "arctic-480b", "llama3-405b")
# lm_tp_prefill and lm_tp_train (phases 9l, 9m): the LM's tensor-,
# sequence- and FSDP-parallel paths on 4 gloo ranks of the one card, mesh
# (data 2, model 2), against one device on the card.  qwen2-72b serving at
# full width, 2 of its 80 layers (its own seq_shard and fsdp_serve), prompts
# of 2 x 4,096 then 8 decode steps; the f32-compute pass at 1 layer and
# 2 x 1,024 at the CPU tests' f32 tolerance.  stablelm-3b under the train
# cell's rule at full width, 2 of its 32 layers in one remat group, one batch
# of 2 x 4,096, 3 steps, at its own seq_shard and with seq_shard on; its
# f32-compute pass at 2 x 1,024 holds the losses, the step-1 gradients and
# the params after 3 steps at phase 9i's card-vs-CPU tolerance (bf16
# compute moves the losses by its rounding, and Adam's step is the sign of
# a small gradient: the bf16 path holds its losses at TP_BF16_LOSS_RTOL and
# its step-1 gradients at TP_BF16_GRAD_TOL, and reports how far its params
# lie).
TP_RANKS, TP_MESH = 4, (2, 2)
TP_PREFILL_LAYERS, TP_PREFILL_BATCH, TP_PREFILL_SEQ = 2, 2, 4096
TP_DECODE_STEPS, TP_CACHE = 8, 4112  # the prompt + 8, padded to 16
TP_F32_LAYERS, TP_F32_SEQ, TP_F32_CACHE = 1, 1024, 1040
# f32 compute: rtol and atol 1e-4.  The CPU tests' 1e-5 is below the card's
# own f32 floor at these widths: one device's prefill of a sequence alone
# against the same in a batch of 2 (other GEMM shapes, other sums over
# D = 8,192) differs by 2.1e-5 in the logits and 1.3e-5 in the caches on
# an H100 80GB HBM3 at 700 W; the phase measures that floor and prints it.
# The reference holds its mesh against one device at 2e-3.
TP_F32_TOL = (1e-4, 1e-4)
# bf16 compute, by ``limit_share``: two output ulps plus 2^-3 of the row's
# RMS.  Each rank rounds its partial of a row-parallel product to bf16
# before the sum, and the one device rounds the whole once: the difference
# runs through 2 layers and 8 decode steps.  A query head reading the
# wrong KV head, or a sum left out or made twice, moves a row by its RMS.
TP_BF16_TOL = (1.6e-2, 1.25e-1)
# lm_sharded_decode's tolerances: olmoe f32 at 1e-4; qwen2-72b's f32 compute
# at TP_F32_TOL and its bf16 compute by rows at TP_BF16_TOL, for the reason
# given there: the ranks round their partials of the row-parallel products
# (and under long_500k's FSDP of the column-parallel ones) to bf16 before
# the sum.  LM_BF16_TOL's 2^-5 of the row's RMS is about bf16's own error
# at these widths: one device's bf16-compute decode of a 2-layer, 2,048-wide
# config on the CPU lies at 1.03 of it from the f32-compute decode.
SHARDED_DECODE_TOL = {"olmoe": (1e-4, 1e-4), "qwen2": TP_BF16_TOL, "qwen2_f32": TP_F32_TOL}
# The bf16 train pass's step-1 gradient blocks, by ``limit_share`` against
# one device: two ulps plus 2^-2 of the row's RMS (a row: a gradient's last
# dim).  Each data rank rounds its half of a weight gradient's sum over the
# tokens to bf16, the one device the whole once; where the halves cancel the
# difference is an ulp of the halves, not of the sum.  On an H100 80GB HBM3
# at 700 W the worst element of stablelm's blocks stood at 0.11 of its row's
# RMS (0.871 of 2^-3; wq, every run bit-equal), so 2^-2 leaves it twice
# the room.  A gradient summed over one axis too few or too many, or scaled
# by tp, moves a row by its RMS.
TP_BF16_GRAD_TOL = (1.6e-2, 2.5e-1)
TP_TRAIN_LAYERS, TP_TRAIN_BATCH, TP_TRAIN_SEQ, TP_TRAIN_STEPS = 2, 2, 4096, 3
TP_TRAIN_F32_SEQ = 1024
TP_BF16_LOSS_RTOL = 1e-3
# Adam (lm_common.make_optimizer's: lr 3e-4, eps 1e-8) divides each
# gradient by its running magnitude, so an element whose gradient lies
# within the gradients' own tolerance of 0 takes a step that rounding
# decides: each of its steps is at most about lr on both sides (by
# Cauchy-Schwarz, 1.004 lr at step 3).  The f32 pass holds the params after
# the steps at TRAIN_GRAD_TOL plus that freedom, 2.1 lr a step times the
# share of the step-1 gradient that its tolerance covers.
TP_ADAM_LR, TP_ADAM_EPS = 3e-4, 1e-8
TP_TIMEOUT_S = 600


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, flush: torch.Tensor, reps: int = 15, warmup: int = 3,
            read_flush: bool = False) -> float:
    """Median device time of one call of ``fn``, L2 flushed before each by
    writing ``flush`` (which leaves up to the L2's 50 MB of dirty lines for
    ``fn`` to write back) or, with ``read_flush``, by reading it (clean)."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        if read_flush:
            flush.sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, calls: int = 20, sleep_cycles: int = 1 << 25) -> float:
    """Device time of one call of ``fn`` with the host's enqueue hidden: a
    sleep kernel holds the stream while the host enqueues ``calls`` calls
    back to back, which then run one after another (L2 warm).  Where the
    host took longer to enqueue them than the sleep lasted (its time could
    then be in the reading), once more with a sleep 8x as long, then it
    raises.  For launch-sized calls, whose event pairs in ``cuda_ms`` hold
    the wrapper's host time (torch.profiler windows of such calls came back
    without device events at times on this card)."""
    fn()
    for cycles in (sleep_cycles, 8 * sleep_cycles):
        torch.cuda.synchronize()
        held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        held.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < held.elapsed_time(start):
            return start.elapsed_time(end) / calls
    raise AssertionError(f"device_ms: the host's {host_ms:.3f} ms of enqueue outlasted the "
                         f"sleep's {held.elapsed_time(start):.3f} ms")


def bound(bytes_moved: float, flops: float,
          flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_busy(fn, calls: int, kernels: tuple = ()) -> dict:
    """Run ``fn`` ``calls`` times under ``torch.profiler``: the device time
    its kernels took (summed; one stream, so they do not overlap), how many
    kernels and copies ran, the kernels with the most of the time and, for
    each name in ``kernels``, the time of the kernels whose name holds it, a
    call and (``kernels_ms_each``) a launch, over the launches the trace
    holds (a window of a few short calls can miss its first ones).
    ``device_busy_ms`` is None when the trace holds no device events.  The
    profiler slows the host, so the window's own wall time is not reported;
    compare with an unprofiled run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    count: dict = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
            count[e.name] = count.get(e.name, 0) + 1
            n_ops += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"calls": calls,
           "device_busy_ms": sum(by_name.values()) / calls if by_name else None,
           "device_ops_per_call": n_ops / calls,
           "top_kernels_ms_per_call": [[n[:70], ms / calls] for n, ms in top]}
    if kernels:
        out["kernels_ms_per_call"] = {
            k: sum(ms for n, ms in by_name.items() if k in n) / calls for k in kernels}
        seen = {k: sum(c for n, c in count.items() if k in n) for k in kernels}
        out["kernels_ms_each"] = {
            k: sum(ms for n, ms in by_name.items() if k in n) / seen[k] if seen[k] else None
            for k in kernels}
        out["kernels_launches"] = seen
    return out


def sdpa_backward(q, k, v, do, causal: bool):
    """K6''s yardstick, timed and never called by the port: a function that
    runs the backward alone of one ``F.scaled_dot_product_attention`` call
    (GQA) on the same [B, S, heads, dh] tensors."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    g = do.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (qt, kt, vt), g, retain_graph=True)


def k6_bound(q, k, causal: bool, rate: float | None = None) -> tuple[float, str]:
    """K6's bound (its serving launch): q, k, v read and the output written
    once, two products of 2 dh operations a kept pair and head, at ``rate``
    (by default the bf16 tensor cores' or the f32 FMA rate)."""
    B_, S_, H_, d_ = q.shape
    pairs = S_ * (S_ + 1) // 2 if causal else S_ * S_
    rate = rate or (BF16_TENSOR_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S)
    return bound(2 * (q.numel() + k.numel()) * q.element_size(), 4 * d_ * B_ * H_ * pairs, rate)


def k6_host_split(q, k, v, causal: bool, lse=None, calls: int = K6_HOST_CALLS) -> dict:
    """Host time of one bf16 K6 call (its enqueue), in microseconds a call,
    by part: ``wrapper_us``, ``K6.flash_attention`` whole; ``launch_us``,
    the C launch function alone, called through ctypes with one call's
    arguments made once; and, where the library has
    ``flash_attention_bf16_host_ns``, within the launch function the six
    tensor maps and the shared-memory attribute as a call makes them now
    (``maps_us``: copies from the library's cache, the address replaced;
    ``attribute_us``: a check of a flag) and as every call made them before
    the cache (``maps_encoded_us``: cuTensorMapEncodeTiled each;
    ``attribute_set_us``: cudaFuncSetAttribute).  A sleep kernel holds the
    stream while the calls are enqueued, so no enqueue waits for the card."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as K6

    B_, S_, H_, d_ = q.shape
    out = torch.empty_like(q)
    lib = build.load(K6.NAME, {sym: K6._ARGS for sym in K6._SYMBOLS.values()})
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B_, S_, H_, k.shape[2],
            d_, int(causal), K6._strides(q, k, v, out), torch.cuda.current_stream().cuda_stream,
            None if lse is None else lse.data_ptr())

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 28)  # far longer than the calls' enqueue
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    split = {"shape": [B_, S_, H_, k.shape[2], d_], "calls": calls,
             "wrapper_us": host_us(lambda: K6.flash_attention(q, k, v, causal, lse=lse)),
             "launch_us": host_us(lambda: lib.flash_attention_bf16(*args))}
    parts = getattr(lib, "flash_attention_bf16_host_ns", None)
    if parts is not None:
        parts.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        parts.restype = ctypes.c_int
        ns = (ctypes.c_longlong * 4)()
        build.check(lib, K6.NAME, parts(*args[:3], *args[4:9], args[10], calls, ns))
        split.update({"maps_encoded_us": ns[0] / 1e3, "attribute_set_us": ns[1] / 1e3,
                      "maps_us": ns[2] / 1e3, "attribute_us": ns[3] / 1e3})
    split["python_us"] = split["wrapper_us"] - split["launch_us"]
    return split


def k6b_host_split(q, k, v, o, lse, do, causal: bool, calls: int = K6_HOST_CALLS) -> dict:
    """Host time of one bf16 K6' call (its enqueue), in microseconds a call,
    by part, as ``k6_host_split`` splits K6's: ``wrapper_us``,
    ``K6.flash_attention_backward`` whole; ``launch_us``, the C launch
    function alone (its launches included) with one call's arguments made
    once; and, where the library has ``flash_attention_backward_bf16_host_ns``
    (the two-pass rework under ``tools/kernel_variants/k6b_twopass``, not
    the shipped kernel), its eight tensor maps and two shared-memory
    attributes as its call makes them (``maps_us``: copies from the cache;
    ``attribute_us``: a check of a flag) and as every call of the shipped
    design makes them (``maps_encoded_us``: cuTensorMapEncodeTiled each;
    ``attribute_set_us``: cudaFuncSetAttribute).  ``python_us`` is the
    wrapper less the launch function."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as K6

    B_, S_, H_, d_ = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scratch = torch.empty((B_, H_, S_), device=q.device)  # D
    lib = build.load(K6.NAME_BWD, {sym: K6._ARGS_BWD for sym in K6._SYMBOLS_BWD.values()})
    strides = K6._strides(q, k, v, o, do)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B_, S_, H_, k.shape[2], d_, int(causal), strides,
            torch.cuda.current_stream().cuda_stream)

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 28)  # far longer than the calls' enqueue
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    split = {"shape": [B_, S_, H_, k.shape[2], d_], "calls": calls,
             "wrapper_us": host_us(lambda: K6.flash_attention_backward(q, k, v, o, lse, do,
                                                                       causal)),
             "launch_us": host_us(lambda: lib.flash_attention_backward_bf16(*args))}
    parts = getattr(lib, "flash_attention_backward_bf16_host_ns", None)
    if parts is not None:
        parts.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        parts.restype = ctypes.c_int
        ns = (ctypes.c_longlong * 4)()
        build.check(lib, K6.NAME_BWD, parts(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                            do.data_ptr(), B_, S_, H_, k.shape[2], d_, strides,
                                            calls, ns))
        split.update({"maps_encoded_us": ns[0] / 1e3, "attribute_set_us": ns[1] / 1e3,
                      "maps_us": ns[2] / 1e3, "attribute_us": ns[3] / 1e3})
    split["python_us"] = split["wrapper_us"] - split["launch_us"]
    return split


def k6_walk_checks(dev: torch.device, k6_planted, flush: torch.Tensor,
                   gen: torch.Generator) -> tuple[dict, dict]:
    """Phase 6's checks of the bf16 K6's persistent walk (the docstring at
    the top); ``k6_planted`` is the nvcc process and library of ``K6_PLANT``.
    Returns the trainer's timed row and the host-enqueue split."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as K6

    bf16 = torch.bfloat16

    def rnd(shape, dtype):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    # The bf16 kernel's walk at the trainer's layer (lm-small at the
    # trainer's batch: one KV tile a work tile) and at stablelm-3b's
    # prefill: two launches bit-equal, and the planted build whose walk
    # stops one unit short refused, run into a NaN-filled buffer (the
    # caching allocator hands the freed one back, checked by pointer).
    # At the trainer's, device times with and without the logsumexp
    # beside SDPA's forward and the bound.
    plant_log, _ = k6_planted[0].communicate()
    if k6_planted[0].returncode:
        raise RuntimeError(f"nvcc failed for K6's planted fault:\n{plant_log}")
    for label, (shape, hkv) in (("trainer", K6_TRAINER), ("stablelm prefill", K6_STABLELM)):
        q = rnd(shape, bf16)
        k, v = (rnd(shape[:2] + (hkv, shape[3]), bf16) for _ in "kv")
        want = ref.flash_attention_ref(q, k, v, True)
        name = f"K6 {label} bf16 {list(shape[:3]) + [hkv, shape[3]]} causal"
        got = K6.flash_attention(q, k, v, True)
        err = assert_close_rows(name, got, want, *LM_BF16_TOL)
        if not torch.equal(K6.flash_attention(q, k, v, True), got):
            raise AssertionError(f"{name}: two launches differ")
        log(f"  {name}: two launches bit-equal")

        def into_nan():
            buf = torch.full(shape, float("nan"), dtype=bf16, device=dev)
            ptr = buf.data_ptr()
            del buf
            o_ = K6.flash_attention(q, k, v, True)
            if o_.data_ptr() != ptr:
                raise AssertionError("K6's output is not the NaN-filled buffer just freed")
            return o_

        assert_close_rows(f"{name} into a NaN-filled buffer", into_nan(), want,
                          *LM_BF16_TOL)
        build.use_library(K6.NAME, k6_planted[1])
        try:
            bad = into_nan()
        finally:
            build.use_library(K6.NAME, build.library_path(K6.NAME))
        assert_refused(f"{name} with its tile walk one unit short, into a NaN-filled "
                       "buffer", bad, want, *LM_BF16_TOL)
        del got, bad
        if label == "trainer":
            lse = torch.empty((shape[0], shape[2], shape[1]), device=dev)
            kern = lambda: K6.flash_attention(q, k, v, True)  # noqa: E731
            kern_lse = lambda: K6.flash_attention(q, k, v, True, lse=lse)  # noqa: E731
            sdpa = lambda: sdpa_forward(q, k, v, True)  # noqa: E731
            bnd = k6_bound(q, k, True)
            k6_trainer = {
                "case": name, "max_abs_err": err, "device_ms": device_ms(kern),
                "lse_device_ms": device_ms(kern_lse), "library_device_ms": device_ms(sdpa),
                "ms": cuda_ms(kern, flush), "lse_ms": cuda_ms(kern_lse, flush),
                "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(q, k, v, True), flush,
                                    reps=5, warmup=1),
                "library_ms": cuda_ms(sdpa, flush), "bound_ms": bnd[0], "bound_by": bnd[1]}
            log(f"  {name}: device {k6_trainer['device_ms']:.6f} ms, with the logsumexp "
                f"{k6_trainer['lse_device_ms']:.6f}, SDPA's forward "
                f"{k6_trainer['library_device_ms']:.6f}, bound {bnd[0]:.6f} ({bnd[1]})")
            del lse
        del q, k, v, want
    # The host's enqueue of one bf16 call at lm-small's layer, by part.
    q = rnd((LMB_PREFILL[0], LMB_PREFILL[1], 8, 32), bf16)
    k, v = (rnd((LMB_PREFILL[0], LMB_PREFILL[1], 4, 32), bf16) for _ in "kv")
    lse = torch.empty((LMB_PREFILL[0], 8, LMB_PREFILL[1]), device=dev)
    k6_host = k6_host_split(q, k, v, True, lse)
    log("[lm_kernels] K6 host split " + json.dumps(k6_host))
    del q, k, v, lse
    return k6_trainer, k6_host


def sdpa_forward(q, k, v, causal: bool):
    """K6's yardstick, timed and never called by the port: one
    ``F.scaled_dot_product_attention`` call (GQA) on [B, S, heads, dh]
    tensors."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), is_causal=causal, enable_gqa=True)


def kernel_name(mangled: str) -> str:
    """``flash_decode_kernel<bf16, 80, 1>`` from a mangled entry-function
    name: the kernel and its type and integer template arguments (none for
    a kernel that is not a template)."""
    for m in re.finditer(r"_kernel[IE]", mangled):  # <length><name>I<args>E or E<params>
        end = m.start() + len("_kernel")
        n = next((n for n in range(1, end) if mangled[:end - n].endswith(str(n))), 0)
        name, rest = mangled[end - n:end], mangled[end:]
        if n and rest[0] == "E":
            return name
        if n:
            args, rest = [], rest[1:]
            for tok, label in ((r"13__nv_bfloat16", "bf16"), (r"f", "f32"), (r"d", "f64"),
                               (r"S\d*_", "S_"), (r"Li(\d+)E", None), (r"Lb([01])E", None)) * 4:
                t = re.match(tok, rest)
                if t:  # S<n>_ repeats an earlier type: here always the first
                    args.append(args[0] if label == "S_" else label or t.group(1))
                    rest = rest[t.end():]
            return f"{name}<{', '.join(args)}>"
    return mangled


def dtype_name(t: torch.Tensor) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16"}.get(t.dtype, str(t.dtype)[6:])


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def assert_close(name: str, got, want, rtol: float, atol: float) -> float:
    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err:.3e}, rtol {rtol}, atol {atol})")
    log(f"  {name}: ok, max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    return err


def limit_share(got, want, rtol: float, row_tol: float, head_floor: float = 0.0) -> float:
    """Largest |got - want| / (rtol |want| + row_tol rms(want's row)) over
    the elements, a row being the last dim: at most 1 is a pass.  A
    ``head_floor`` adds that share of the RMS of the element's (b, head) of a
    [B, S, heads, dh] tensor to the limit (K6''s gradients: a row can be 0
    exactly, where f32 sums in another order leave noise far below bf16's ulp)."""
    g, w = got.float(), want.float()
    lim = rtol * w.abs() + row_tol * w.pow(2).mean(-1, keepdim=True).sqrt()
    if head_floor:
        lim = lim + head_floor * w.pow(2).mean(dim=(1, 3), keepdim=True).sqrt()
    return float(((g - w).abs() / lim.clamp_min(1e-30)).max())


def assert_close_rows(name: str, got, want, rtol: float, row_tol: float,
                      head_floor: float = 0.0) -> float:
    err, share = max_err(got, want), limit_share(got, want, rtol, row_tol, head_floor)
    limit = f"rtol {rtol}, {row_tol} of the row's RMS" + (
        f", {head_floor} of the head's" if head_floor else "")
    if not share <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs "
                             f"err {err:.3e}, {share:.3f} of the limit: {limit})")
    log(f"  {name}: ok, max abs err {err:.3e}, {share:.3f} of the limit ({limit})")
    return err


def assert_refused(name: str, planted, want, rtol: float, row_tol: float,
                   head_floor: float = 0.0) -> None:
    """The check of ``assert_close_rows`` must fail on a planted fault."""
    err, share = max_err(planted, want), limit_share(planted, want, rtol, row_tol, head_floor)
    if share <= 1.0:
        raise AssertionError(f"{name}: the check accepts a planted fault (max abs err "
                             f"{err:.3e}, {share:.3f} of the limit)")
    log(f"  {name}: refused, max abs err {err:.3e}, {share:.3f} of the limit")


def assert_refused_close(name: str, planted, want, rtol: float, atol: float) -> None:
    """The check of ``assert_close`` must fail on a planted fault."""
    if torch.allclose(planted.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: the check accepts a planted fault (max abs err "
                             f"{max_err(planted, want):.3e})")
    log(f"  {name}: refused, max abs err {max_err(planted, want):.3e} (rtol {rtol}, "
        f"atol {atol})")


def assert_equal(name: str, got, want) -> float:
    """Bit-equal (NaN-free inputs: torch.equal counts -inf == -inf)."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel output is not bit-equal to its plain "
                             f"version ({tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype})")
    log(f"  {name}: ok, bit-equal")
    return 0.0


def assert_bits(name: str, got, want) -> float:
    """Bit-equal floats, NaN and the sign of zero included."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if (got.shape != want.shape or got.dtype != want.dtype
            or not torch.equal(got.view(ints[got.dtype]), want.view(ints[want.dtype]))):
        raise AssertionError(f"{name}: kernel output is not bit-equal to its plain "
                             f"version ({tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype})")
    log(f"  {name}: ok, bit-equal (NaN and signed zeros included)")
    return 0.0


def assert_bits_refused(name: str, planted, want) -> None:
    """The check of ``assert_bits`` must fail on a planted fault."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    rows = (planted.view(ints[planted.dtype]) != want.view(ints[want.dtype])).any(-1)
    if not bool(rows.any()):
        raise AssertionError(f"{name}: the bit check accepts a planted fault")
    log(f"  {name}: refused, {int(rows.sum())} row(s) differ, first at "
        f"{int(rows.nonzero()[0, 0])}")


def start_planted_build(build, name: str = "embedding_bag",
                        plant: tuple = K1B_PLANT) -> tuple[subprocess.Popen, Path]:
    """nvcc of ``csrc/<name>.cu`` with ``plant``'s text substituted (K1''s
    fill made to skip the last row, ``K1B_PLANT``; K6''s dK/dV loop made to
    skip a query tile, ``K6B_PLANT``), started beside the kernels' own
    builds."""
    out = ROOT / "build" / "chip_smoke_planted"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / f"{name}.cu").read_text()
    if src.count(plant[0]) != 1:
        raise AssertionError(f"a planted fault: its anchor is not once in {name}.cu")
    cu = out / f"{name}.cu"
    cu.write_text(src.replace(*plant))
    so = out / f"lib{name}_planted.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from repro_torch.hotcache import kernels as HK
    from repro_torch.kernels import dot_interaction as K2
    from repro_torch.kernels import embedding_bag as K1
    from repro_torch.kernels import flash_attention as K6
    from repro_torch.kernels import flash_decode as K7
    from repro_torch.prefetch import kernels as PK

    return {"embedding_bag": K1.launches, "embedding_bag_masked": K1.launches_masked,
            "dot_interaction": K2.launches,
            "probe_gather_pool": HK.launches[HK.PROBE],
            "scatter_update": HK.launches[HK.SCATTER],
            "topk_neighbor_select": PK.launches,
            "flash_attention": K6.launches, "flash_attention_f32": K6.launches_f32,
            "flash_decode": K7.launches, "flash_decode_partial": K7.launches_partial,
            "embedding_bag_backward": K1.launches_backward,
            "dot_interaction_backward": K2.launches_backward,
            "flash_attention_backward": K6.launches_bwd,
            "flash_attention_backward_f32": K6.launches_bwd_f32}


def reset_counts() -> None:
    from repro_torch.hotcache import kernels as HK
    from repro_torch.kernels import dot_interaction as K2
    from repro_torch.kernels import embedding_bag as K1
    from repro_torch.kernels import flash_attention as K6
    from repro_torch.kernels import flash_decode as K7
    from repro_torch.prefetch import kernels as PK

    K1.launches = K1.launches_masked = K1.launches_backward = 0
    K2.launches = K2.launches_backward = 0
    PK.launches = K6.launches = K6.launches_f32 = K7.launches = K7.launches_partial = 0
    K6.launches_bwd = K6.launches_bwd_f32 = 0
    HK.launches.update(dict.fromkeys(HK.launches, 0))


def assert_trees_close(name: str, got, want, rtol: float, atol: float,
                       scaled: bool = False) -> float:
    """Two trees of tensors with the same key strings in JAX's flatten order,
    no leaf missing, each leaf of the same shape and dtype and allclose (NaN
    where the other has NaN).  With ``scaled`` a leaf's atol is times its
    largest magnitude where that passes 1 (a gradient of ~10 sums terms of
    that size, and an element near 0 carries their rounding).  Returns the
    largest abs error over the finite elements."""
    from repro_torch.utils import keystr, tree_flatten_with_path

    got, want = tree_flatten_with_path(got), tree_flatten_with_path(want)
    keys = [keystr(p) for p, _ in got]
    if keys != [keystr(p) for p, _ in want]:
        raise AssertionError(f"{name}: leaves differ: {keys} vs "
                             f"{[keystr(p) for p, _ in want]}")
    worst = 0.0
    for key, (_, g), (_, w) in zip(keys, got, want):
        if not isinstance(g, torch.Tensor) or g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {key}: {g!r:.80} against {tuple(w.shape)} {w.dtype}")
        g, w = g.detach().float(), w.detach().float().to(g.device)
        fin = torch.isfinite(w)
        err = max_err(g[fin], w[fin])
        tol = atol * max(1.0, float(w[fin].abs().max())) if scaled and bool(fin.any()) else atol
        if not torch.allclose(g, w, rtol=rtol, atol=tol, equal_nan=True):
            raise AssertionError(f"{name} {key}: the trees disagree (max abs err "
                                 f"{err:.3e}, rtol {rtol}, atol {atol})")
        worst = max(worst, err)
    log(f"  {name}: ok, {len(keys)} leaves, max abs err {worst:.3e} (rtol {rtol}, "
        f"atol {atol}{' times a leaf largest magnitude past 1' if scaled else ''})")
    return worst


def trees_bit_equal(a, b) -> bool:
    from repro_torch.utils import tree_flatten_with_path

    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    return len(fa) == len(fb) and all(
        pa == pb and x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                        y.view(torch.int32) if y.dtype == torch.float32 else y)
        for (pa, x), (pb, y) in zip(fa, fb))


class RoutingLog:
    """Records the routing of every ``moe_apply_local`` call while it is
    entered (``models.moe``'s function wrapped; the call itself runs
    unchanged): per token, its top-k experts sorted, the experts it was
    kept at (-1 for a dropped assignment), and the margin of its k-th
    router probability over the next."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.calls = moe, []

    def __enter__(self):
        real = self.real = self.moe.moe_apply_local

        def wrapped(params, x, cfg, n_shards, shard):
            _, top_e, slots, _ = self.moe.moe_route(params["router"], x, cfg, n_shards, shard)
            probs = torch.softmax((x @ params["router"].to(x.dtype)).float(), -1)
            srt = probs.sort(-1, descending=True).values
            sentinel = cfg.num_experts // n_shards * self.moe.moe_capacity(cfg, x.shape[0])
            kept = torch.where((slots != sentinel).T, top_e, -1)
            self.calls.append((top_e.sort(-1).values.cpu(), kept.sort(-1).values.cpu(),
                               (srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]).cpu()))
            return real(params, x, cfg, n_shards, shard)

        self.moe.moe_apply_local = wrapped
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply_local = self.real

    def by_position(self, n_layers: int, batch: int, prompt: int, steps: int,
                    forward: bool = False) -> list:
        """Per layer, (top-k sets, kept sets, margins) laid out [B, P + steps]:
        from a prefill of ``prompt`` then ``steps`` decode steps, or from one
        ``forward`` over all the positions."""
        layers = []
        for li in range(n_layers):
            if forward:
                parts = [[t.reshape(batch, prompt + steps, *t.shape[1:])
                          for t in self.calls[li]]]
            else:
                parts = [[t.reshape(batch, prompt, *t.shape[1:]) for t in self.calls[li]]]
                parts += [[t.reshape(batch, 1, *t.shape[1:]) for t in self.calls[
                    n_layers * (1 + s) + li]] for s in range(steps)]
            layers.append([torch.cat(ts, 1) for ts in zip(*parts)])
        return layers


def routing_differs(name: str, a: list, b: list) -> tuple[torch.Tensor, list]:
    """[B, positions] bool: where two ``RoutingLog.by_position`` layouts route
    a token otherwise at some layer, and the k-th margins of the near ties
    that start it.  A token's first difference must be one of: its top-k
    set, with both sides' margins under MOE_TIE_MARGIN (a near tie); a
    consequence of a token flagged at an earlier layer and position of its
    sequence (attention carries it on); or its kept experts alone (capacity
    ranks the call's tokens, so a tie moves other tokens' slots).  Raises
    otherwise, or if more than MOE_TIE_SHARE of the tokens differ: a wrong
    kernel moves hidden states, and with them every later router."""
    flagged = torch.zeros(a[0][0].shape[:2], dtype=torch.bool)
    margins = []
    for li, ((sa, ka, ma), (sb, kb, mb)) in enumerate(zip(a, b)):
        topk = (sa != sb).any(-1)
        first = (topk | (ka != kb).any(-1)) & ~flagged
        downstream = (flagged.cumsum(1) - flagged.long()) > 0  # flagged earlier in the row
        tie = first & topk & ~downstream
        margin = torch.maximum(ma, mb)
        wide = tie & (margin >= MOE_TIE_MARGIN)
        if wide.any():
            raise AssertionError(f"{name}: layer {li}: {int(wide.sum())} token(s) routed "
                                 f"otherwise at k-th margins {margin[wide].tolist()[:8]}, "
                                 f"no near tie (< {MOE_TIE_MARGIN})")
        margins += margin[tie].tolist()
        flagged |= first
    if int(flagged.sum()) > MOE_TIE_SHARE * flagged.numel():
        raise AssertionError(f"{name}: {int(flagged.sum())} of {flagged.numel()} tokens routed "
                             f"otherwise, over the {MOE_TIE_SHARE:.0%} that near ties explain")
    return flagged, margins


def lm_decode_ring_bytes(cfg, shape: dict, b: int, batch_axes, seq_axes, fsdp_axes,
                         steps: int) -> dict:
    """A rank's bytes over ``steps`` of ``decode_step`` under a mesh of
    ``shape`` by the ring model, the params in ``mesh_param_specs(cfg,
    mesh, fsdp_axes)``: the token embedding's all-reduce [B_l, D] over
    model; each layer's all-gathers over model of the rank's query heads
    [B_l, Hp / tp, dh] and, where they divide tp, its KV heads; the max
    all-reduce of the row maxima [B_l, Hp] and the all-reduce of the
    scaled sums [B_l, Hp, dh + 1] over the sequence axes (f32); the
    all-reduces over model of the ``wo`` and ``wd`` partials and of the
    experts'.  Under ``cfg.fsdp`` with the batch over the FSDP axes every
    layer weight's model block is all-gathered there (in the param
    dtype); with no batch axes the residual's model dim is split over
    them, and its partial products (the norms' sums of squares in f32, q,
    k, v, the SwiGLU's columns, the head's) are all-reduced there, the
    experts' input and rows all-gathered there.  Activations in the
    compute dtype."""
    act, par = cfg.compute_dtype.itemsize, cfg.param_dtype.itemsize

    def size(axes):
        return math.prod(shape[a] for a in axes)

    def ar(n, g):
        return 2 * n * (g - 1) / g

    def ag(n, g):
        return n * (g - 1) / g

    tp, g_seq, bl = shape["model"], size(seq_axes), b // size(batch_axes)
    fsdp = size(fsdp_axes) if cfg.fsdp else 1
    partial = fsdp > 1 and not batch_axes
    D, dh, hp = cfg.d_model, cfg.d_head, -(-cfg.n_heads // tp) * tp
    kv = cfg.n_kv_heads % tp == 0
    hl, hkv_l = hp // tp, cfg.n_kv_heads // (tp if kv else 1)
    dm = D // fsdp if partial else D
    experts = 3 * cfg.moe.num_experts // tp * D * cfg.moe.d_ff * par if cfg.moe else 0
    out: dict = {}

    def add(op, v):
        if v:
            out[op] = out.get(op, 0) + steps * v

    add("all_reduce", ar(bl * D * act, tp))
    for _ in range(cfg.n_layers):
        add("all_gather", ag(bl * hp * dh * act, tp)
            + (2 * ag(bl * cfg.n_kv_heads * dh * act, tp) if kv else 0))
        add("all_reduce_max", ar(bl * hp * 4, g_seq))
        add("all_reduce", ar(bl * hp * (dh + 1) * 4, g_seq) + ar(bl * dm * act, tp))
        if cfg.dense_ffn():
            add("all_reduce", ar(bl * dm * act, tp))
        if cfg.moe:
            add("all_reduce", ar(bl * D * act, tp))
        if fsdp > 1 and not partial:
            dense = 3 * D * cfg.d_ff // tp * par if cfg.dense_ffn() else 0
            add("all_gather", ag(2 * D * hl * dh * par, fsdp) + 2 * ag(D * hkv_l * dh * par, fsdp)
                + ag(dense, fsdp) + ag(experts, fsdp))
        if partial:
            add("all_reduce", 2 * ar(bl * 4, fsdp) + ar(bl * hl * dh * act, fsdp)
                + 2 * ar(bl * hkv_l * dh * act, fsdp))
            if cfg.dense_ffn():
                add("all_reduce", 2 * ar(bl * cfg.d_ff // tp * act, fsdp))
            if cfg.moe:
                add("all_gather", ag(bl * D * act, fsdp) + ag(experts, fsdp))
    if partial:
        vp = -(-cfg.vocab // (128 * tp)) * 128 * tp
        add("all_reduce", ar(bl * 4, fsdp) + ar(bl * vp // tp * act, fsdp))
    return out


def sharded_decode_config(arch: str):
    """lm_sharded_decode's config: olmoe's widths in f32, heads and experts
    over model; or qwen2-72b's serving config (bf16 weights) with FSDP, in
    bf16 compute or (``qwen2_f32``) f32; cut to SHARDED_DECODE_LAYERS
    layers."""
    from repro_torch.configs.lm_common import serving_config
    from repro_torch.configs.olmoe_1b_7b import make_config as make_olmoe
    from repro_torch.configs.qwen2_72b import make_config as make_qwen2

    if arch == "olmoe":
        return dataclasses.replace(make_olmoe(), n_layers=SHARDED_DECODE_LAYERS, fsdp=False,
                                   param_dtype=torch.float32, compute_dtype=torch.float32)
    cfg = dataclasses.replace(serving_config(make_qwen2()), n_layers=SHARDED_DECODE_LAYERS,
                              fsdp=True)
    return dataclasses.replace(cfg, compute_dtype=torch.float32) if arch == "qwen2_f32" else cfg


def lm_sharded_rank(rank: int, world: int, params: dict, cases: list) -> dict:
    """One rank of the lm_sharded_decode phase (spawned by ``launch.mesh.spawn``
    over gloo; ``params`` (by config) and each case's caches, tokens and
    one-device logits are the main process's CUDA tensors, shared, never
    copied): for each case its mesh, its blocks of the params
    (``mesh_param_specs``, FSDP over the batch axes where the config has
    it) and caches (``cache_specs``, copied: the steps write them), the
    case's ``decode_step``s under the mesh with the launch counts and bytes
    read around them, then its logits' blocks against the one-device
    logits (f32 by ``assert_close``, bf16 by ``assert_close_rows``)."""
    from repro_torch.core.sharding import PartitionSpec as P
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as TF
    from repro_torch.utils import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    out: dict = {}
    for case in cases:
        name, arch, cfg = case["name"], case["arch"], case["cfg"]
        batch_axes, seq_axes, fsdp_axes = case["batch_axes"], case["seq_axes"], ("data",)
        mesh = M.Mesh(case["mesh"], ("data", "model"))
        p = R.shard_params(params[case["params"]], TF.mesh_param_specs(cfg, mesh, fsdp_axes),
                           mesh)
        held = {"layers": sum(t.numel() * t.element_size() for t in tree_leaves(p["layers"])),
                "embed_and_head": sum(p[k].numel() * p[k].element_size()
                                      for k in ("embed", "head"))}
        spec = TF.cache_specs(cfg, batch_axes, seq_axes)
        cache = tuple(L.constrain(c, spec, mesh).clone(memory_format=torch.contiguous_format)
                      for c in case["cache"])
        toks = L.constrain(case["tokens"], P(None, batch_axes or None), mesh)
        pos = torch.tensor(case["pos"], dtype=torch.int32, device=toks.device)
        logits = []
        reset_counts()
        before = M.comm_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for i in range(toks.shape[0]):
                lg, cache = TF.decode_step(cfg, p, cache, toks[i], pos, mesh, batch_axes,
                                           seq_axes, fsdp_axes=fsdp_axes)
                logits.append(lg)
                pos += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        sent = {op: v - before.get(op, 0.0) for op, v in M.comm_bytes().items()
                if v != before.get(op, 0.0)}
        got = torch.stack(logits)
        want = L.constrain(case["want"], P(None, batch_axes or None, "model"), mesh)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"[lm_sharded_decode] rank {rank} {name}: logits not finite")
        label = (f"[lm_sharded_decode] rank {rank} {name} {dict(mesh.coords)} logits block "
                 f"{list(got.shape)} over {toks.shape[0]} steps vs one device's decode")
        check = assert_close_rows if cfg.compute_dtype == torch.bfloat16 else assert_close
        err = check(label, got, want, *SHARDED_DECODE_TOL[arch])
        out[name] = {"coords": dict(mesh.coords), "launches": counts, "bytes": sent,
                     "max_abs_err": err, "wall_s": wall, "param_bytes": held,
                     "cache_block": list(cache[0].shape)}
        del p, cache, toks, logits, got, want
    return out


def sharded_rank(rank: int, world: int, fwd: dict, train: dict) -> dict:
    """One rank of the sharded_forward and sharded_train phases (spawned by
    ``launch.mesh.spawn`` over gloo; the arguments' CUDA tensors are phase
    4's and the one-device run's, shared with the main process, never
    copied).  Every check runs here on the card and raises on failure; the
    result holds this rank's launch counts, bytes, errors and wall times."""
    import dataclasses as dc

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.dlrm_flexemr import make_config
    from repro_torch.core.embedding import make_hash_cache_from_table
    from repro_torch.core.sharding import PartitionSpec as P
    from repro_torch.hotcache.table import HashCacheState
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers as L
    from repro_torch.models import recsys as R
    from repro_torch.optim import sharding_rules as SR

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))  # the host's cores
    out: dict = {"forward": {}, "train": {},
                 "stamps": {"imported": IMPORTED_AT, "start": time.time()}}

    # ------------------------------------------------------ sharded_forward
    mesh = M.make_debug_mesh(*SHARDED_FWD_MESH)
    out["stamps"]["forward_mesh"] = time.time()
    batch = fwd["batch"]
    cache = HashCacheState(*fwd["cache"])
    base = make_config()
    whole = {"emb": {"table": fwd["table"]}, **fwd["dense"]}
    # the hash cache built from the sharded table (gather_rows over model,
    # K4's writes) against the same build from the whole table
    emb = base.embedding(mesh.shape["model"])
    shard = R.shard_params(whole, R.param_specs(base, mesh.shape["model"]), mesh)["emb"]
    hot_ids = fwd["hot_ids"].cpu().numpy()
    out["stamps"]["shard_params"] = time.time()
    emb.gather_rows(shard, fwd["hot_ids"], mesh)
    torch.cuda.synchronize()
    out["stamps"]["gather_rows"] = time.time()
    reset_counts()
    built = make_hash_cache_from_table(emb, shard, hot_ids, HOT_SLOTS, mesh=mesh,
                                       max_probes=MAX_PROBES, device=fwd["table"].device)
    torch.cuda.synchronize()
    out["cache_build"] = {"launches": launch_counts()}
    want = HashCacheState(*fwd["built_cache"])
    for field in ("keys", "rows", "freq"):
        assert_equal(f"[sharded_forward] rank {rank} hash cache built from the sharded "
                     f"table, {field}", getattr(built, field), getattr(want, field))
    del built, want, shard
    out["stamps"]["cache_built"] = time.time()
    reset_counts()
    for name, mode, chunks, cached in SHARDED_FWD_CASES:
        cfg = dc.replace(base, mode=mode, num_chunks=chunks)
        ns = cfg.num_shards_for(mesh)
        emb = cfg.embedding(ns)
        params = R.shard_params(whole, R.param_specs(cfg, ns), mesh)
        c = cache if cached else None
        before = M.comm_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            pooled = emb.lookup(params["emb"], batch["indices"], batch["mask"], mesh=mesh,
                                cache=c, num_chunks=chunks)
        torch.cuda.synchronize()
        t_lookup = time.perf_counter() - t0
        sent = {op: v - before.get(op, 0.0) for op, v in M.comm_bytes().items()
                if v != before.get(op, 0.0)}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            scores = R.forward(cfg, params, batch, mesh, cache=c)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        counts = launch_counts()
        want_pooled = L.constrain(fwd["pooled"], P(emb.output_axes(("data",))), mesh)
        want_scores = L.constrain(fwd["scores"], P(("data", "model")), mesh)
        if pooled.shape != want_pooled.shape or scores.shape != want_scores.shape \
                or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"rank {rank} {name}: pooled {tuple(pooled.shape)}, scores "
                                 f"{tuple(scores.shape)} against {tuple(want_pooled.shape)}, "
                                 f"{tuple(want_scores.shape)}")
        errs = {"pooled": assert_close(f"[sharded_forward] rank {rank} {name} pooled "
                                       f"{list(pooled.shape)} vs one-device lookup", pooled,
                                       want_pooled, *SHARDED_FWD_TOL),
                "scores": assert_close(f"[sharded_forward] rank {rank} {name} scores "
                                       f"{list(scores.shape)} vs one-device forward", scores,
                                       want_scores, *SHARDED_FWD_TOL)}
        out["forward"][name] = {"launches": counts, "bytes": sent, "max_abs_err": errs,
                                "lookup_wall_s": t_lookup, "forward_wall_s": t_fwd}
    del whole, params, pooled, scores, cache, batch
    out["stamps"]["forward_cases"] = time.time()

    # ------------------------------------------------------- sharded_train
    mesh = M.make_debug_mesh(*SHARDED_TRAIN_MESH)
    out["stamps"]["train_mesh"] = time.time()
    tcfg = launch_train.make_dlrm_100m()
    dev = train["batches"][0]["indices"].device
    for layout in ("hierarchical", "mesh2d"):
        cfg = dc.replace(tcfg, mode=layout)
        ns = cfg.num_shards_for(mesh)
        pspecs = R.param_specs(cfg, ns)
        shapes = R.abstract_params(cfg, ns)
        opt = launch_train.make_optimizer()
        sspecs = SR.composite_state_specs([("emb", "rowwise"), (".*", "adam")], pspecs, shapes)
        step = R.make_train_step(cfg, opt, mesh)
        batches = [{k: L.constrain(v, P(("data",)), mesh) for k, v in b.items()}
                   for b in train["batches"]]
        p = R.shard_params(train["params0"], pspecs, mesh)
        st = opt.init(p)
        out["stamps"][f"train_{layout}_sharded"] = time.time()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for b in batches:
            p, st, m = step(p, st, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if not np.isfinite(losses).all():
            raise AssertionError(f"rank {rank} {layout}: losses {losses}")
        out["stamps"][f"train_{layout}_steps"] = time.time()
        want_p, want_s = train["p3s3"]
        tag = f"[sharded_train] rank {rank} {layout}"
        err = assert_trees_close(f"{tag}: params and state after {len(batches)} steps vs "
                                 "one device", (p, st),
                                 (R.shard_params(want_p, pspecs, mesh),
                                  R.shard_params(want_s, sspecs, mesh)), *TRAIN_STEP_TOL)
        out["stamps"][f"train_{layout}_checked"] = time.time()
        # the one-device checkpoint of step 1, restored under the mesh, against
        # the same state cut from memory: both go on one more step
        (pr, sr), _ = CheckpointManager(train["ckpt"]).restore(
            (shapes, opt.init(shapes)), step=1, mesh=mesh, specs=(pspecs, sspecs), device=dev)
        p1, s1 = train["p1s1"]
        pm, sm = R.shard_params(p1, pspecs, mesh), R.shard_params(s1, sspecs, mesh)
        restored_equal = trees_bit_equal((pr, sr), (pm, sm))
        out["stamps"][f"train_{layout}_restored"] = time.time()
        pr, sr, _ = step(pr, sr, batches[1])
        pm, sm, _ = step(pm, sm, batches[1])
        continued_equal = trees_bit_equal((pr, sr), (pm, sm))
        if not (restored_equal and continued_equal):
            raise AssertionError(f"{tag}: the restored checkpoint is not bit-equal to the "
                                 f"state it holds ({restored_equal}) or its steps to that "
                                 f"state's ({continued_equal})")
        out["train"][layout] = {"launches": counts, "losses": losses, "max_abs_err": err,
                                "steps_wall_s": wall, "restored_bit_equal": restored_equal,
                                "continued_bit_equal": continued_equal}
    out["stamps"]["train"] = time.time()
    return out


def recsys_config(arch_id: str, cap: int | None = None):
    """The registry's config of a recsys id, every table's rows capped at
    ``cap`` where given."""
    from repro_torch import configs

    cfg = getattr(configs, arch_id.replace("-", "_")).make_config()
    if cap is None:
        return cfg
    return dataclasses.replace(cfg, tables=tuple(
        dataclasses.replace(t, vocab=min(t.vocab, cap)) for t in cfg.tables))


def recsys_train_batch(arch_id: str, dev: torch.device) -> tuple:
    """Phase 5g's train step of an arch: its config with every table capped
    at ``RECSYS_TRAIN_ROWS`` and its ``train_batch`` (seed 0) on ``dev``."""
    from repro_torch.configs.recsys_common import RECSYS_SHAPES
    from repro_torch.data import synthetic as syn

    cfg = recsys_config(arch_id, RECSYS_TRAIN_ROWS)
    host = syn.recsys_batch(np.random.default_rng(0), cfg.tables,
                            RECSYS_SHAPES["train_batch"]["batch"], n_dense=cfg.n_dense)
    return cfg, {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def k1b_step_inputs(cfg, batch: dict, gen: torch.Generator, wide: bool = False) -> tuple:
    """K1''s inputs at a train step: the batch's fused ids and 0/1 weights,
    flat, as the lookup hands them over (masked mode), a random gradient
    [bags, D] from ``gen``, and the table's rows; ``wide`` takes the
    separate wide table's.  Zipf ids: a hot row's run spans the batch."""
    emb = cfg.wide_embedding() if wide else cfg.embedding()
    ids = emb._fused_rows(emb.sharded, batch["indices"]).reshape(-1).contiguous()
    w = batch["mask"].reshape(-1).to(torch.float32).contiguous()
    bags = batch["indices"].shape[0] * batch["indices"].shape[1]
    g = torch.randn((bags, emb.dim), device=ids.device, generator=gen)
    return g, ids, w, emb.sharded.total_rows


def k1b_hold_slot_order(name: str, got: torch.Tensor, again: torch.Tensor, g, ids, w,
                        V: int) -> dict:
    """K1''s masked output on a batch with hot rows, held bit for bit to
    host sums in slot order: the plain version on the CPU (``index_add_``,
    one slot after another) over the touched rows renumbered into a compact
    table, so that a run of thousands of slots is held exactly, which the
    card's plain version (atomics) cannot be.  Every other row must be 0.0
    exactly (its bits), and ``again``, a second launch, equal bit for bit.
    Returns the touched rows and the longest runs."""
    from repro_torch.kernels import embedding_bag as K1
    from repro_torch.kernels import ref

    live = w != 0
    rows, inverse, counts = torch.unique(ids[live].long().clamp(0, V - 1), return_inverse=True,
                                         return_counts=True)
    compact = torch.zeros_like(ids)
    compact[live] = inverse.to(torch.int32)
    want = ref.embedding_bag_backward_ref(g.cpu(), compact.cpu(), w.cpu(), rows.numel(),
                                          masked=True)
    assert_bits(f"{name}: its {rows.numel()} touched rows vs host sums in slot order",
                got[rows].cpu(), want)
    bits = got.view(torch.int32)
    if int(torch.count_nonzero(bits)) != int(torch.count_nonzero(bits[rows])):
        raise AssertionError(f"{name}: a row no live slot names is not 0.0")
    log(f"  {name}: the other {V - rows.numel()} rows are 0.0 exactly")
    assert_bits(f"{name}, twice", again, got)
    return {"touched_rows": rows.numel(), "live_slots": int(live.sum()),
            "longest_runs": torch.topk(counts, min(4, counts.numel())).values.tolist(),
            "runs_over_sort_cap": int((counts > K1.BWD_SORT_CAP).sum())}


def recsys_archs(dev: torch.device) -> dict:
    """Phase 5g: the six other recsys archs on the card.  K1 and K1' at this
    slice's widths against their plain versions; each arch's forward at its
    published config on ``serve_p99``'s batch (checked against the plain
    lookup and the dense stage on the CPU, timed, profiled); both
    retrievals against the same scores on the CPU; one train step of each
    at ``train_batch`` with every table capped (K1' on wide-deep's and
    two-tower's step batch held to host sums in slot order), and the loss
    and gradients at a small batch against the CPU.  Raises on any failure;
    returns the numbers and each path's launch counts."""
    import torch.nn.functional as F

    from repro_torch.configs.recsys_common import (N_CANDIDATES, RECSYS_SHAPES, RETRIEVAL_K,
                                                   make_recsys_optimizer)
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import embedding_bag as K1
    from repro_torch.kernels import ref
    from repro_torch.models import recsys as R
    from repro_torch.utils import keystr, tree_flatten_with_path, tree_to

    t_phase = time.perf_counter()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    serve_b = RECSYS_SHAPES["serve_p99"]["batch"]
    train_b = RECSYS_SHAPES["train_batch"]["batch"]
    out: dict = {"forward": {}, "retrieval": {}, "train": {}, "paths": {},
                 "k1_forward_shapes": {}, "k1b_train_shapes": {}}

    def batch_of(cfg, b: int) -> dict:
        rng = np.random.default_rng(0)
        host = (syn.mind_batch(rng, cfg.tables[0].vocab, b, cfg.hist_len) if cfg.arch == "mind"
                else syn.recsys_batch(rng, cfg.tables, b, n_dense=cfg.n_dense))
        return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

    def lookups(cfg) -> int:
        return 0 if cfg.arch == "mind" else 2 if cfg.separate_wide else 1

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    # ---- K1 (masked and weighted) and K1' at this slice's widths and bag
    # shapes, half the slots at weight 0; at the serve batch ids outside
    # [0, V) too.  At the train batch the ids stay inside: K1''s plain
    # version on the card adds with atomics, whose order K1B_TOL covers for
    # rows of tens of terms, and a clamped id names row 0 or V - 1 from
    # hundreds of slots (phases 3 and 5f hold clamping at 1003 bags)
    log("[recsys_archs] K1 and K1' at the archs' widths against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(7)
    for D, nnz, fields in RECSYS_K1_WIDTHS:
        tab = torch.randn((RECSYS_K1_ROWS, D), device=dev, generator=gen)
        for bags in (serve_b * fields, train_b * fields):
            n = bags * nnz
            edge = 50 if bags == serve_b * fields else 0
            ids = torch.randint(-edge, RECSYS_K1_ROWS + edge, (n,), device=dev, generator=gen,
                                dtype=torch.int32)
            w = torch.rand(n, device=dev, generator=gen) + 0.5
            w[torch.rand(n, device=dev, generator=gen) < 0.5] = 0.0
            for masked in (True, False):
                mode = "masked" if masked else "weighted"
                assert_close(f"K1 {mode} D {D} nnz {nnz} [{bags} bags, ids in "
                             f"[{-edge}, {RECSYS_K1_ROWS + edge})]",
                             K1.embedding_bag(tab, ids, w, bags, masked=masked),
                             ref.embedding_bag_ref(tab, ids, w, bags, masked=masked), 1e-5, 1e-5)
            if bags == serve_b * fields:
                continue
            g = torch.randn((bags, D), device=dev, generator=gen)
            for masked in (True, False):
                mode = "masked" if masked else "weighted"
                assert_close(f"K1' {mode} D {D} nnz {nnz} [{bags} bags] -> "
                             f"[{RECSYS_K1_ROWS}, {D}]",
                             K1.embedding_bag_backward(g, ids, w, RECSYS_K1_ROWS, masked=masked),
                             ref.embedding_bag_backward_ref(g, ids, w, RECSYS_K1_ROWS,
                                                            masked=masked), *K1B_TOL)
        del tab, ids, w, g
        free()

    def k1_times(table, ids, w, bags) -> dict:
        """K1 masked, its plain version and F.embedding_bag on the lookup's
        own inputs, beside the bound of the live slots' rows."""
        live = ids[w != 0]
        D = table.shape[1]
        ms = bound(torch.unique(live).numel() * D * 4 + ids.numel() * 8 + bags * D * 4,
                   2 * live.numel() * D)
        ids2, w2 = ids.view(bags, -1), w.view(bags, -1)
        return {"case": f"masked f32 [{bags} bags x {ids.numel() // bags}] of "
                        f"[{table.shape[0]}, {D}]",
                "ms": cuda_ms(lambda: K1.embedding_bag(table, ids, w, bags, masked=True), flush),
                "plain_ms": cuda_ms(lambda: ref.embedding_bag_ref(table, ids, w, bags,
                                                                  masked=True), flush),
                "library_ms": cuda_ms(lambda: F.embedding_bag(
                    ids2, table, mode="sum", per_sample_weights=w2), flush),
                "bound_ms": ms[0], "bound_by": ms[1]}

    # ---- forward at the published configs, and the two retrievals
    for arch_id in RECSYS_ARCH_IDS:
        cfg = recsys_config(arch_id)
        t0 = time.perf_counter()
        params = R.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        table_gb = sum(params[k]["table"].numel() * 4 for k in ("emb", "wide") if k in params) / 1e9
        log(f"[recsys_archs] {arch_id}: tables {table_gb:.2f} GB f32 made on the card in "
            f"{init_s:.2f}s, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        batch = batch_of(cfg, serve_b)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            scores = R.forward(cfg, params, batch)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        counts = out["paths"][f"recsys_forward.{cfg.arch}"] = launch_counts()
        n = lookups(cfg)
        if counts["embedding_bag"] != n or counts["embedding_bag_masked"] != n:
            raise AssertionError(f"{arch_id} forward: K1 (masked) {n} times expected: {counts}")
        if scores.shape != (serve_b,) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"{arch_id} forward: scores {tuple(scores.shape)} not finite")
        emb = cfg.embedding()
        with torch.no_grad():
            if cfg.arch == "mind":
                table = params["emb"]["table"]
                rows, tgt, hm = R.mind_lookup(cfg, emb, params, batch, None, ())
                rows_plain = torch.where(batch["hist_mask"][..., None],
                                         table[batch["hist"].long()], 0.0)
                tgt_plain = table[batch["target"].long()]
                assert_close(f"{arch_id} lookup_rows [{serve_b}, {cfg.hist_len}, "
                             f"{cfg.embed_dim}] vs indexing", rows, rows_plain, 1e-5, 1e-5)
                assert_close(f"{arch_id} target rows vs indexing", tgt, tgt_plain, 1e-5, 1e-5)
                dense_cpu = tree_to({k: v for k, v in params.items() if k != "emb"}, "cpu")
                want = R.mind_dense_stage(cfg, dense_cpu, rows_plain.cpu(), tgt_plain.cpu(),
                                          batch["hist_mask"].cpu())
                del rows, tgt, hm, rows_plain, tgt_plain
            else:
                idx, msk = batch["indices"], batch["mask"]
                pooled_plain = emb.lookup_reference(params["emb"], idx, msk)
                assert_close(f"{arch_id} lookup {list(pooled_plain.shape)} vs lookup_reference",
                             emb.lookup(params["emb"], idx, msk), pooled_plain, 1e-5, 1e-5)
                wide_plain = None
                if cfg.separate_wide:
                    wemb = cfg.wide_embedding()
                    wide_plain = wemb.lookup_reference(params["wide"], idx, msk)
                    assert_close(f"{arch_id} wide lookup {list(wide_plain.shape)} vs "
                                 "lookup_reference", wemb.lookup(params["wide"], idx, msk),
                                 wide_plain, 1e-5, 1e-5)
                    wide_plain = wide_plain.cpu()
                dense_cpu = tree_to({k: v for k, v in params.items()
                                     if k not in ("emb", "wide")}, "cpu")
                want = R.dense_stage(cfg, dense_cpu, pooled_plain.cpu(),
                                     batch["dense"].cpu() if cfg.n_dense else None, wide_plain)
                del pooled_plain
        err = assert_close(f"{arch_id} forward scores [{serve_b}] vs the plain lookup and "
                           "the dense stage on the CPU", scores.cpu(), want, 1e-4, 1e-5)

        def fwd():
            with torch.no_grad():
                return R.forward(cfg, params, batch)

        prof = device_busy(fwd, 3, kernels=("embedding_bag_kernel",))
        k1_ms = prof["kernels_ms_per_call"]["embedding_bag_kernel"]
        out["forward"][arch_id] = {
            "table_gb": table_gb, "init_s": init_s, "first_call_ms": first_ms,
            "device_ms": cuda_ms(fwd, flush), "device_busy_ms": prof["device_busy_ms"],
            "k1_ms": k1_ms, "k1_share": (k1_ms / prof["device_busy_ms"]
                                         if prof["device_busy_ms"] else None),
            "device_ops_per_call": prof["device_ops_per_call"],
            "top_kernels_ms_per_call": prof["top_kernels_ms_per_call"],
            "scores_max_abs_err": err, "launches": {k: v for k, v in counts.items() if v}}
        if arch_id in ("wide-deep", "two-tower-retrieval"):  # K1 at the forward's shape
            fused = emb._fused_rows(emb.sharded, batch["indices"]).reshape(-1).contiguous()
            wts = batch["mask"].reshape(-1).to(torch.float32).contiguous()
            out["k1_forward_shapes"][arch_id] = k1_times(
                params["emb"]["table"], fused, wts, serve_b * cfg.num_fields)
            del fused, wts

        if cfg.arch == "two_tower":  # 8 queries against N_CANDIDATES item vectors
            queries = {k: v for k, v in batch_of(cfg, 8).items() if k in ("indices", "mask")}
            cands = torch.randn((N_CANDIDATES, cfg.mlp[-1]), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(0))
            reset_counts()
            vals, top = R.retrieval_topk(cfg, params, queries, cands, k=RETRIEVAL_K)
            torch.cuda.synchronize()
            counts = out["paths"]["retrieval.two_tower"] = launch_counts()
            with torch.no_grad():
                pooled = emb.lookup_reference(params["emb"], queries["indices"],
                                              queries["mask"]).cpu()
                u, _ = R.two_tower_encode(cfg, dense_cpu, pooled)
                host_scores = u @ cands.cpu().T
            rt = lambda: R.retrieval_topk(cfg, params, queries, cands, k=RETRIEVAL_K)  # noqa: E731
            name = "two_tower"
        elif cfg.arch == "mind":  # one user against N_CANDIDATES distinct items
            user = {k: v[:1] for k, v in batch.items() if k in ("hist", "hist_mask")}
            user["cand_ids"] = torch.randperm(
                cfg.tables[0].vocab, device=dev, generator=torch.Generator(device=dev).manual_seed(0)
            )[:N_CANDIDATES].to(torch.int32)
            reset_counts()
            vals, top = R.mind_retrieval(cfg, params, user, k=RETRIEVAL_K)
            torch.cuda.synchronize()
            counts = out["paths"]["retrieval.mind"] = launch_counts()
            with torch.no_grad():
                table = params["emb"]["table"]
                rows = torch.where(user["hist_mask"][..., None], table[user["hist"].long()], 0.0)
                interests = R.mind_interests(cfg, dense_cpu, rows.cpu(), user["hist_mask"].cpu())
                host_scores = torch.einsum("nd,bkd->bnk", table[user["cand_ids"].long()].cpu(),
                                           interests).amax(dim=-1)
            rt = lambda: R.mind_retrieval(cfg, params, user, k=RETRIEVAL_K)  # noqa: E731
            name = "mind"
        if cfg.arch in ("two_tower", "mind"):
            if counts["embedding_bag"] != n:
                raise AssertionError(f"retrieval.{name}: K1 {n} times expected: {counts}")
            want_v, _ = torch.topk(host_scores, RETRIEVAL_K, dim=-1)
            verr = assert_close(f"retrieval.{name} top-{RETRIEVAL_K} values of "
                                f"{host_scores.shape[1]} candidates vs the CPU's scores",
                                vals.cpu(), want_v, 1e-5, 1e-5)
            assert_close(f"retrieval.{name}: each index's score on the CPU vs its value",
                         host_scores.gather(1, top.cpu()), vals.cpu(), 1e-5, 1e-5)
            out["retrieval"][name] = {
                "queries": int(vals.shape[0]), "candidates": int(host_scores.shape[1]),
                "k": RETRIEVAL_K, "device_ms": cuda_ms(rt, flush), "max_abs_err": verr,
                "launches": {k: v for k, v in counts.items() if v}}
            del vals, top, host_scores
        del params, batch, scores, want, dense_cpu, emb
        free()

    # ---- train: one step at train_batch with each table capped; the loss
    # and gradients at a small batch against the same on the CPU
    for arch_id in RECSYS_ARCH_IDS:
        cfg = recsys_config(arch_id, RECSYS_TRAIN_ROWS)
        params = R.init_params(cfg, seed=0, device=dev)
        opt = make_recsys_optimizer()
        state = opt.init(params)
        batch = batch_of(cfg, train_b)
        step = R.make_train_step(cfg, opt)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, state, batch)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        counts = out["paths"][f"recsys_train.{cfg.arch}"] = launch_counts()
        n = lookups(cfg)
        if any(counts[k] != n for k in ("embedding_bag", "embedding_bag_masked",
                                         "embedding_bag_backward")):
            raise AssertionError(f"{arch_id} train step: K1 (masked) and K1' {n} times "
                                 f"expected: {counts}")
        loss = float(m["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"{arch_id} train step: loss {loss}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _, grads = R.loss_and_grads(cfg, params, batch)
        for path, g in tree_flatten_with_path(grads):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{arch_id} train step: gradient {keystr(path)} not finite")
        del grads, m
        prof = device_busy(lambda: step(params, state, batch), 1,
                           kernels=("embedding_bag_kernel", "bag_backward_kernel<"))
        out["train"][arch_id] = {
            "batch": train_b, "rows_cap": RECSYS_TRAIN_ROWS, "loss": loss,
            "first_call_ms": first_ms, "device_busy_ms": prof["device_busy_ms"],
            "kernels_ms": prof["kernels_ms_per_call"], "peak_gb": peak_gb,
            "top_kernels_ms_per_call": prof["top_kernels_ms_per_call"],
            "launches": {k: v for k, v in counts.items() if v}}
        log(f"[recsys_archs] {arch_id} train step at {train_b}: loss {loss:.6f}, device busy "
            f"{prof['device_busy_ms']} ms, peak {peak_gb:.2f} GB, top kernels "
            + json.dumps(prof["top_kernels_ms_per_call"]))
        # K1' at the step's shape, on its Zipf batch: bit for bit to host sums
        # in slot order on the touched rows (its hot runs span the batch),
        # 0.0 elsewhere, twice the same; then timed
        for wide in ((False, True) if arch_id == "wide-deep" else
                     (False,) if arch_id == "two-tower-retrieval" else ()):
            g, ids, w, V = k1b_step_inputs(cfg, batch, gen, wide)
            bags, D = g.shape
            name = f"{arch_id}{'.wide' if wide else ''}"
            got = K1.embedding_bag_backward(g, ids, w, V, masked=True)
            hot = k1b_hold_slot_order(f"K1' at {name}'s train step [{bags} bags x "
                                      f"{ids.numel() // bags}] -> [{V}, {D}]", got,
                                      K1.embedding_bag_backward(g, ids, w, V, masked=True),
                                      g, ids, w, V)
            del got
            live = w != 0
            contrib = (g.repeat_interleave(ids.numel() // bags, dim=0) * w[:, None])[live]
            live_idx = ids[live].long()
            ms = bound(V * D * 4 + g.numel() * 4 + ids.numel() * 8, 2 * live_idx.numel() * D)
            out["k1b_train_shapes"][name] = {
                "case": f"masked [{bags} bags x {ids.numel() // bags}] -> [{V}, {D}] f32",
                "ms": cuda_ms(lambda: K1.embedding_bag_backward(g, ids, w, V, masked=True),
                              flush, reps=5, warmup=1),
                "plain_ms": cuda_ms(lambda: ref.embedding_bag_backward_ref(
                    g, ids, w, V, masked=True), flush, reps=3, warmup=1),
                "library_ms": cuda_ms(lambda: torch.zeros((V, D), device=dev).index_add_(
                    0, live_idx, contrib), flush, reps=5, warmup=1),
                "bound_ms": ms[0], "bound_by": ms[1], "bit_equal_to_slot_order": True, **hot}
            del g, contrib, live_idx, ids, w, live
        del params, state, batch, step, opt
        free()

        scfg = recsys_config(arch_id, RECSYS_CHECK_ROWS)
        sparams = R.init_params(scfg, seed=0, device=dev)
        sbatch = batch_of(scfg, RECSYS_CHECK_BATCH)
        loss_c, grads_c = R.loss_and_grads(scfg, sparams, sbatch)
        loss_h, grads_h = R.loss_and_grads(scfg, tree_to(sparams, "cpu"),
                                           {k: v.cpu() for k, v in sbatch.items()})
        assert_close(f"{arch_id} loss at {RECSYS_CHECK_BATCH}, card vs CPU", loss_c.cpu(),
                     loss_h, *TRAIN_GRAD_TOL)
        out["train"][arch_id]["grad_max_abs_err"] = assert_trees_close(
            f"{arch_id} gradients at {RECSYS_CHECK_BATCH}, tables capped at "
            f"{RECSYS_CHECK_ROWS} rows, card vs CPU", grads_c, grads_h, *TRAIN_GRAD_TOL,
            scaled=True)
        del sparams, sbatch, grads_c, grads_h
        free()
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out


def recsys_cell_ring_bytes(cfg, kind: str, batch: int, mesh_shape=RECSYS_CELL_MESH,
                           k: int = 100, queries: int = RECSYS_CELL_QUERIES) -> dict:
    """One rank's bytes of a recsys registry cell under a (data, model) mesh
    by the ring model, f32, the paper layout (tables over model, the batch
    over data; ``batch`` is a retrieval cell's candidate count).  Each
    lookup: an all-reduce over model of the data rank's pooled rows (the
    separate wide table's too; mind's raw history and target rows).  Train:
    their transposes, the loss over the mesh, each table block's gradient
    over data and each dense leaf's over the mesh; two-tower all-gathers the
    item vectors and reduce-scatters their cotangent, mind all-gathers each
    rank's last score (the BPR negative) and reduce-scatters its cotangent.
    Retrieval: the lookups (two-tower's queries whole on every rank; mind's
    history whole, its candidates over data), then each rank's top k values
    and int32 positions all-gathered over the candidates' axes."""
    from repro_torch.models import recsys as R
    from repro_torch.utils import tree_flatten_with_path

    dp, tp = mesh_shape
    world = dp * tp
    ar = lambda n, g: 2 * n * (g - 1) / g  # noqa: E731
    ag = lambda n, g: n * (g - 1) / g  # noqa: E731
    F, D = cfg.num_fields, cfg.embed_dim
    out: dict = {}

    def add(op: str, v: float) -> None:
        out[op] = out.get(op, 0) + v

    def topk(rows: int, n_loc: int, g: int) -> None:
        add("all_gather", 2 * ag(rows * min(k, n_loc) * g * 4, g))

    if kind == "retrieval" and cfg.arch == "two_tower":
        add("all_reduce", ar(queries * F * D * 4, tp))
        topk(queries, batch // world, world)
        return out
    if kind == "retrieval" and cfg.arch == "mind":
        add("all_reduce", ar(cfg.hist_len * D * 4, tp) + ar(batch // dp * D * 4, tp))
        topk(1, batch // dp, dp)
        return out
    bl = batch // dp
    if cfg.arch == "mind":
        lookups = ar(bl * cfg.hist_len * D * 4, tp) + ar(bl * D * 4, tp)
    else:
        lookups = ar(bl * F * D * 4, tp)
        if cfg.separate_wide:
            lookups += ar(bl * F * R.WIDE_DIM * 4, tp)
    add("all_reduce", lookups)
    if kind == "retrieval":
        topk(1, batch // world, world)
    if kind != "train":
        return out
    dense = tables = 0.0
    for path, t in tree_flatten_with_path(R.abstract_params(cfg, tp)):
        if path[0] in ("emb", "wide"):
            tables += ar(t.numel() * 4 / tp, dp)
        else:
            dense += t.numel() * 4
    add("all_reduce", lookups + ar(4, world) + ar(dense, world) + tables)
    if cfg.arch == "two_tower":
        d = cfg.mlp[-1]
        add("all_gather", ag(batch * d * 4, world))
        add("reduce_scatter", batch // world * d * 4 * (world - 1))
    if cfg.arch == "mind":
        add("all_gather", ag(world * 4, world))
        add("reduce_scatter", 4 * (world - 1))
    return out


def recsys_cell_configs(arch_id: str) -> tuple:
    """(config, train config, {shape: batch or candidate count}) of a recsys
    registry id for phase 5g2: every table capped at RECSYS_CELL_ROWS, the
    train config's halved further until a rank's table-gradient all-reduce
    over data takes at most half of RECSYS_CELL_MAX_BYTES, and each cell's
    batch halved from its own until the rank's ring-model bytes fit
    RECSYS_CELL_MAX_BYTES (mind's candidates also to distinct items)."""
    from repro_torch.configs.recsys_common import RECSYS_SHAPES
    from repro_torch.models import recsys as R
    from repro_torch.utils import tree_flatten_with_path

    def table_bytes(c) -> float:
        dp, tp = RECSYS_CELL_MESH
        return sum(2 * t.numel() * 4 / tp * (dp - 1) / dp
                   for path, t in tree_flatten_with_path(R.abstract_params(c, tp))
                   if path[0] in ("emb", "wide"))

    cfg, cap = recsys_config(arch_id, RECSYS_CELL_ROWS), RECSYS_CELL_ROWS
    while table_bytes(recsys_config(arch_id, cap)) > RECSYS_CELL_MAX_BYTES / 2 and cap > 1:
        cap //= 2
    tcfg = recsys_config(arch_id, cap)
    sizes = {}
    for shape, info in RECSYS_SHAPES.items():
        kind = info["kind"]
        c = tcfg if kind == "train" else cfg
        n = info["n_candidates"] if kind == "retrieval" else info["batch"]
        if kind == "retrieval" and c.arch == "mind":
            while n > c.tables[0].vocab:  # distinct items: tie-free scores
                n //= 2
        world = RECSYS_CELL_MESH[0] * RECSYS_CELL_MESH[1]
        while (sum(recsys_cell_ring_bytes(c, kind, n).values()) > RECSYS_CELL_MAX_BYTES
               and n % (2 * world) == 0):
            n //= 2
        if (n % world or sum(recsys_cell_ring_bytes(c, kind, n).values())
                > RECSYS_CELL_MAX_BYTES):
            raise ValueError(f"{arch_id} {shape}: no batch of {n} or more that splits over "
                             f"the mesh fits {RECSYS_CELL_MAX_BYTES} bytes a rank")
        sizes[shape] = n
    return cfg, tcfg, sizes


@contextlib.contextmanager
def recsys_cell_sizes(sizes: dict):
    """``recsys_common.RECSYS_SHAPES`` set to one arch's phase-5g2 sizes
    inside the ``with`` block, restored after."""
    from repro_torch.configs.recsys_common import RECSYS_SHAPES

    saved = {s: dict(v) for s, v in RECSYS_SHAPES.items()}
    try:
        for shape, n in sizes.items():
            RECSYS_SHAPES[shape]["n_candidates" if RECSYS_SHAPES[shape]["kind"] == "retrieval"
                                 else "batch"] = n
        yield
    finally:
        for shape, v in saved.items():
            RECSYS_SHAPES[shape].update(v)


def recsys_cell_launches(cfg, kind: str) -> dict:
    """The launch counts one rank's cell must show, every other kernel 0:
    K1 masked once a lookup (wide-deep's and deepfm's two, mind's raw rows
    none), K1' once a lookup in a train step, K2 in the DLRM's forward and
    K2' in its train step."""
    n = 0 if cfg.arch == "mind" else 2 if cfg.separate_wide else 1
    want = {"embedding_bag": n, "embedding_bag_masked": n}
    if kind == "train":
        want["embedding_bag_backward"] = n
    if cfg.arch == "dlrm":
        want["dot_interaction"] = 1
        if kind == "train":
            want["dot_interaction_backward"] = 1
    return want


def mesh_close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
               atol: float) -> float:
    """A rank's block against one device's, allclose; the largest abs error."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: {tuple(got.shape)} against {tuple(want.shape)}")
    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: the mesh's block disagrees with one device's (max abs "
                             f"err {err:.3e}, rtol {rtol}, atol {atol})")
    return err


def hold_rows(name: str, got: torch.Tensor, want: torch.Tensor, spec, mesh, rows: int,
              rtol: float, atol: float) -> float:
    """A rank's block ``got`` of a leaf whose mesh layout holds ``rows``
    rows, against one device's whole ``want`` (a table's rows without the
    shard count's padding: only the rows both hold are compared)."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L

    if want.shape[0] == rows:
        return mesh_close(name, got, L.constrain(want, spec, mesh), rtol, atol)
    lo = M.block_slices((rows,) + tuple(want.shape[1:]), spec, mesh)[0].start or 0
    n = max(0, min(lo + got.shape[0], want.shape[0]) - lo)
    return mesh_close(name, got[:n], want[lo:lo + n], rtol, atol)


def recsys_cell_rank(rank: int, world: int, archs: list) -> dict:
    """One rank of phase 5g2 (spawned by ``launch.mesh.spawn`` over gloo; the
    params, batches and one device's outputs are CUDA tensors of the main
    process, shared through CUDA IPC).  Arch by arch and cell by cell: the
    cell built under the mesh, this rank's blocks of its global arguments
    by its ``in_shardings`` (``CellBuild.blocks``), a train cell's
    gradients by an optimizer that returns them (not counted), then the
    cell's step, counted and held against one device's run.  Raises on a
    failure; returns each cell's launches, bytes, errors and wall time."""
    from repro_torch.configs import recsys_common as RC
    from repro_torch.core.sharding import PartitionSpec as P
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import recsys as R
    from repro_torch.optim import optimizers as O
    from repro_torch.utils import keystr, tree_flatten_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    mesh = M.make_debug_mesh(*RECSYS_CELL_MESH)
    grads_of = O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))
    out: dict = {}
    for a in archs:
        arch_id = a["arch"]
        with recsys_cell_sizes(a["sizes"]):
            for shape, info in RC.RECSYS_SHAPES.items():
                kind = info["kind"]
                cfg = a["train_cfg"] if kind == "train" else a["cfg"]
                params = a["train_params"] if kind == "train" else a["params"]
                batch, want = a["batches"][shape], a["want"][shape]
                cell = RC._build(shape, mesh, False, cfg_fn=lambda cfg=cfg: cfg)
                if kind == "train":
                    args = (params, RC.make_recsys_optimizer().init(params), batch)
                elif len(cell.args) == 3:
                    args = (params, batch, a["cands"])
                else:
                    args = (params, batch)
                blocks = cell.blocks(args, mesh)
                tag = f"[recsys_cells] rank {rank} {arch_id} {shape}"
                if kind == "train":
                    grads, _, gm = R.make_train_step(cfg, grads_of, mesh)(blocks[0], (), blocks[2])
                reset_counts()
                before = M.comm_bytes()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.set_grad_enabled(kind == "train"):
                    res = cell.step_fn(*blocks)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = launch_counts()
                sent = {op: v - before.get(op, 0.0) for op, v in M.comm_bytes().items()
                        if v != before.get(op, 0.0)}
                errs = {}
                if kind == "serve":
                    atol = RECSYS_CELL_SERVE_TOL[1]
                    if cfg.arch == "two_tower":  # a cosine over the temperature
                        atol /= float(params["temp"])
                    errs["scores"] = mesh_close(
                        f"{tag} scores", res, L.constrain(want["scores"], P(("data", "model")),
                                                          mesh), RECSYS_CELL_SERVE_TOL[0], atol)
                elif kind == "retrieval":
                    vals, idx = res
                    gaps = -torch.diff(want["values"], dim=-1)
                    errs["values"] = mesh_close(f"{tag} top-k values", vals, want["values"],
                                                *RECSYS_CELL_SERVE_TOL)
                    if not bool((gaps > errs["values"]).all()):
                        raise AssertionError(f"{tag}: top scores closer than the values' "
                                             f"difference {errs['values']}: {gaps.min()}")
                    if not torch.equal(idx, want["indices"]):
                        raise AssertionError(f"{tag}: top-k indices differ from one device's")
                else:
                    new_p, new_s, m = res
                    pspecs, sspecs = cell.in_shardings[0], cell.in_shardings[1]
                    rows = {keystr(p): t.shape[0] for p, t in tree_flatten_with_path(
                        (params, args[1])) if t.ndim}
                    rows = {k[3:]: v for k, v in rows.items()}  # less the tuple's index
                    rtol, atol = RECSYS_CELL_TRAIN_TOL
                    errs["loss"] = mesh_close(f"{tag} loss", m["loss"], want["loss"], rtol, atol)
                    errs["grads_loss"] = mesh_close(f"{tag} loss (gradient run)", gm["loss"],
                                                    want["loss"], rtol, atol)

                    def hold(what, got_tree, specs, want_tree, scaled=False):
                        """Leaf by leaf, atol times the leaf's largest
                        magnitude past 1 where ``scaled``."""
                        worst = 0.0
                        wants = {keystr(p): t for p, t in tree_flatten_with_path(want_tree)}
                        spec_of = {keystr(p): s for p, s in tree_flatten_with_path(
                            specs, lambda x: isinstance(x, P))}
                        got_flat = tree_flatten_with_path(got_tree)
                        if sorted(keystr(p) for p, _ in got_flat) != sorted(wants):
                            raise AssertionError(f"{tag} {what}: leaves differ")
                        for p, got in got_flat:
                            key, w = keystr(p), wants[keystr(p)]
                            scale = max(1.0, float(w.abs().max())) if scaled and w.numel() else 1.0
                            name = f"{tag} {what} {key}"
                            worst = max(worst, mesh_close(name, got, w, rtol, atol) if got.ndim == 0
                                        else hold_rows(name, got, w, spec_of[key], mesh,
                                                       rows[key], rtol, atol * scale))
                        return worst

                    errs["grads"] = hold("gradient", grads, pspecs, want["grads"], scaled=True)
                    errs["state"] = hold("optimizer state", new_s, sspecs, want["state"])
                    # the params against the optimizer on this rank's own
                    # gradients: Adam's first step lr g / (|g| + 1e-8) turns a
                    # near-zero gradient's rounding into a step apart
                    opt = RC.make_recsys_optimizer()
                    own_p, _ = opt.update(grads, opt.init(blocks[0]), blocks[0])
                    own = {keystr(p): t for p, t in tree_flatten_with_path(own_p)}
                    errs["params"] = max(mesh_close(f"{tag} params {keystr(p)} vs the optimizer "
                                                    "on the rank's gradients", t, own[keystr(p)],
                                                    rtol, atol)
                                         for p, t in tree_flatten_with_path(new_p))
                    del new_p, new_s, m, grads, own_p
                out[f"{arch_id}|{shape}"] = {
                    "launches": counts, "bytes": sent, "max_abs_err": errs, "wall_s": wall}
                del res, blocks, args, cell
                torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def recsys_cells(dev: torch.device) -> dict:
    """Phase 5g2: the seven recsys registry ids' cells under a real mesh of
    RECSYS_CELL_RANKS gloo ranks of the one card (the docstring at the top).
    Arch by arch, the params made on the card from a seed and one device's
    run of each cell (built with mesh=None) on them, its intermediates freed
    before the next arch; then one spawn of the ranks, which read the
    params, batches and one device's outputs through CUDA IPC.  Raises on
    any failure; returns the numbers and each path's summed launches."""
    from repro_torch.configs import recsys_common as RC
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import mesh as M
    from repro_torch.models import recsys as R
    from repro_torch.optim import optimizers as O

    t_phase = time.perf_counter()
    grads_of = O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))
    archs, summary = [], {"card": nvidia_smi(), "mesh": dict(zip(("data", "model"),
                                                              RECSYS_CELL_MESH)),
                          "max_ring_bytes_per_rank": RECSYS_CELL_MAX_BYTES, "archs": {}}

    def one_device(cfg, params2: dict) -> dict:
        """The params of the one-device layout: each table's rows without
        the shard count's padding."""
        out = dict(params2)
        for key, emb in (("emb", cfg.embedding(1)), ("wide", cfg.wide_embedding(1))):
            if key in params2:
                out[key] = {"table": params2[key]["table"][:emb.sharded.total_rows]}
        return out

    for i, arch_id in enumerate(RECSYS_CELL_IDS):
        t0 = time.perf_counter()
        cfg, tcfg, sizes = recsys_cell_configs(arch_id)
        ns = RECSYS_CELL_MESH[1]
        params = R.init_params(cfg, seed=i, num_shards=ns, device=dev)
        tparams = R.init_params(tcfg, seed=i, num_shards=ns, device=dev)
        if cfg.arch == "mind":  # N(0, 1) rows: scores and gradients far from rounding
            for p in (params, tparams):
                p["emb"]["table"].mul_(100.0)
        rng = np.random.default_rng(i)
        batches, want = {}, {}
        cands = None
        with recsys_cell_sizes(sizes):
            for shape, info in RC.RECSYS_SHAPES.items():
                kind = info["kind"]
                c = tcfg if kind == "train" else cfg
                n = sizes[shape]
                if kind == "retrieval" and c.arch == "two_tower":
                    host = syn.recsys_batch(rng, c.tables, RECSYS_CELL_QUERIES)
                    host = {k: host[k] for k in ("indices", "mask")}
                    cands = torch.randn((n, c.mlp[-1]), device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(i))
                elif kind == "retrieval" and c.arch == "mind":
                    host = syn.mind_batch(rng, c.tables[0].vocab, 1, c.hist_len)
                    host = {"hist": host["hist"], "hist_mask": host["hist_mask"],
                            "cand_ids": rng.permutation(c.tables[0].vocab)[:n].astype(np.int32)}
                else:
                    host = (syn.mind_batch(rng, c.tables[0].vocab, n, c.hist_len)
                            if c.arch == "mind" else
                            syn.recsys_batch(rng, c.tables, n, n_dense=c.n_dense))
                    keys, _ = RC.batch_abstract(c, n, ("data",), kind == "train")
                    host = {k: host[k] for k in keys}
                batch = batches[shape] = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
                p1 = one_device(c, tparams if kind == "train" else params)
                cell = RC._build(shape, None, False, cfg_fn=lambda c=c: c)
                if kind == "train":
                    grads, _, m = R.make_train_step(c, grads_of)(p1, (), batch)
                    new_p, new_s, _ = cell.step_fn(p1, RC.make_recsys_optimizer().init(p1),
                                                   batch)
                    want[shape] = {"loss": m["loss"], "grads": grads, "state": new_s}
                    del new_p
                else:
                    with torch.no_grad():
                        res = cell.step_fn(*((p1, batch, cands) if len(cell.args) == 3
                                             else (p1, batch)))
                    want[shape] = ({"scores": res} if kind == "serve"
                                   else {"values": res[0], "indices": res[1]})
        torch.cuda.synchronize()
        archs.append({"arch": arch_id, "cfg": cfg, "train_cfg": tcfg, "sizes": sizes,
                      "params": params, "train_params": tparams, "batches": batches,
                      "cands": cands, "want": want})
        rows = {"serve": max(t.vocab for t in cfg.tables),
                "train": max(t.vocab for t in tcfg.tables)}
        summary["archs"][arch_id] = {
            "table_rows_cap": rows, "sizes": sizes,
            "ring_bytes_per_rank": {
                shape: recsys_cell_ring_bytes(tcfg if info["kind"] == "train" else cfg,
                                              info["kind"], sizes[shape])
                for shape, info in RC.RECSYS_SHAPES.items()},
            "one_device_s": time.perf_counter() - t0}
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[recsys_cells] {arch_id}: tables capped at {rows} rows, sizes {sizes}, one "
            f"device's cells in {summary['archs'][arch_id]['one_device_s']:.2f}s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    t_spawn = time.perf_counter()
    res = M.spawn(recsys_cell_rank, RECSYS_CELL_RANKS, (archs,), timeout=RECSYS_CELL_TIMEOUT_S)
    summary["spawn_s"] = time.perf_counter() - t_spawn
    paths: dict = {}
    for a in archs:
        arch_id = a["arch"]
        for shape, info in RC.RECSYS_SHAPES.items():
            kind = info["kind"]
            c = a["train_cfg"] if kind == "train" else a["cfg"]
            key = f"{arch_id}|{shape}"
            need = recsys_cell_launches(c, kind)
            ring = recsys_cell_ring_bytes(c, kind, a["sizes"][shape])
            total: dict = {}
            for r, rr in enumerate(res):
                got = rr[key]
                wrong = {k: v for k, v in got["launches"].items() if v != need.get(k, 0)}
                if wrong:
                    raise AssertionError(f"[recsys_cells] rank {r} {key}: launches {wrong}, "
                                         f"expected {need} and 0 elsewhere")
                if got["bytes"] != ring:
                    raise AssertionError(f"[recsys_cells] rank {r} {key}: bytes {got['bytes']} "
                                         f"!= the ring model's {ring}")
                for k, v in got["launches"].items():
                    total[k] = total.get(k, 0) + v
            paths[f"recsys_cells.{c.arch}.{shape}"] = total
            summary["archs"][arch_id].setdefault("cells", {})[shape] = {
                "wall_s_per_rank": [rr[key]["wall_s"] for rr in res],
                "max_abs_err_per_rank": [rr[key]["max_abs_err"] for rr in res],
                "launches_per_rank": {k: v // RECSYS_CELL_RANKS for k, v in total.items() if v}}
    del archs, res
    gc.collect()
    torch.cuda.empty_cache()
    summary["phase_seconds"] = time.perf_counter() - t_phase
    log("[recsys_cells] " + json.dumps(summary))
    return {"paths": paths, "summary": summary}


def demos(dev: torch.device) -> dict:
    """Phase 5g3: the port's README demos (the docstring at the top), each
    run on the card with its launch counts read around it, then on the CPU
    from the card's initial params.  Raises on any failure; returns each
    demo's numbers and its path's launches."""
    sys.path.insert(0, str(ROOT / "examples"))  # spawned ranks inherit it
    import torch_elastic_reshard as ER
    import torch_hotcache_demo as HD
    import torch_prefetch_demo as PD
    import torch_quickstart as QS
    import torch_serve_dlrm as SD

    from repro_torch.utils import tree_map

    t_phase = time.perf_counter()
    card = nvidia_smi()
    paths, summary = {}, {"card": card, "walls_s": {}, "cpu_walls_s": {}}

    def run(path: str, fn, *args, **kwargs):
        """``fn`` on the card, its launches counted from 0 as ``path``."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        torch.cuda.synchronize()
        summary["walls_s"][path] = wall = time.perf_counter() - t0
        paths[path] = launch_counts()
        log(f"[demos] {path}: {wall:.3f} s wall on the card ({card})")
        return res

    def on_cpu(path: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        summary["cpu_walls_s"][path] = time.perf_counter() - t0
        return res

    def same(path: str, what: str, got, want) -> None:
        if got != want:
            raise AssertionError(f"[demos] {path}: {what} differ, card {got} against CPU {want}")

    def launched(path: str, want: dict, counts: dict | None = None) -> None:
        """Exactly ``want``'s launches on ``path`` (K1 all masked), none else."""
        counts = paths[path] if counts is None else counts
        want = {**dict.fromkeys(counts, 0), **want}
        want["embedding_bag_masked"] = want["embedding_bag"]
        wrong = {k: (v, want[k]) for k, v in counts.items()
                 if (v < 1 if want[k] == "some" else v != want[k])}
        if wrong:
            raise AssertionError(f"[demos] {path}: launches (got, want) {wrong}")

    def host(tree):
        return tree_map(lambda t: t.detach().cpu().numpy(), tree)

    # ---- quickstart, one device: 3 lookups, each one K1 masked
    q_card = run("demo_quickstart", QS.run, "cuda")
    launched("demo_quickstart", {"embedding_bag": 3})
    q_cpu = on_cpu("demo_quickstart", QS.run, "cpu", params=host(QS.init_params("cuda")))
    # ---- quickstart on DEMO_RANKS gloo ranks: hierarchical and cached, K1 on every rank
    qr_card = run("demo_quickstart_ranks", QS.run, "cuda", ranks=DEMO_RANKS)
    for r, counts in enumerate(qr_card["rank_launches"]):
        launched(f"demo_quickstart_ranks rank {r}", {"embedding_bag": 2},
                 {**paths["demo_quickstart_ranks"], **counts})
    paths["demo_quickstart_ranks"] = {k: v + sum(c.get(k, 0) for c in qr_card["rank_launches"])
                                      for k, v in paths["demo_quickstart_ranks"].items()}
    qr_cpu = on_cpu("demo_quickstart_ranks", QS.run, "cpu", ranks=DEMO_RANKS,
                    params=host(QS.init_params("cuda", DEMO_RANKS // 2)))
    errs = {}
    for path, got, want in (("demo_quickstart", q_card, q_cpu),
                            ("demo_quickstart_ranks", qr_card, qr_cpu)):
        for key in ("routing_table", "rdma", "pool_bit_equal", "pipelined_bit_equal"):
            same(path, key, got[key], want[key])
        if not (got["pool_bit_equal"] and got["pipelined_bit_equal"]):
            raise AssertionError(f"[demos] {path}: the rdma pool's outputs are not bit-equal")
        for mode, x in got["pooled"].items():
            errs[f"{path}.{mode}"] = assert_close(
                f"{path} {mode} lookup {tuple(x.shape)}, card (K1) vs CPU (plain)", x,
                want["pooled"][mode], *DEMO_K1_TOL)

    # ---- hotcache: a host tier and a plain oracle, no kernel
    h_card = run("demo_hotcache", HD.run, "cuda")
    launched("demo_hotcache", {})
    h_cpu = on_cpu("demo_hotcache", HD.run, "cpu", params=host(HD.init_params("cuda")))
    for key in h_card:
        if key != "oracle_max_err":
            same("demo_hotcache", key, h_card[key], h_cpu[key])

    # ---- prefetch: the miner's neighbor select is K5, bit-equal to its plain version
    p_card = run("demo_prefetch", PD.run, "cuda")
    launched("demo_prefetch", {"topk_neighbor_select": "some"})
    p_cpu = on_cpu("demo_prefetch", PD.run, "cpu", params=host(PD.init_params("cuda")))
    for key in p_card:
        if key != "oracle_max_err":
            same("demo_prefetch", key, p_card[key], p_cpu[key])

    # ---- elastic: K1, K1', K2, K2' once a train step; K1 and K2 once a scoring forward
    e_card = run("demo_elastic", ER.run, "cuda")
    launched("demo_elastic", {"embedding_bag": ER.STEPS + 2, "dot_interaction": ER.STEPS + 2,
                              "embedding_bag_backward": ER.STEPS,
                              "dot_interaction_backward": ER.STEPS})
    e_cpu = on_cpu("demo_elastic", ER.run, "cpu", params=host(ER.init_params("cuda")))
    same("demo_elastic", "rows", e_card["rows"], e_cpu["rows"])
    errs["demo_elastic.loss"] = assert_close(
        "demo_elastic loss after 10 steps, card vs CPU", torch.tensor(e_card["loss"]),
        torch.tensor(e_cpu["loss"]), *DEMO_SCORE_TOL)
    errs["demo_elastic.scores"] = assert_close(
        f"demo_elastic scores {tuple(e_card['scores'].shape)} after the reshard, card vs CPU",
        e_card["scores"], e_cpu["scores"], *DEMO_SCORE_TOL)

    # ---- serve_dlrm: the dense stage's K2 once a batch; its trace through the tool
    with tempfile.TemporaryDirectory() as d:
        trace, metrics = os.path.join(d, "trace.json"), os.path.join(d, "metrics.json")
        s_card = run("demo_serve", SD.main, [*DEMO_SERVE_ARGS, "--trace", trace,
                                             "--metrics-out", metrics])
        tool = subprocess.run([sys.executable, str(ROOT / "tools" / "trace_export.py"), trace,
                               "--attribution"], capture_output=True, text=True, timeout=120)
        if tool.returncode or "(coverage 100.00%)" not in tool.stdout:
            raise AssertionError(f"[demos] demo_serve: trace_export --attribution rc "
                                 f"{tool.returncode}: {tool.stdout[-2000:]} {tool.stderr[-2000:]}")
        coverage = tool.stdout.strip().splitlines()[-1]
        if not os.path.exists(metrics):
            raise AssertionError("[demos] demo_serve wrote no metrics snapshot")
    launched("demo_serve", {"dot_interaction": "some"})
    if paths["demo_serve"]["dot_interaction"] < s_card["batches"]:
        raise AssertionError(f"[demos] demo_serve: K2 launched "
                             f"{paths['demo_serve']['dot_interaction']} times for "
                             f"{s_card['batches']} batches")
    s_cpu = on_cpu("demo_serve", SD.main, [*DEMO_SERVE_ARGS, "--device", "cpu"])
    if s_card["requests"] != 2000 or s_card["nonfinite_scores"]:
        raise AssertionError(f"[demos] demo_serve: {s_card['requests']} requests served, "
                             f"{s_card['nonfinite_scores']} non-finite scores")
    for key in DEMO_SERVE_COUNTERS:
        same("demo_serve", key, s_card[key], s_cpu[key])
    for key in DEMO_ENGINE_COUNTERS:
        same("demo_serve", f"rdma_engine.{key}", s_card["rdma_engine"][key],
             s_cpu["rdma_engine"][key])

    summary.update({
        "quickstart": {"abs_mean": {m: q_card[m]["abs_mean"] for m in QS.MODES},
                       "cached_max_err": q_card["cached_max_err"], "rdma": q_card["rdma"]},
        "quickstart_ranks": {"mesh": qr_card["mesh"], "rank_launches": qr_card["rank_launches"],
                             "cached_max_err": qr_card["cached_max_err"]},
        "hotcache": {k: v for k, v in h_card.items() if k != "steps"},
        "prefetch": p_card,
        "elastic": {k: v for k, v in e_card.items() if k != "scores"},
        "serve": {**{k: s_card[k] for k in DEMO_SERVE_COUNTERS},
                  "throughput_rps": s_card["throughput_rps"],
                  "p99_latency_ms": s_card["p99_latency_ms"],
                  "trace_attribution": coverage},
        "card_vs_cpu_max_abs_err": errs,
        "launches": {p: {k: v for k, v in c.items() if v} for p, c in paths.items()},
    })
    summary["phase_seconds"] = time.perf_counter() - t_phase
    log("[demos] " + json.dumps(summary, default=str))
    return {"paths": paths, "summary": summary}


# GNN (phases 5h and 5i): graphsage-reddit from the registry at each
# published shape on one device, f32, TF32 off, and its mesh paths on
# GNN_SHARDED_RANKS gloo ranks of the one card.  The GNN reaches no hand
# kernel (its aggregation is index_select and index_add_, as the
# reference's is XLA's take and segment_sum): every path's launch counts
# must stay 0.
# Adam steps card vs CPU (full_graph_sm, minibatch_lg, molecule), each from
# the CPU's params and state of the step before.  Run free, the two
# trajectories part: an element whose gradient rounding decides moves +-lr
# on either side, which moves every later gradient (full_graph_sm's
# w_neigh stood 0.4 lr apart after 3 free steps on an H100 80GB HBM3 at
# 700 W, past TRAIN_GRAD_TOL plus step 1's freedom).  From one state, a
# gradient d apart moves the update by at most about 2 lr d / |g| at steps
# 1-3 (|m^|/sqrt(v^) <= 1.2; sqrt(v^) >= sqrt((1 - b2) / (1 - b2^t)) |g|),
# hold_adam's freedom with that step's own gradient g.
GNN_STEPS = 3
GNN_LR = 1e-3  # the cells' Adam (lr 1e-3, eps 1e-8)
GNN_REDDIT_EDGES = 114_615_892  # DGL's RedditDataset; the config's 114.6M
# ogb_products' logits of GNN_TWO_HOP_SEEDS nodes (distinct, each with an
# in-edge) against float64 on the CPU over their two-hop in-neighbourhoods:
# f32 sums of up to 8.5M terms (the power-law hub) against exact ones; the
# f32 CPU forward of 5i's graph stood within 1.2e-6 of float64 at logits of
# up to 0.23, the hub's own the worst
GNN_TWO_HOP_SEEDS = 256
GNN_F64_TOL = (1e-5, 1e-5)
GNN_F64_CHUNK = 1 << 21  # edges a CPU float64 gather at a time
# 5i: ogb_products' widths on a tenth of its graph (nodes relabelled by a
# random permutation so that the partitioned layout's owners share the
# edges), padded to the ranks (nodes) and to 512 (edges) as the cell pads
GNN_SHARDED_NODES, GNN_SHARDED_EDGES = 244_903, 6_185_914
GNN_SHARDED_RANKS, GNN_SHARDED_MESH = 4, (2, 2)
GNN_SHARDED_TOL = (1e-5, 1e-5)  # logits of up to ~0.2 against one device
GNN_PART_TOL = (1e-4, 1e-4)  # the reference's own for the partitioned forward
GNN_SHARDED_TIMEOUT_S = 300


def gnn_plain_partitioned(params: dict, feats, edges, mask, comm_dtype) -> torch.Tensor:
    """The partitioned forward's arithmetic on one device, written apart
    from ``models.gnn``: every layer's node states rounded to ``comm_dtype``
    (the all-gather's payload) before the gather, then the plain mean
    aggregation and the layer, in f32."""
    from repro_torch.models import gnn as G

    src, dst = edges[:, 0].long(), edges[:, 1].long()
    w = mask.to(torch.float32)
    n = feats.shape[0]
    counts = torch.zeros(n, device=feats.device).index_add_(0, dst, w).clamp_min(1.0)
    h = feats
    for lp in params["layers"]:
        hb = h.to(comm_dtype).to(torch.float32)
        sums = torch.zeros((n, h.shape[1]), device=h.device).index_add_(0, dst, hb[src] * w[:, None])
        h = G.sage_layer(lp, h, sums / counts[:, None])
    return h @ params["out"]


def gnn_two_hop_f64(params: dict, feats, src, dst, mask, seeds) -> tuple:
    """The logits of ``seeds`` (sorted, distinct) in float64 on the CPU from
    their two-hop in-neighbourhoods alone: the edges into the seeds, the
    edges into the seeds and their sources, and those sources' features
    (selected on the card, gathered on the CPU in chunks); and the sizes
    of that neighbourhood."""
    from repro_torch.models import gnn as G

    def sel(targets):
        m = torch.isin(dst, targets.to(dst.dtype)) & mask
        return src[m].long(), dst[m].long()

    s1, d1 = sel(seeds)
    U = torch.unique(torch.cat([seeds, s1]))
    s2, d2 = sel(U)
    need = torch.unique(torch.cat([U, s2]))
    cpu = lambda t: t.cpu()  # noqa: E731
    U, seeds, need = cpu(U), cpu(seeds), cpu(need)
    s1, d1, s2, d2 = map(cpu, (s1, d1, s2, d2))
    h0 = feats[need.to(feats.device)].cpu().double()
    p = {"layers": [{k: v.cpu().double() for k, v in lp.items()} for lp in params["layers"]],
         "out": params["out"].cpu().double()}
    pos = torch.searchsorted

    def mean(h_src, src_pos, dst_pos, n_out):
        sums = torch.zeros((n_out, h_src.shape[1]), dtype=torch.float64)
        for i in range(0, src_pos.numel(), GNN_F64_CHUNK):
            sl = slice(i, i + GNN_F64_CHUNK)
            sums.index_add_(0, dst_pos[sl], h_src[src_pos[sl]])
        cnt = torch.bincount(dst_pos, minlength=n_out).double().clamp_min(1.0)
        return sums / cnt[:, None]

    h1 = G.sage_layer(p["layers"][0], h0[pos(need, U)],
                      mean(h0, pos(need, s2), pos(U, d2), U.numel()))
    h2 = G.sage_layer(p["layers"][1], h1[pos(U, seeds)],
                      mean(h1, pos(U, s1), pos(seeds, d1), seeds.numel()))
    return h2 @ p["out"], {"hop1_edges": int(s1.numel()), "hop2_edges": int(s2.numel()),
                           "nodes": int(need.numel())}


def gnn(dev: torch.device) -> dict:
    """Phase 5h: graphsage-reddit from the registry at its four published
    shapes on the card (the docstring at the top).  Raises on any failure;
    returns the numbers, each path's launch counts and 5i's minibatch
    blocks (sampled here from the Reddit-sized graph, in host shared
    memory)."""
    from repro_torch import configs
    from repro_torch.configs import graphsage_reddit as GR
    from repro_torch.data import graph_sampler as GS
    from repro_torch.data import synthetic as syn
    from repro_torch.models import gnn as G
    from repro_torch.optim import optimizers as O
    from repro_torch.utils import keystr, tree_flatten_with_path, tree_to

    t_phase = time.perf_counter()
    arch = configs.get("graphsage-reddit")
    grads_of = O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))
    out: dict = {"card": nvidia_smi(), "shapes": {}, "paths": {}}

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    def no_kernels(path: str) -> None:
        counts = out["paths"][path] = launch_counts()
        if any(counts.values()):
            raise AssertionError(f"{path} launched a hand kernel: {counts}")

    def card_vs_cpu(shape: str, cell, grad_step, params: dict, batch: dict) -> dict:
        """GNN_STEPS steps of the cell on the card and on the CPU, each from
        the CPU's params and Adam state of the step before (so rounding
        cannot compound along the trajectory): the card's step-1 loss and
        gradients, then each step's loss, params (with Adam's freedom where
        that step's gradient lies near 0) and moments against the CPU's."""
        hparams, hbatch = tree_to(params, "cpu"), {k: v.cpu() for k, v in batch.items()}
        grads, _, m1 = grad_step(params, (), batch)
        hgrads, _, hm1 = grad_step(hparams, (), hbatch)
        row = {"step1_loss_err": assert_close(f"[gnn] {shape} step-1 loss, card vs CPU",
                                              m1["loss"].cpu(), hm1["loss"], *TRAIN_GRAD_TOL),
               "step1_grads_max_abs_err": assert_trees_close(
                   f"[gnn] {shape} step-1 gradients, card vs CPU", grads, hgrads,
                   *TRAIN_GRAD_TOL, scaled=True)}
        del grads
        opt = O.make_adam(GNN_LR)
        hp, hs = hparams, opt.init(hparams)
        losses, hlosses, walls, worst, freed = [], [], [], 0.0, 0
        torch.cuda.reset_peak_memory_stats()
        for k in range(GNN_STEPS):
            if k:
                hgrads = grad_step(hp, (), hbatch)[0]
            p, s = tree_to(hp, dev), tree_to(hs, dev)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, s, m = cell.step_fn(p, s, batch)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            no_kernels(f"gnn.{shape}")
            hp, hs, hm = cell.step_fn(hp, hs, hbatch)
            losses.append(float(m["loss"]))
            hlosses.append(float(hm["loss"]))
            assert_close(f"[gnn] {shape} step {k + 1} loss, card vs CPU", m["loss"].cpu(),
                         hm["loss"], *TRAIN_GRAD_TOL)
            flat_g = {keystr(q): v for q, v in tree_flatten_with_path(hgrads)}
            for (path, got), (_, want) in zip(tree_flatten_with_path(p),
                                              tree_flatten_with_path(hp)):
                err, n = hold_adam(f"[gnn] {shape} {keystr(path)} after step {k + 1}",
                                   got.cpu(), want, flat_g[keystr(path)], 1, lr=GNN_LR)
                worst, freed = max(worst, err), freed + n
            assert_trees_close(f"[gnn] {shape} Adam moments after step {k + 1}, card vs CPU",
                               {"m": s["m"], "v": s["v"]}, {"m": hs["m"], "v": hs["v"]},
                               *TRAIN_GRAD_TOL, scaled=True)
        row.update({"losses": losses, "cpu_losses": hlosses, "step_wall_ms": walls,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "params_max_abs_err": worst, "params_past_train_grad_tol": freed})
        log(f"[gnn] {shape}: {GNN_STEPS} steps card vs CPU ok: losses {losses}, step walls "
            f"{[round(w, 3) for w in walls]} ms, params max abs err {worst:.3e} "
            f"({freed} elements on Adam's freedom)")
        return row

    # ---- full_graph_sm: Cora's size, a random graph of random_graph's law
    shape = "full_graph_sm"
    info, cfg = GR.SHAPES[shape], GR._cfg(GR.SHAPES[shape])
    cell = arch.build_cell(shape, None, False)
    E_pad = cell.args[2]["edges"].shape[0]
    rng = np.random.default_rng(0)
    g = syn.random_graph(rng, info["n_nodes"], info["n_edges"], cfg.d_in, cfg.n_classes)
    pad = E_pad - info["n_edges"]
    batch = {"feats": g["feats"], "labels": g["labels"],
             "edges": np.concatenate([g["edges"], np.zeros((pad, 2), np.int32)]),
             "edge_mask": np.concatenate([g["edge_mask"], np.zeros(pad, bool)])}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    params = G.init_params(cfg, seed=0, device=dev)
    out["shapes"][shape] = dict(card_vs_cpu(shape, cell, G.make_train_step_full(cfg, grads_of),
                                            params, batch),
                                nodes=info["n_nodes"], edges=info["n_edges"], edges_padded=E_pad)
    del params, batch, g
    free()

    # ---- minibatch_lg: Reddit's size on the host, one block of 1,024 targets
    shape = "minibatch_lg"
    info, cfg = GR.SHAPES[shape], GR._cfg(GR.SHAPES[shape])
    cell = arch.build_cell(shape, None, False)
    N = info["n_nodes"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    g = syn.random_graph(rng, N, GNN_REDDIT_EDGES, cfg.d_in, cfg.n_classes)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = GS.edges_to_csr(g["edges"], N, g["feats"], g["labels"])
    t_csr = time.perf_counter() - t0
    del g
    t0 = time.perf_counter()
    blk = GS.sample_block(csr, rng, rng.choice(N, info["batch_nodes"], replace=False),
                          info["fanout"])
    t_sample = time.perf_counter() - t0
    sizes = GS.block_sizes(info["batch_nodes"], info["fanout"], cfg.d_in)
    if blk.feats.shape[0] != sizes["n_sub"] or [len(e) for e in blk.hop_edges] != \
            sizes["hop_edges"]:
        raise AssertionError(f"[gnn] {shape}: block {blk.feats.shape}, {sizes}")
    log(f"[gnn] {shape}: {N:,} nodes, {GNN_REDDIT_EDGES:,} edges made on the host in "
        f"{t_gen:.2f}s, edges_to_csr {t_csr:.2f}s; one block of {blk.n_targets} targets at "
        f"fanout {info['fanout']} sampled in {t_sample:.3f}s: {sizes['n_sub']:,} nodes, hop "
        f"edges {sizes['hop_edges']}, features {blk.feats.nbytes / 1e6:.0f} MB")
    # 5i's four blocks, one a rank: the cell at (2, 2) splits batch_nodes four ways
    tgt4 = info["batch_nodes"] // GNN_SHARDED_RANKS
    blks = [GS.sample_block(csr, rng, rng.choice(N, tgt4, replace=False), info["fanout"])
            for _ in range(GNN_SHARDED_RANKS)]
    sharded_blocks = host_shared({
        "feats": torch.from_numpy(np.stack([b.feats for b in blks])),
        "edges1": torch.from_numpy(np.stack([b.hop_edges[0] for b in blks])),
        "mask1": torch.from_numpy(np.stack([b.hop_masks[0] for b in blks])),
        "edges2": torch.from_numpy(np.stack([b.hop_edges[1] for b in blks])),
        "mask2": torch.from_numpy(np.stack([b.hop_masks[1] for b in blks])),
        "labels": torch.from_numpy(np.stack([b.labels for b in blks]))})
    del csr, blks
    batch = {"feats": blk.feats, "edges1": blk.hop_edges[0], "mask1": blk.hop_masks[0],
             "edges2": blk.hop_edges[1], "mask2": blk.hop_masks[1], "labels": blk.labels}
    batch = {k: torch.from_numpy(v)[None].to(dev) for k, v in batch.items()}
    params = G.init_params(cfg, seed=0, device=dev)
    out["shapes"][shape] = dict(
        card_vs_cpu(shape, cell, G.make_train_step(GR.minibatch_loss(cfg, blk.n_targets),
                                                   grads_of), params, batch),
        nodes=N, edges=GNN_REDDIT_EDGES, graph_seconds=t_gen, csr_seconds=t_csr,
        sample_seconds=t_sample, block_nodes=sizes["n_sub"], hop_edges=sizes["hop_edges"],
        block_feature_mb=blk.feats.nbytes / 1e6)
    del params, batch, blk
    free()

    # ---- ogb_products: the graph made on the card, one forward, GNN_STEPS steps
    shape = "ogb_products"
    info, cfg = GR.SHAPES[shape], GR._cfg(GR.SHAPES[shape])
    cell = arch.build_cell(shape, None, False)
    N, E = info["n_nodes"], info["n_edges"]
    E_pad = cell.args[2]["edges"].shape[0]
    log(f"[gnn] {shape}: reckoned before the run: features {N * cfg.d_in * 4 / 1e9:.2f} GB, "
        f"edges {E_pad * 8 / 1e9:.2f} GB, one [E, {cfg.d_in}] f32 message buffer "
        f"{E_pad * cfg.d_in * 4 / 1e9:.1f} GB, one [E, {cfg.d_hidden}] "
        f"{E_pad * cfg.d_hidden * 4 / 1e9:.1f} GB; models.gnn holds one buffer of "
        f"{G.EDGE_CHUNK:,} edges at a time, {G.EDGE_CHUNK * cfg.d_hidden * 4 / 1e9:.2f} GB "
        f"at d {cfg.d_hidden}")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    # random_graph's law on the card: power-law destinations (zipf_indices'
    # inverse CDF at alpha 1.2), uniform sources
    u = torch.rand(E, generator=gen, dtype=torch.float64, device=dev)
    a1 = 1.0 - 1.2
    dst = ((u * (N ** a1 - 1.0) + 1.0) ** (1.0 / a1) - 1.0).to(torch.int64).clamp_(0, N - 1)
    del u
    edges = torch.zeros((E_pad, 2), dtype=torch.int32, device=dev)
    edges[:E, 1] = dst.to(torch.int32)
    del dst
    edges[:E, 0] = torch.randint(0, N, (E,), generator=gen, device=dev, dtype=torch.int32)
    mask = torch.arange(E_pad, device=dev) < E
    feats = torch.randn((N, cfg.d_in), generator=gen, device=dev)
    labels = torch.randint(0, cfg.n_classes, (N,), generator=gen, device=dev, dtype=torch.int32)
    batch = {"feats": feats, "edges": edges, "edge_mask": mask, "labels": labels}
    params = G.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = G.forward_full_graph(cfg, params, feats, edges, mask)
        torch.cuda.synchronize()
        fwd_first_ms = 1e3 * (time.perf_counter() - t0)
    no_kernels(f"gnn.{shape}.forward")
    if tuple(logits.shape) != (N, cfg.n_classes) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[gnn] {shape}: logits {tuple(logits.shape)} not finite")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: G.forward_full_graph(cfg, params, feats, edges, mask), flush,
                         reps=3, warmup=0)
    deg = torch.bincount(edges[:E, 1].long(), minlength=N)
    pick = torch.nonzero(deg > 0)[:, 0]
    seeds = torch.sort(pick[torch.randperm(pick.numel(), generator=gen, device=dev)[
        :GNN_TWO_HOP_SEEDS]]).values
    t0 = time.perf_counter()
    want, hood = gnn_two_hop_f64(params, feats, edges[:, 0], edges[:, 1], mask, seeds)
    t_f64 = time.perf_counter() - t0
    two_hop_err = assert_close(
        f"[gnn] {shape} logits of {GNN_TWO_HOP_SEEDS} nodes (in-degrees "
        f"{int(deg[seeds].min())}-{int(deg[seeds].max())}) against float64 on the CPU over "
        f"their two-hop in-neighbourhoods ({hood})", logits[seeds].double().cpu(), want,
        *GNN_F64_TOL)
    del logits, want
    opt = O.make_adam(GNN_LR)
    state = opt.init(params)
    free()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, evs = [], [], []
    reset_counts()
    p, s = params, state
    for _ in range(GNN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        p, s, m = cell.step_fn(p, s, batch)
        end.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        evs.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    no_kernels(f"gnn.{shape}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[gnn] {shape}: losses {losses}")
    # the step by kernel: index_select's gathers, index_add_'s atomics, the
    # products, the elementwise passes (the weighting mul_ the most), the rest
    prof = device_busy(lambda: cell.step_fn(p, s, batch), 1,
                       kernels=("vectorized_gather", "indexFuncLargeIndex", "gemm",
                                "elementwise", "reduce"))
    _, grads = G.loss_and_grads(lambda q, b: G.node_ce_loss(G.forward_full_graph(
        cfg, q, b["feats"], b["edges"], b["edge_mask"]), b["labels"]), p, batch)
    adam = device_busy(lambda: opt.update(grads, s, p), 1)
    out["shapes"][shape] = {
        "nodes": N, "edges": E, "edges_padded": E_pad, "graph_on_card_s": t_graph,
        "forward_first_ms": fwd_first_ms, "forward_device_ms": fwd_ms,
        "two_hop_max_abs_err": two_hop_err, "two_hop": hood, "two_hop_f64_s": t_f64,
        "losses": losses, "step_wall_ms": walls, "step_device_ms": evs,
        "step_device_busy_ms": prof["device_busy_ms"],
        "step_device_ops": prof["device_ops_per_call"],
        "step_kernels_ms": prof["kernels_ms_per_call"],
        "step_top_kernels_ms": prof["top_kernels_ms_per_call"],
        "adam_update_busy_ms": adam["device_busy_ms"], "peak_gb": peak_gb}
    log(f"[gnn] {shape}: forward {fwd_ms:.3f} ms on the card; {GNN_STEPS} steps, losses "
        f"{losses}, device {[round(x, 3) for x in evs]} ms, busy {prof['device_busy_ms']} ms, "
        f"peak {peak_gb:.2f} GB; kernels {json.dumps(prof['kernels_ms_per_call'])}, top "
        + json.dumps(prof["top_kernels_ms_per_call"]))
    del p, s, params, state, batch, feats, edges, mask, labels, grads, deg, pick, seeds, flush
    free()

    # ---- molecule: 128 graphs of 30 nodes and 64 edges
    shape = "molecule"
    info, cfg = GR.SHAPES[shape], GR._cfg(GR.SHAPES[shape])
    cell = arch.build_cell(shape, None, False)
    rng = np.random.default_rng(2)
    Gb, n, e = info["batch"], info["n_nodes"], info["n_edges"]
    batch = {"feats": rng.standard_normal((Gb, n, cfg.d_in)).astype(np.float32),
             "edges": rng.integers(0, n, (Gb, e, 2)).astype(np.int32),
             "edge_mask": rng.random((Gb, e)) < 0.9,
             "labels": rng.standard_normal(Gb).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    params = G.init_params(cfg, seed=0, device=dev)
    out["shapes"][shape] = dict(card_vs_cpu(shape, cell, G.make_train_step(
        GR.molecule_loss(cfg), grads_of), params, batch), graphs=Gb, nodes=n, edges=e)
    del params, batch
    free()

    reset_counts()
    out["smoke"] = arch.smoke(dev.type)
    no_kernels("gnn.registry")
    out["phase_seconds"] = time.perf_counter() - t_phase
    out["sharded_blocks"] = sharded_blocks
    return out


def gnn_sharded_rank(rank: int, world: int, inputs: dict, want: dict) -> dict:
    """One rank of phase 5i (spawned by ``launch.mesh.spawn`` over gloo; the
    graph, params, blocks and one-device results are host tensors in shared
    memory): mesh (data 2, model 2), each path on this rank's blocks, held
    against one device's on the card; raises on failure.  Returns the
    errors, bytes, launch counts and walls."""
    from repro_torch.configs import graphsage_reddit as GR
    from repro_torch.core.sharding import PartitionSpec as P
    from repro_torch.launch import mesh as M
    from repro_torch.models import gnn as G
    from repro_torch.optim import optimizers as O
    from repro_torch.utils import keystr, tree_flatten_with_path, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dev = torch.device(DEVICE)
    mesh = M.make_debug_mesh(*GNN_SHARDED_MESH)
    axes = mesh.axis_names
    cfg = inputs["cfg"]
    card = lambda tree: tree_map(lambda t: t.to(dev), tree)  # noqa: E731
    params, w = card(inputs["params"]), card(want)
    feats, labels = inputs["feats"].to(dev), inputs["labels"].to(dev)
    batch = {"feats": feats, "labels": labels, "label_mask": inputs["label_mask"].to(dev),
             "edges": on_card_block(inputs["edges"], P(axes, None), mesh, dev),
             "edge_mask": on_card_block(inputs["edge_mask"], P(axes), mesh, dev)}
    grads_of = O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))
    out: dict = {"coords": dict(mesh.coords), "max_abs_err": {}, "bytes": {}, "wall_s": {}}
    tag = f"[gnn_sharded] rank {rank}"

    def run(name: str, fn):
        before = M.comm_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["wall_s"][name] = time.perf_counter() - t0
        out["bytes"][name] = bytes_since(before)
        return res

    def hold_params(name: str, got: dict, want_p: dict, grads: dict) -> None:
        flat_g = {keystr(k): v for k, v in tree_flatten_with_path(grads)}
        worst = 0.0
        for (path, g), (_, wv) in zip(tree_flatten_with_path(got), tree_flatten_with_path(want_p)):
            worst = max(worst, hold_adam(f"{tag} {name} {keystr(path)}", g, wv,
                                         flat_g[keystr(path)], 1, lr=GNN_LR)[0])
        out["max_abs_err"][name] = worst

    reset_counts()
    with torch.no_grad():
        logits = run("edge_sharded_forward", lambda: G.forward_full_graph(
            cfg, params, feats, batch["edges"], batch["edge_mask"], mesh))
    out["max_abs_err"]["edge_sharded_forward"] = assert_close(
        f"{tag} edge-sharded forward vs one device", logits, w["forward"], *GNN_SHARDED_TOL)
    grads, _, met = run("edge_sharded_train_grads",
                        lambda: G.make_train_step_full(cfg, grads_of, mesh)(params, (), batch))
    assert_close(f"{tag} edge-sharded loss vs one device", met["loss"], w["loss"],
                 *TRAIN_GRAD_TOL)
    out["max_abs_err"]["edge_sharded_grads"] = assert_trees_close(
        f"{tag} edge-sharded step gradients vs one device", grads, w["grads"], *TRAIN_GRAD_TOL,
        scaled=True)
    adam = O.make_adam(GNN_LR)
    new_p, _, _ = run("edge_sharded_adam_step", lambda: G.make_train_step_full(cfg, adam, mesh)(
        params, adam.init(params), batch))
    hold_params("edge_sharded_adam_step", new_p, w["adam"], w["grads"])
    del grads, new_p
    part = {"feats": on_card_block(inputs["feats"], P(axes, None), mesh, dev),
            "edges": on_card_block(inputs["part_edges"], P(axes, None), mesh, dev),
            "edge_mask": on_card_block(inputs["part_edge_mask"], P(axes), mesh, dev)}
    rows = M.block_slices(tuple(w["forward"].shape), P(axes, None), mesh)
    for comm, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with torch.no_grad():
            blk = run(f"partitioned_{comm}", lambda dt=dt: G.forward_full_graph_partitioned(
                cfg, params, part["feats"], part["edges"], part["edge_mask"], mesh,
                comm_dtype=dt))
        out["max_abs_err"][f"partitioned_{comm}"] = assert_close(
            f"{tag} partitioned forward, {comm} comm, vs one device's plain version of its "
            "arithmetic", blk, w[f"partitioned_{comm}"][rows], *GNN_PART_TOL)
        out["max_abs_err"][f"partitioned_{comm}_vs_f32_forward"] = max_err(blk, w["forward"][rows])
    mb = inputs["minibatch"]
    cell = GR.build_cell("minibatch_lg", mesh, False)
    mcfg = GR._cfg(GR.SHAPES["minibatch_lg"])
    mparams = card(mb["params"])
    mbatch = {k: on_card_block(v, cell.in_shardings[2][k], mesh, dev)
              for k, v in mb["batch"].items()}
    loss, grads = run("minibatch_grads", lambda: G.loss_and_grads(
        GR.minibatch_loss(mcfg, mbatch["labels"].shape[1], mesh, axes), mparams, mbatch, mesh,
        axes))
    assert_close(f"{tag} minibatch cell loss vs one device", loss, w["mb_loss"], *TRAIN_GRAD_TOL)
    out["max_abs_err"]["minibatch_grads"] = assert_trees_close(
        f"{tag} minibatch cell gradients vs one device", grads, w["mb_grads"], *TRAIN_GRAD_TOL,
        scaled=True)
    new_p, _, _ = run("minibatch_step", lambda: cell.step_fn(mparams, adam.init(mparams), mbatch))
    hold_params("minibatch_step", new_p, w["mb_adam"], w["mb_grads"])
    out["launches"] = launch_counts()
    return out


def gnn_sharded(dev: torch.device, blocks: dict) -> dict:
    """Phase 5i: the GNN's mesh paths on GNN_SHARDED_RANKS gloo ranks of the
    one card at ogb_products' widths on a tenth of its graph, and the
    minibatch_lg cell's step on 5h's four blocks (the docstring at the
    top).  One device's results come first, on the card; each rank holds
    its own against them and its bytes against the ring model."""
    from repro_torch.configs import graphsage_reddit as GR
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import mesh as M
    from repro_torch.models import gnn as G
    from repro_torch.optim import optimizers as O
    from repro_torch.utils import round_up, tree_flatten_with_path

    t_phase = time.perf_counter()
    cfg = GR._cfg(GR.SHAPES["ogb_products"])
    n_real, e_real = GNN_SHARDED_NODES, GNN_SHARDED_EDGES
    N, E = round_up(n_real, GNN_SHARDED_RANKS), round_up(e_real, 512)
    rng = np.random.default_rng(3)
    g = syn.random_graph(rng, n_real, e_real, cfg.d_in, cfg.n_classes)
    perm = rng.permutation(n_real).astype(np.int32)
    edges = np.zeros((E, 2), np.int32)
    edges[:e_real] = perm[g["edges"]]
    emask = np.arange(E) < e_real
    feats = np.zeros((N, cfg.d_in), np.float32)
    feats[:n_real] = g["feats"]
    labels = np.zeros(N, np.int32)
    labels[:n_real] = g["labels"]
    # the partitioned layout: each rank's block holds the edges whose
    # destination it owns, padded with masked edges to its own first node
    n_loc = N // GNN_SHARDED_RANKS
    live = edges[:e_real]
    owner = live[:, 1] // n_loc
    cap = int(np.bincount(owner, minlength=GNN_SHARDED_RANKS).max())
    pe = np.zeros((GNN_SHARDED_RANKS * cap, 2), np.int32)
    pm = np.zeros(GNN_SHARDED_RANKS * cap, bool)
    for r in range(GNN_SHARDED_RANKS):
        own = live[owner == r]
        pe[r * cap:r * cap + len(own)] = own
        pe[r * cap + len(own):(r + 1) * cap, 1] = r * n_loc
        pm[r * cap:r * cap + len(own)] = True
    inputs = host_shared({"feats": torch.from_numpy(feats), "labels": torch.from_numpy(labels),
                          "label_mask": torch.arange(N) < n_real,
                          "edges": torch.from_numpy(edges), "edge_mask": torch.from_numpy(emask),
                          "part_edges": torch.from_numpy(pe),
                          "part_edge_mask": torch.from_numpy(pm)})
    del g, perm, live, owner
    params = G.init_params(cfg, seed=1, device=dev)
    batch = {k: inputs[k].to(dev) for k in ("feats", "labels", "label_mask", "edges",
                                             "edge_mask")}
    grads_of = O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))
    adam = O.make_adam(GNN_LR)
    t0 = time.perf_counter()
    with torch.no_grad():
        fwd = G.forward_full_graph(cfg, params, batch["feats"], batch["edges"],
                                   batch["edge_mask"])
        plain = {f"partitioned_{c}": gnn_plain_partitioned(params, batch["feats"],
                                                           batch["edges"], batch["edge_mask"], dt)
                 for c, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    grads, _, met = G.make_train_step_full(cfg, grads_of)(params, (), batch)
    new_p, _, _ = G.make_train_step_full(cfg, adam)(params, adam.init(params), batch)
    mcfg = GR._cfg(GR.SHAPES["minibatch_lg"])
    mparams = G.init_params(mcfg, seed=2, device=dev)
    mbatch = {k: v.to(dev) for k, v in blocks.items()}
    tgt = mbatch["labels"].shape[1]
    mb_loss, mb_grads = G.loss_and_grads(GR.minibatch_loss(mcfg, tgt), mparams, mbatch)
    mb_adam, _, _ = G.make_train_step(GR.minibatch_loss(mcfg, tgt), adam)(
        mparams, adam.init(mparams), mbatch)
    torch.cuda.synchronize()
    one_device_s = time.perf_counter() - t0
    want = host_shared({"forward": fwd, **plain, "loss": met["loss"], "grads": grads,
                        "adam": new_p, "mb_loss": mb_loss, "mb_grads": mb_grads,
                        "mb_adam": mb_adam})
    inputs["cfg"] = cfg
    inputs["params"] = host_shared(params)
    inputs["minibatch"] = {"params": host_shared(mparams), "batch": blocks}
    gap = {c: max_err(plain[f"partitioned_{c}"], fwd) for c in ("f32", "bf16")}
    del params, batch, fwd, plain, grads, new_p, mparams, mbatch, mb_grads, mb_adam
    gc.collect()
    torch.cuda.empty_cache()
    res = M.spawn(gnn_sharded_rank, GNN_SHARDED_RANKS, (inputs, want),
                  timeout=GNN_SHARDED_TIMEOUT_S)
    ring = {
        "edge_sharded_forward": {"all_reduce": G.full_graph_ring_bytes(cfg, N,
                                                                       GNN_SHARDED_RANKS)},
        "partitioned_f32": {"all_gather": G.partitioned_ring_bytes(cfg, N, GNN_SHARDED_RANKS,
                                                                   torch.float32)},
        "partitioned_bf16": {"all_gather": G.partitioned_ring_bytes(cfg, N, GNN_SHARDED_RANKS,
                                                                    torch.bfloat16)}}
    # the train step: the forward's, then one all-reduce of the hidden layer's
    # [N, d_hidden] cotangent (the aggregation's input, launch.mesh.copy_to)
    ring["edge_sharded_train_grads"] = {"all_reduce": ring["edge_sharded_forward"][
        "all_reduce"] + M.ring_bytes("all_reduce", N * cfg.d_hidden * 4, GNN_SHARDED_RANKS)}
    mleaves = [t for _, t in tree_flatten_with_path(inputs["minibatch"]["params"])]
    ring["minibatch_grads"] = {"all_reduce": sum(  # every gradient leaf and the loss
        M.ring_bytes("all_reduce", n * 4, GNN_SHARDED_RANKS)
        for n in [t.numel() for t in mleaves] + [1])}
    for r, rr in enumerate(res):
        if any(rr["launches"].values()):
            raise AssertionError(f"gnn_sharded rank {r} launched a hand kernel: "
                                 f"{rr['launches']}")
        for name, b in ring.items():
            if rr["bytes"][name] != b:
                raise AssertionError(f"gnn_sharded rank {r} {name}: bytes {rr['bytes'][name]} "
                                     f"!= the ring model's {b}")
    total: dict = {}
    for rr in res:
        for k, v in rr["launches"].items():
            total[k] = total.get(k, 0) + v
    fwd_b = ring["edge_sharded_forward"]["all_reduce"]
    part_b = ring["partitioned_bf16"]["all_gather"]
    summary = {
        "card": nvidia_smi(), "config": f"graphsage-reddit at ogb_products' widths (d "
        f"{cfg.d_in}, hidden {cfg.d_hidden}, {cfg.n_classes} classes)", "nodes": n_real,
        "nodes_padded": N, "edges": e_real, "edges_padded": E,
        "partitioned_edges_per_rank": cap, "minibatch_blocks": GNN_SHARDED_RANKS,
        "minibatch_targets_per_block": tgt,
        "mesh": dict(zip(("data", "model"), GNN_SHARDED_MESH)),
        "backend": "gloo, CUDA tensors staged through host memory (walls: no interconnect, "
                   "not a speed number)",
        "held_at": {"edge_sharded_forward": GNN_SHARDED_TOL, "train": "TRAIN_GRAD_TOL %s, "
                    "atol times a leaf's largest magnitude past 1; params plus Adam's freedom"
                    % (TRAIN_GRAD_TOL,), "partitioned": GNN_PART_TOL},
        "one_device_s": one_device_s,
        "one_device_partitioned_gap_to_f32_forward": gap,
        "ring_bytes_per_rank": ring,
        "edge_sharded_over_partitioned_bf16_bytes": fwd_b / part_b,
        "max_abs_err_per_rank": [rr["max_abs_err"] for rr in res],
        "bytes_per_rank": [rr["bytes"] for rr in res],
        "wall_s_per_rank": [rr["wall_s"] for rr in res],
        "phase_seconds": time.perf_counter() - t_phase}
    log(f"[gnn_sharded] bytes a rank a forward: edge-sharded {fwd_b:.0f} (all-reduce of every "
        f"layer's sums and the counts once), partitioned {part_b:.0f} in bf16 (all-gather of h a "
        f"layer): {fwd_b / part_b:.3f}x")
    log("[gnn_sharded] " + json.dumps(summary))
    del inputs, want, res
    gc.collect()
    torch.cuda.empty_cache()
    return {"paths": {"gnn_sharded": total}, "summary": summary}


def lm_small_bf16(dev: torch.device) -> dict:
    """Phase 9h2 (the docstring at the top): lm-small and lm_smoke's widths
    in bf16 compute on the card against the CPU.  Returns each config's
    summary and, under "paths", the launches of each part."""
    from repro_torch.configs import lm_common
    from repro_torch.configs.qwen2_72b import make_config as make_qwen2
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as TF
    from repro_torch.utils import keystr, tree_flatten_with_path, tree_to

    bf16 = torch.bfloat16

    def hold_tree_rows(name, got, want, tol) -> float:
        """Every leaf of two trees by rows (``limit_share``, a row the last
        dim), keys in the same order; returns the worst share of the limit."""
        got, want = tree_flatten_with_path(got), tree_flatten_with_path(want)
        if [keystr(k) for k, _ in got] != [keystr(k) for k, _ in want]:
            raise AssertionError(f"{name}: the trees' leaves differ")
        shares = {keystr(k): limit_share(g.detach().cpu(), w.detach(), *tol)
                  for (k, g), (_, w) in zip(got, want)}
        worst = max(shares, key=shares.get)
        if not shares[worst] <= 1.0:
            raise AssertionError(f"{name}: {worst} at {shares[worst]:.3f} of the limit "
                                 f"(rtol {tol[0]}, {tol[1]} of the row's RMS)")
        log(f"  {name}: ok, {len(shares)} leaves, worst {worst} at {shares[worst]:.3f} of the "
            f"limit (rtol {tol[0]}, {tol[1]} of the row's RMS)")
        return shares[worst]

    def only(name, counts, want) -> None:
        """The window's LM kernel launches are exactly ``want``."""
        keys = ("flash_attention", "flash_attention_f32", "flash_attention_backward",
                "flash_attention_backward_f32", "flash_decode", "flash_decode_partial")
        got = {k: counts[k] for k in keys}
        if got != {k: want.get(k, 0) for k in keys}:
            raise AssertionError(f"{name}: launches {got}, want {want}")

    out = {"paths": {}}
    for key, cfg, (pb, ps), (tb, ts) in (
            ("lm-small", dataclasses.replace(launch_train.make_lm_small(), compute_dtype=bf16),
             LMB_PREFILL, (LMT_SMALL_BATCH, LMT_SMALL_SEQ)),
            ("lm_smoke", dataclasses.replace(lm_common.smoke_config(make_qwen2()),
                                             compute_dtype=bf16), LMB_SMOKE, LMB_SMOKE)):
        n_steps, L_ = LMB_DECODE_STEPS, cfg.n_layers
        log(f"[lm_small_bf16] {key} (dh {cfg.d_head}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
            f"{L_} layers, d_model {cfg.d_model}, vocab {cfg.vocab}), bf16 compute: prefill "
            f"{pb} x {ps}, {n_steps} greedy decode steps, a train step of {tb} x {ts}; card "
            "vs CPU")
        params = TF.init_params(cfg, seed=0, device=dev)
        cpu_params = tree_to(params, "cpu")
        host = syn.lm_batch(np.random.default_rng(7), cfg.vocab, max(pb, tb), max(ps, ts))
        prompt = torch.from_numpy(host["tokens"][:pb, :ps])
        summary = {"config": cfg.name, "d_head": cfg.d_head, "prefill": [pb, ps],
                   "decode_steps": n_steps, "train_batch": [tb, ts]}
        # prefill (K6), then greedy steps (K7) into caches of ps + n_steps
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            last, (kc, vc) = TF.prefill(cfg, params, prompt.to(dev))
        torch.cuda.synchronize()
        summary["prefill_wall_ms"] = (time.perf_counter() - t0) * 1e3
        out["paths"][f"lm_small_bf16.{key}.prefill"] = counts = launch_counts()
        only(f"lm_small_bf16 {key} prefill", counts, {"flash_attention": L_})
        with torch.no_grad():
            kd, vd = TF.init_decode_cache(cfg, pb, ps + n_steps, device=dev)
            kd[:, :, :ps], vd[:, :, :ps] = kc, vc
        tok = last[:, :cfg.vocab].argmax(-1).to(torch.int32)
        pos = torch.tensor(ps, dtype=torch.int32, device=dev)
        fed, card_logits = [], [last]
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(n_steps):  # no host sync inside the loop
                fed.append(tok)
                logits = TF.decode_step(cfg, params, (kd, vd), tok, pos)[0]
                card_logits.append(logits)
                tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
                pos += 1
        torch.cuda.synchronize()
        summary["decode_wall_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / n_steps
        out["paths"][f"lm_small_bf16.{key}.decode"] = counts = launch_counts()
        only(f"lm_small_bf16 {key} decode", counts, {"flash_decode": L_ * n_steps})
        # the same on the CPU, fed the card's tokens
        with torch.no_grad():
            last_c, (kc_c, vc_c) = TF.prefill(cfg, cpu_params, prompt)
            kd_c, vd_c = TF.init_decode_cache(cfg, pb, ps + n_steps, device="cpu")
            kd_c[:, :, :ps], vd_c[:, :, :ps] = kc_c, vc_c
            cpu_logits = [last_c]
            for i, t in enumerate(fed):
                cpu_logits.append(TF.decode_step(cfg, cpu_params, (kd_c, vd_c), t.cpu(),
                                                 torch.tensor(ps + i, dtype=torch.int32))[0])
        what = f"lm_small_bf16 {key}: prefill {pb} x {ps} + {n_steps} decode steps"
        summary["logits_max_abs_err"] = assert_close_rows(
            f"{what}, logits on the card (K6, K7) vs the CPU", torch.stack(card_logits).cpu(),
            torch.stack(cpu_logits), *TP_BF16_TOL)
        for name, g, w in (("k cache", kd, kd_c), ("v cache", vd, vd_c)):
            summary[f"{name[0]}_cache_max_abs_err"] = assert_close_rows(
                f"{what}, {name} on the card vs the CPU", g.cpu(), w, *TP_BF16_TOL)
        summary["tokens_generated"] = torch.stack(fed[:4], 1)[:2].tolist()
        del kc, vc, kd, vd, kd_c, vd_c, card_logits, cpu_logits, last
        # one train step (K6 with its logsumexp, K6'), card vs CPU
        toks, labs = (torch.from_numpy(host[k][:tb, :ts]) for k in ("tokens", "labels"))
        reset_counts()
        t0 = time.perf_counter()
        loss_c, grads_c = TF.loss_and_grads(cfg, params, toks.to(dev), labs.to(dev))
        torch.cuda.synchronize()
        summary["train_step_wall_ms"] = (time.perf_counter() - t0) * 1e3
        out["paths"][f"lm_small_bf16.{key}.train"] = counts = launch_counts()
        # the two-level remat's launches (lm_train's launches_per_step);
        # loss_and_grads takes the batch whole, as one microbatch
        k6, k6b = 3 * L_ - cfg.groups(), L_
        only(f"lm_small_bf16 {key} train step", counts,
             {"flash_attention": k6, "flash_attention_backward": k6b})
        log(f"  lm_small_bf16 {key}: K6 x {L_} in the prefill, K7 x {L_} a decode step, K6 x "
            f"{k6} and K6' x {k6b} in the train step, all bf16")
        loss_p, grads_p = TF.loss_and_grads(cfg, cpu_params, toks, labs)
        summary["loss"] = [float(loss_c), float(loss_p)]
        assert_close(f"lm_small_bf16 {key}: train step loss, card vs CPU", loss_c.cpu(), loss_p,
                     TP_BF16_LOSS_RTOL, 0.0)
        summary["grads_worst_share"] = hold_tree_rows(
            f"lm_small_bf16 {key}: train step gradients, card vs CPU", grads_c, grads_p,
            TP_BF16_GRAD_TOL)
        out[key] = summary
        del params, cpu_params, grads_c, grads_p
    log("[lm_small_bf16] " + json.dumps({k: v for k, v in out.items() if k != "paths"}))
    return out


def lm_train(dev: torch.device, planted) -> dict:
    """Phases 9g-9k, LM training on the card (the docstring at the top):
    lm_train_kernels, lm_train_small, lm_small_bf16, lm_train, lm_moe_train
    and lm_registry.
    ``planted`` is the nvcc process and library of K6''s planted fault.
    Returns the launches of each path, K6''s rows and the paths' summaries."""
    from repro_torch import configs
    from repro_torch.configs import lm_common
    from repro_torch.configs.olmoe_1b_7b import make_config as make_olmoe
    from repro_torch.configs.stablelm_3b import make_config as make_stablelm
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as K6
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as TF
    from repro_torch.utils import tree_to

    bf16, f32 = torch.bfloat16, torch.float32
    dtypes = {"bf16": bf16, "f32": f32}
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=f32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"paths": {}}

    def launches_per_step(cfg) -> tuple[int, int]:
        """K6 and K6' launches of one train step under the two-level remat:
        each layer's forward, each group's recompute up to its last layer
        (non-reentrant checkpoints stop recomputing once the saved tensors
        they need are back), each layer's own recompute; K6' once a layer;
        per microbatch."""
        L_, M_ = cfg.n_layers, max(1, cfg.microbatches)
        return M_ * (3 * L_ - cfg.groups()), M_ * L_

    def check_step_launches(name: str, counts: dict, cfg, steps: int = 1) -> None:
        k6, k6b = launches_per_step(cfg)
        f32_ = cfg.compute_dtype == f32
        want = {"flash_attention": steps * k6, "flash_attention_backward": steps * k6b,
                "flash_attention_f32": steps * k6 * f32_,
                "flash_attention_backward_f32": steps * k6b * f32_}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"{name}: launches {got}, the remat predicts {want}")
        log(f"  {name}: K6 x {got['flash_attention']}, K6' x "
            f"{got['flash_attention_backward']} ({steps} step(s), as the remat predicts)")

    def grads_card_vs_cpu(name: str, cfg, params, toks, labs, routing: bool = False) -> float:
        """One step's loss and every gradient leaf on the card against the
        same step on the CPU (plain versions), at TRAIN_GRAD_TOL with atol
        times a leaf's largest magnitude past 1; with ``routing`` the MoE
        routing of a plain forward first, which must agree token for token."""
        cpu_params = tree_to(params, "cpu")
        if routing:
            with RoutingLog() as card_routes, torch.no_grad():
                TF.forward(cfg, params, toks)
            with RoutingLog() as cpu_routes, torch.no_grad():
                TF.forward(cfg, cpu_params, toks.cpu())
            lay = (cfg.n_layers, toks.shape[0], toks.shape[1], 0)
            flagged, margins = routing_differs(name, card_routes.by_position(*lay, forward=True),
                                               cpu_routes.by_position(*lay, forward=True))
            if flagged.any():  # every gradient leaf mixes every token
                raise AssertionError(f"{name}: {int(flagged.sum())} token(s) routed otherwise "
                                     f"(near ties, margins {margins}): no leaf compares")
            log(f"  {name}: routing of {flagged.numel()} tokens x {cfg.n_layers} layers, card "
                "vs CPU: the same")
        reset_counts()
        loss_c, grads_c = TF.loss_and_grads(cfg, params, toks, labs)
        torch.cuda.synchronize()
        check_step_launches(f"{name}, card", launch_counts(), cfg)
        calls = [0]
        plain = ref.flash_attention_ref

        def counted(*args, **kwargs):
            calls[0] += 1
            return plain(*args, **kwargs)

        ref.flash_attention_ref = counted
        try:
            loss_p, grads_p = TF.loss_and_grads(cfg, cpu_params, toks.cpu(), labs.cpu())
        finally:
            ref.flash_attention_ref = plain
        if calls[0] != launches_per_step(cfg)[0] // max(1, cfg.microbatches):
            raise AssertionError(f"{name}: the CPU's step ran attention {calls[0]} times")
        assert_close(f"{name}: loss, card vs CPU", loss_c.cpu(), loss_p, *TRAIN_GRAD_TOL)
        return assert_trees_close(f"{name}: gradients, card vs CPU", tree_to(grads_c, "cpu"),
                                  grads_p, *TRAIN_GRAD_TOL, scaled=True)

    # ---------------------------------------------------- lm_train_kernels
    log("[lm_train_kernels] K6 with its logsumexp and K6' against their plain versions")

    def k6b_bound(q, k, causal, rate=None):
        B_, S_, H_, d_ = q.shape
        pairs = S_ * (S_ + 1) // 2 if causal else S_ * S_
        flops = 5 * 2 * B_ * H_ * d_ * pairs  # S, dP, dV, dK, dQ over the pairs kept
        moved = 4 * (q.numel() + k.numel()) * q.element_size() + B_ * H_ * S_ * 4
        rate = rate or (BF16_TENSOR_FLOP_PER_S if q.dtype == bf16 else F32_FLOP_PER_S)
        return bound(moved, flops, rate)


    plant_log, _ = planted[0].communicate()
    if planted[0].returncode:
        raise RuntimeError(f"nvcc failed for K6''s planted fault:\n{plant_log}")
    planted_so = planted[1]
    rows, errs = [], {}
    for label, (B, S, H, Hkv, dh, dt, causal, timed) in LMT_KERNEL_CASES.items():
        dt = dtypes[dt]
        q = torch.randn((B, S, H, dh), device=dev, generator=gen).to(dt)
        k, v = (torch.randn((B, S, Hkv, dh), device=dev, generator=gen).to(dt) for _ in "kv")
        do = torch.randn((B, S, H, dh), device=dev, generator=gen).to(dt)
        shape = f"[{B}, {S}, {H}, {Hkv}, {dh}] {'causal' if causal else 'full'}"
        check = assert_close_rows if dt == bf16 else assert_close
        tol = LM_BF16_TOL if dt == bf16 else LM_F32_TOL
        lse = torch.empty((B, H, S), dtype=f32, device=dev)
        o_k = K6.flash_attention(q, k, v, causal, lse=lse)
        o, want_lse = ref.flash_attention_ref(q, k, v, causal, return_lse=True)
        try:
            check(f"K6 {label} {shape}: output", o_k, o, *tol)
        except AssertionError as e:
            # Which side is off, and does it repeat: both against an f64
            # plain version, and each run once more on the same inputs.
            exact = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal)
            same_k = torch.equal(K6.flash_attention(q, k, v, causal), o_k)
            same_p = torch.equal(ref.flash_attention_ref(q, k, v, causal), o)
            raise AssertionError(
                f"{e}; against f64: kernel {max_err(o_k, exact):.3e}, plain "
                f"{max_err(o, exact):.3e}; run again bit-equal: kernel {same_k}, plain "
                f"{same_p}") from None
        assert_close(f"K6 {label} {shape}: row logsumexp", lse, want_lse, *LM_F32_TOL)
        got = K6.flash_attention_backward(q, k, v, o, want_lse, do, causal)
        want = ref.flash_attention_backward_ref(q, k, v, o, want_lse, do, causal)
        floor = (K6B_FLOOR,) if dt == bf16 else ()
        errs[label] = max(check(f"K6' {label} {shape}: {n}", g, w, *tol, *floor)
                          for n, g, w in zip(("dq", "dk", "dv"), got, want))
        if label in K6B_TWICE:
            again = K6.flash_attention_backward(q, k, v, o, want_lse, do, causal)
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"K6' {label}: two launches differ")
            log(f"  K6' {label}: two launches bit-equal")
            del again
        if label in K6B_PLANTED:
            build.use_library(K6.NAME_BWD, planted_so)
            try:
                bad = K6.flash_attention_backward(q, k, v, o, want_lse, do, causal)
            finally:
                build.use_library(K6.NAME_BWD, build.library_path(K6.NAME_BWD))
            name = f"K6' {label} with its dK/dV loop skipping a query tile: dk"
            refuse = assert_refused if dt == bf16 else assert_refused_close
            refuse(name, bad[1], want[1], *tol, *floor)
            del bad
        if timed:
            # f32's bound is that of three tf32 products, which reach f32's
            # accuracy on this card (as K6 f32's); the FMA bound stands beside it.
            rate_f = TF32_TENSOR_FLOP_PER_S / 3 if dt == f32 else None
            bnd = k6b_bound(q, k, causal, rate_f)
            row = {"case": f"{label} {shape}", "max_abs_err": errs[label],
                   "ms": cuda_ms(lambda: K6.flash_attention_backward(q, k, v, o, want_lse, do,
                                                                     causal), flush),
                   "plain_ms": cuda_ms(lambda: ref.flash_attention_backward_ref(
                       q, k, v, o, want_lse, do, causal), flush, reps=5, warmup=1),
                   "library_ms": cuda_ms(sdpa_backward(q, k, v, do, causal), flush),
                   "bound_ms": bnd[0], "bound_by": bnd[1],
                   "k6_forward_ms": cuda_ms(lambda: K6.flash_attention(q, k, v, causal), flush),
                   "k6_forward_lse_ms": cuda_ms(lambda: K6.flash_attention(q, k, v, causal,
                                                                           lse=lse), flush),
                   # K6 alone at this layer: its plain version, SDPA and its bound
                   "k6_forward_plain_ms": cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal),
                                                  flush, reps=5, warmup=1),
                   "k6_forward_library_ms": cuda_ms(lambda: sdpa_forward(q, k, v, causal), flush),
                   "k6_forward_bound_ms": k6_bound(q, k, causal, rate_f)[0]}
            if dt == f32:
                row["bound_ms_fma"] = k6b_bound(q, k, causal)[0]
            # K6''s three launches (D, dK/dV, dQ), device time a launch from
            # a profiler window of 10 calls (L2 not flushed): which pass sets
            # the pace.
            busy = device_busy(lambda: K6.flash_attention_backward(q, k, v, o, want_lse, do,
                                                                   causal), 10, K6B_LAUNCHES)
            row["launch_ms"] = busy.get("kernels_ms_each")
            row["launches_traced"] = busy.get("kernels_launches")
            # Device time alone of K6', K6, SDPA and SDPA's backward
            # (``device_ms``): at lm-small's layers the event pairs above hold
            # the host's enqueue (K6 and K6' encode their tensor maps a call)
            row["device_ms"] = device_ms(lambda: K6.flash_attention_backward(
                q, k, v, o, want_lse, do, causal))
            row["k6_forward_device_ms"] = device_ms(lambda: K6.flash_attention(q, k, v, causal))
            row["k6_forward_library_device_ms"] = device_ms(lambda: sdpa_forward(q, k, v, causal))
            row["library_device_ms"] = device_ms(sdpa_backward(q, k, v, do, causal))
            rows.append(row)
            log(f"  K6' {label}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, SDPA "
                f"backward {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} by "
                f"{row['bound_by']}: {row['bound_ms'] / row['ms']:.1%} of it); launches "
                f"{row['launch_ms']}")
        del q, k, v, do, o, o_k, lse, want_lse, got, want
    torch.cuda.empty_cache()
    out["k6b_rows"], out["k6b_errs"] = rows, errs
    log("[lm_train_kernels] " + json.dumps(rows))
    # The host's enqueue of one bf16 K6' call at lm-small's layer, by part.
    B, S, H, Hkv, dh = LMB_PREFILL[0], LMB_PREFILL[1], 8, 4, 32
    q, do = (torch.randn((B, S, H, dh), device=dev, generator=gen).to(bf16) for _ in "qd")
    k, v = (torch.randn((B, S, Hkv, dh), device=dev, generator=gen).to(bf16) for _ in "kv")
    o, lse = ref.flash_attention_ref(q, k, v, True, return_lse=True)
    out["k6b_host"] = k6b_host_split(q, k, v, o, lse, do, True)
    log("[lm_train_kernels] K6' host split " + json.dumps(out["k6b_host"]))
    del q, k, v, do, o, lse

    # ------------------------------------------------------- lm_train_small
    small = launch_train.make_lm_small()
    log(f"[lm_train_small] {small.name}: one step card vs CPU on {LMT_SMALL_CHECK} sequences "
        "of the trainer's first batch, from its init")
    params = TF.init_params(small, seed=0, device=dev)
    host = syn.lm_batch(np.random.default_rng(0), small.vocab, LMT_SMALL_BATCH, LMT_SMALL_SEQ)
    toks, labs = (torch.from_numpy(host[k][:LMT_SMALL_CHECK]).to(dev) for k in ("tokens", "labels"))
    small_err = grads_card_vs_cpu("lm_train_small step", small, params, toks, labs)
    del params
    reset_counts()
    t0 = time.perf_counter()
    run = launch_train.main(["--model", "lm", "--steps", str(LMT_SMALL_STEPS), "--batch",
                             str(LMT_SMALL_BATCH), "--seq", str(LMT_SMALL_SEQ), "--log-every",
                             "10"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    out["paths"]["lm_train_small"] = launch_counts()
    check_step_launches("lm_train_small", out["paths"]["lm_train_small"], small, LMT_SMALL_STEPS)
    median_s = statistics.median(run["step_seconds"][1:])
    out["lm_train_small"] = {
        "model": small.name, "steps": run["steps"], "batch": LMT_SMALL_BATCH,
        "seq": LMT_SMALL_SEQ, "first_loss": run["first_loss"], "final_loss": run["final_loss"],
        "wall_s": wall_s, "first_step_s": run["step_seconds"][0],
        "step_wall_median_ms": median_s * 1e3,
        "tokens_per_s": LMT_SMALL_BATCH * LMT_SMALL_SEQ / median_s,
        "grads_max_abs_err": small_err}
    log("[lm_train_small] " + json.dumps(out["lm_train_small"]))

    # -------------------------------------------------------- lm_small_bf16
    small_bf16 = lm_small_bf16(dev)
    out["paths"].update(small_bf16.pop("paths"))
    out["lm_small_bf16"] = small_bf16

    # ------------------------------------------------------------- lm_train
    def train_path(name, cfg, steps, batch_seed, fall: bool, kernels: tuple):
        """``steps`` train steps of ``cfg`` (f32 params from seed 0, Adam
        3e-4 in place) on one fixed batch of LMT_BATCH x LMT_SEQ tokens,
        launches checked each step; then one profiled step.  Returns the
        params and the summary."""
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = TF.init_params(cfg, seed=0, device=dev)
        opt, _ = lm_common.make_optimizer("adam")  # the train cell's: in place
        state = opt.init(params)
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0
        host = syn.lm_batch(np.random.default_rng(batch_seed), cfg.vocab, LMT_BATCH, LMT_SEQ)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        step = TF.make_train_step(cfg, opt)
        losses, walls, counts = [], [], {}
        for i in range(steps):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t0)
            counts = {k: counts.get(k, 0) + v for k, v in launch_counts().items()}
            check_step_launches(f"{name} step {i}", launch_counts(), cfg)
        if not all(np.isfinite(losses)) or (fall and not losses[-1] < losses[0]):
            raise AssertionError(f"{name}: losses {losses} (must be finite"
                                 f"{' and fall on the fixed batch' if fall else ''})")
        peak = torch.cuda.max_memory_allocated() / 1e9
        busy = device_busy(lambda: step(params, state, batch), 1, kernels=kernels)
        k6_ms = sum(busy["kernels_ms_per_call"].values())
        summary = {
            "model": cfg.name, "layers": cfg.n_layers, "params": cfg.num_params(),
            "param_gb": cfg.num_params() * 4 / 1e9, "batch": LMT_BATCH, "seq": LMT_SEQ,
            "microbatches": cfg.microbatches, "remat_groups": cfg.groups(),
            "made_s": made_s, "losses": losses, "step_wall_s": walls,
            "step_wall_median_s": statistics.median(walls),
            "tokens_per_s": LMT_BATCH * LMT_SEQ / statistics.median(walls),
            "step_device_busy_ms": busy["device_busy_ms"],
            "k6_and_k6b_share_of_busy": None if not busy["device_busy_ms"]
            else k6_ms / busy["device_busy_ms"],
            "peak_memory_gb": peak, "profile": busy}
        return params, counts, summary

    cfg = dataclasses.replace(make_stablelm(), param_dtype=f32)  # build_lm_cell's train rule
    log(f"[lm_train] {cfg.name} at full width and depth: f32 params, bf16 compute, Adam, "
        f"{LMT_STEPS} steps of {LMT_BATCH} x {LMT_SEQ} tokens")
    params, out["paths"]["lm_train"], summary = train_path(
        "lm_train", cfg, LMT_STEPS, 0, True,
        ("flash_attention_bf16_kernel", "flash_attention_bwd"))
    cut = dataclasses.replace(cfg, n_layers=LMT_CUT_LAYERS, compute_dtype=f32,
                              remat_groups=LMT_CUT_LAYERS)
    cut_params = dict(params, layers={k: v[:LMT_CUT_LAYERS] for k, v in params["layers"].items()})
    host = syn.lm_batch(np.random.default_rng(1), cfg.vocab, LMT_CUT_BATCH, LMT_CUT_SEQ)
    summary["cut_grads_max_abs_err"] = grads_card_vs_cpu(
        f"lm_train {LMT_CUT_LAYERS}-layer f32 cut", cut, cut_params,
        *(torch.from_numpy(host[k]).to(dev) for k in ("tokens", "labels")))
    out["lm_train"] = summary
    log("[lm_train] " + json.dumps(summary))
    del params, cut_params
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------- lm_moe_train
    cfg = dataclasses.replace(make_olmoe(), n_layers=LMT_MOE_LAYERS, param_dtype=f32)
    log(f"[lm_moe_train] {cfg.name} at full width, {LMT_MOE_LAYERS} of 16 layers: f32 params, "
        f"bf16 compute, Adam, microbatches {cfg.microbatches}, {LMT_MOE_STEPS} steps of "
        f"{LMT_BATCH} x {LMT_SEQ} tokens")
    params, out["paths"]["lm_moe_train"], summary = train_path(
        "lm_moe_train", cfg, LMT_MOE_STEPS, 0, False,
        ("flash_attention_bf16_kernel", "flash_attention_bwd"))
    cut = dataclasses.replace(cfg, n_layers=LMT_CUT_LAYERS, compute_dtype=f32,
                              remat_groups=LMT_CUT_LAYERS, microbatches=1)
    cut_params = dict(params, layers={k: v[:LMT_CUT_LAYERS] for k, v in params["layers"].items()})
    host = syn.lm_batch(np.random.default_rng(1), cfg.vocab, LMT_CUT_BATCH, LMT_CUT_SEQ // 2)
    summary["cut_grads_max_abs_err"] = grads_card_vs_cpu(
        f"lm_moe_train {LMT_CUT_LAYERS}-layer f32 cut", cut, cut_params,
        *(torch.from_numpy(host[k]).to(dev) for k in ("tokens", "labels")), routing=True)
    out["lm_moe_train"] = summary
    log("[lm_moe_train] " + json.dumps(summary))
    del params, cut_params
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- lm_registry
    out["lm_registry"] = {}
    for arch_id in LM_IDS:
        reset_counts()
        res = configs.get(arch_id).smoke(str(dev))
        torch.cuda.synchronize()
        counts = launch_counts()
        for key in ("flash_attention_f32", "flash_attention_backward_f32", "flash_decode"):
            if counts[key] < 1:
                raise AssertionError(f"lm_registry {arch_id}: smoke launched no {key}: {counts}")
        out["paths"][f"lm_registry.{arch_id}"] = counts
        out["lm_registry"][arch_id] = {**res, "launches": {k: v for k, v in counts.items() if v}}
    log("[lm_registry] " + json.dumps(out["lm_registry"]))
    return out


def tp_layer_weights(cfg, tp: int, kv_sharded: bool) -> int:
    """Elements of one layer's weights a rank of `model` gathers whole for
    FSDP (wq, wk, wv, wo, wg, wu, wd; the dense family)."""
    hl, hkv = -(-cfg.n_heads // tp), cfg.n_kv_heads // (tp if kv_sharded else 1)
    return cfg.d_model * cfg.d_head * (2 * hl + 2 * hkv) + 3 * cfg.d_model * cfg.d_ff // tp


def lm_tp_prefill_ring_bytes(cfg, tp: int, dp: int, b_local: int, seq: int, steps: int) -> dict:
    """A rank's bytes over ``prefill``, ``caches_for_decode`` and ``steps``
    decode steps by the ring model (a dense config, the compute dtype's
    activations, FSDP over data in the param dtype, KV heads over model):
    the embedding's reduce-scatter (seq_shard) or all-reduce; per layer two
    all-gathers of the hidden state [B_l, S, D] over model and two
    reduce-scatters into [B_l, S / tp, D] (or two all-reduces) and the
    weights' all-gathers over data; the last position's all-gather; the
    handoff's all-gather of the KV heads; the decode steps'
    (``lm_decode_ring_bytes``)."""
    act, par = cfg.compute_dtype.itemsize, cfg.param_dtype.itemsize
    hid = b_local * seq * cfg.d_model * act
    out = {"all_gather": 0.0, "reduce_scatter": 0.0, "all_reduce": 0.0}
    if cfg.seq_shard:
        out["reduce_scatter"] += (1 + 2 * cfg.n_layers) * hid // tp * (tp - 1)
        out["all_gather"] += 2 * cfg.n_layers * hid * (tp - 1) / tp
        out["all_gather"] += b_local * tp * cfg.d_model * act * (tp - 1) / tp
    else:
        out["all_reduce"] += (1 + 2 * cfg.n_layers) * 2 * hid * (tp - 1) / tp
    if cfg.fsdp:
        out["all_gather"] += cfg.n_layers * tp_layer_weights(cfg, tp, True) * par * (dp - 1) / dp
    caches = 2 * cfg.n_layers * b_local * seq * cfg.n_kv_heads * cfg.d_head * act
    out["all_gather"] += caches * (tp - 1) / tp
    for op, v in lm_decode_ring_bytes(cfg, {"data": dp, "model": tp}, b_local * dp, ("data",),
                                      ("model",), ("data",), steps).items():
        out[op] = out.get(op, 0.0) + v
    return {k: v for k, v in out.items() if v}


def lm_tp_train_ring_bytes(cfg, tp: int, dp: int, b_local: int, seq: int) -> dict:
    """A rank's bytes over one train step (a dense config, KV sharded, one
    microbatch, FSDP over data) by the ring model, under the two-level remat
    (L layers, G groups): the hidden state's collectives of the forward, of
    each group's recompute up to its last layer (2 (L - G) of each kind),
    of each layer's own (which stops after its FFN product: 2 L gathers, L
    sums) and of the backward (each collective's transpose once); the
    weights' all-gathers at each of the 3 L - G uses and their gradients'
    reduce-scatter once a layer; the vocab-parallel loss (a row max, two
    row sums over model, two scalars over data); the gradients of the
    token table, the head and the norms summed over data, and over model
    too for the norms under seq_shard."""
    L_, G_ = cfg.n_layers, cfg.groups()
    act, par = cfg.compute_dtype.itemsize, cfg.param_dtype.itemsize
    hid = b_local * seq * cfg.d_model * act
    w = tp_layer_weights(cfg, tp, True)
    out = {"all_gather": (3 * L_ - G_) * w * par * (dp - 1) / dp,
           "reduce_scatter": L_ * w * 4 // dp * (dp - 1),
           "all_reduce": 2 * 2 * b_local * seq * 4 * (tp - 1) / tp + 2 * 2 * 4 * (dp - 1) / dp,
           "all_reduce_max": 2 * b_local * seq * 4 * (tp - 1) / tp}
    if cfg.seq_shard:
        out["all_gather"] += (8 * L_ - 2 * G_ + 2) * hid * (tp - 1) / tp
        out["reduce_scatter"] += (7 * L_ - 2 * G_ + 2) * hid // tp * (tp - 1)
    else:
        out["all_reduce"] += (7 * L_ - 2 * G_ + 2) * 2 * hid * (tp - 1) / tp
    vocab = -(-cfg.vocab // (128 * tp)) * 128  # a rank's rows of the padded vocab
    tables = 2 * vocab * cfg.d_model * 4  # its embed and head blocks, f32
    norms = (2 * L_ + 1) * cfg.d_model * 4
    if cfg.seq_shard:
        out["all_reduce"] += 2 * tables * (dp - 1) / dp + 2 * norms * (dp * tp - 1) / (dp * tp)
    else:
        out["all_reduce"] += 2 * (tables + norms) * (dp - 1) / dp
    return out


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def hold_scaled(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """``got`` within TRAIN_GRAD_TOL of ``want``, atol times the largest
    magnitude of ``want`` past 1 (``assert_trees_close``'s ``scaled``);
    returns the largest abs error."""
    rtol, atol = TRAIN_GRAD_TOL
    err = max_err(got, want)
    tol = atol * max(1.0, float(want.abs().max()))
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=tol):
        raise AssertionError(f"{label}: max abs err {err:.3e} (rtol {rtol}, atol {tol:.3e})")
    return err


def hold_adam(label: str, got: torch.Tensor, want: torch.Tensor, grad: torch.Tensor,
              steps: int, lr: float = TP_ADAM_LR) -> tuple[float, int]:
    """Params after ``steps`` Adam steps of learning rate ``lr`` within
    TRAIN_GRAD_TOL of ``want`` (atol times the largest magnitude past 1),
    plus Adam's freedom where the step-1 gradient ``grad`` lies near 0
    (TP_ADAM_LR above); returns the largest abs error and how many elements
    needed that freedom."""
    rtol, atol = TRAIN_GRAD_TOL
    g, w, d = grad.float(), want.float(), (got.float() - want.float()).abs()
    tight = rtol * w.abs() + atol * max(1.0, float(w.abs().max()))
    gtol = atol * max(1.0, float(g.abs().max()))
    free = 2.1 * steps * lr * torch.clamp(gtol / (g.abs() + TP_ADAM_EPS), max=1.0)
    if bool((d > tight + free).any()):
        i = int((d - tight - free).argmax())
        raise AssertionError(f"{label}: max abs err {float(d.max()):.3e}; at element {i} "
                             f"{float(d.flatten()[i]):.3e} past TRAIN_GRAD_TOL "
                             f"{float(tight.flatten()[i]):.3e} plus Adam's freedom "
                             f"{float(free.flatten()[i]):.3e} (step-1 gradient "
                             f"{float(g.flatten()[i]):.3e})")
    return float(d.max()), int((d > tight).sum())


def profiled_counts(fn, names: tuple) -> tuple:
    """``fn()`` under ``torch.profiler`` on the card: its result and, for
    each name, how many device kernels whose name holds it ran (None for
    every name when the trace holds no device events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return result, dict.fromkeys(names)
    return result, {n: sum(n in k for k in kernels) for n in names}


def hold_profiled(label: str, got: dict, want: dict) -> None:
    """The profiler's kernel counts ``got`` (``profiled_counts``) equal to
    ``want``; a trace with no device events fails."""
    if any(v is None for v in got.values()):
        raise AssertionError(f"{label}: the profiler's trace holds no device events")
    if got != want:
        raise AssertionError(f"{label}: profiled kernels {got}, want {want}")


def bytes_since(before: dict) -> dict:
    from repro_torch.launch import mesh as M

    return {op: v - before.get(op, 0.0) for op, v in M.comm_bytes().items()
            if v != before.get(op, 0.0)}


def host_shared(tree):
    """``tree``'s tensors copied to host shared memory: a spawned rank
    receives a handle to each, not its bytes."""
    from repro_torch.utils import tree_map

    return tree_map(lambda t: t.detach().to("cpu").share_memory_(), tree)


def on_card_block(whole: torch.Tensor, spec, mesh, dev) -> torch.Tensor:
    """This rank's block of a host tensor under ``spec``, copied to the card."""
    from repro_torch.models import layers as L

    return L.constrain(whole, spec, mesh).to(dev)


TP_PREFILL_KERNELS = ("flash_attention_bf16_kernel", "flash_attention_f32_kernel",
                      "flash_decode")
TP_TRAIN_KERNELS = ("flash_attention_bf16_kernel", "flash_attention_f32_kernel",
                    "flash_attention_bwd_dq")


def lm_tp_prefill_rank(rank: int, world: int, params: dict, cases: list) -> dict:
    """One rank of lm_tp_prefill (spawned by ``launch.mesh.spawn`` over gloo;
    each case's whole params are the main process's CUDA tensors, shared,
    never copied; its one-device outputs are host tensors in shared
    memory): under mesh (data 2, model 2), the rank's blocks of the params
    (``mesh_param_specs``: FSDP over data, heads and FFN columns over
    model), ``prefill`` of its prompt, ``caches_for_decode`` and
    TP_DECODE_STEPS ``decode_step``s from them (the same params), profiled
    and with the launch counts and bytes
    read around it; then its blocks of the last logits, the prefill's
    caches, each step's logits and the caches after the steps against the
    one device's."""
    from repro_torch.core.sharding import PartitionSpec as P
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as TF

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dev = torch.device(DEVICE)
    mesh = M.Mesh(TP_MESH, ("data", "model"))
    ba, seq_axes = ("data",), ("model",)
    out = {"coords": dict(mesh.coords)}
    for case, whole in zip(cases, params):
        name, cfg, want = case["name"], case["cfg"], case["want"]
        p = R.shard_params(whole, TF.mesh_param_specs(cfg, mesh, ba), mesh)
        toks = L.constrain(case["tokens"], P(ba), mesh).to(dev)
        dec_toks = L.constrain(case["decode_tokens"], P(None, ba), mesh).to(dev)
        S = toks.shape[1]

        def path():
            t0 = time.perf_counter()
            with torch.no_grad():
                last, caches = TF.prefill(cfg, p, toks, mesh, ba)
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t0
                cache = TF.caches_for_decode(cfg, caches, case["cache"], mesh, ba)
                pos = torch.tensor(S, dtype=torch.int32, device=dev)
                logits = []
                t1 = time.perf_counter()
                for i in range(TP_DECODE_STEPS):
                    lg, cache = TF.decode_step(cfg, p, cache, dec_toks[i], pos, mesh, ba,
                                               seq_axes)
                    logits.append(lg)
                    pos += 1
                torch.cuda.synchronize()
            return (last, caches, torch.stack(logits), cache, prefill_s,
                    (time.perf_counter() - t1) / TP_DECODE_STEPS)

        reset_counts()
        before = M.comm_bytes()
        (last, caches, logits, cache, prefill_s, step_s), prof = profiled_counts(
            path, TP_PREFILL_KERNELS)
        counts, sent = launch_counts(), bytes_since(before)
        kv_spec = P(None, ba, None, "model" if cfg.kv_sharded(mesh) else None, None)
        cspec = TF.cache_specs(cfg, ba, seq_axes)
        checks = (("last logits", last, want["last"], P(ba, "model")),
                  ("prefill k cache", caches[0], want["k"], kv_spec),
                  ("prefill v cache", caches[1], want["v"], kv_spec),
                  (f"{TP_DECODE_STEPS} steps' logits", logits, want["decode"],
                   P(None, ba, "model")),
                  ("k cache after the steps", cache[0], want["decode_k"], cspec),
                  ("v cache after the steps", cache[1], want["decode_v"], cspec))
        errs, shares = {}, {}
        for what, got, whole_want, spec in checks:
            w = on_card_block(whole_want, spec, mesh, dev)
            label = (f"[lm_tp_prefill] rank {rank} {dict(mesh.coords)} {name}: {what} "
                     f"{list(got.shape)} vs one device")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{label}: not finite")
            errs[what] = err = max_err(got, w)
            if case["rows"]:
                shares[what] = share = limit_share(got, w, *case["tol"])
                ok, limit = share <= 1.0, (f"{share:.3f} of the limit: rtol {case['tol'][0]}"
                                           f", {case['tol'][1]} of the row's RMS")
            else:
                ok = torch.allclose(got.float(), w.float(), rtol=case["tol"][0],
                                    atol=case["tol"][1])
                limit = f"rtol {case['tol'][0]}, atol {case['tol'][1]}"
            if not ok:
                raise AssertionError(f"{label}: disagrees (max abs err {err:.3e}, {limit})")
            log(f"  {label}: ok, max abs err {err:.3e} ({limit})")
        out[name] = {"launches": counts, "profiled_kernels": prof, "bytes": sent,
                     "max_abs_err": errs, "limit_share": shares, "prefill_wall_s": prefill_s,
                     "decode_step_wall_s": step_s, "cache_block": list(cache[0].shape)}
        del p, last, caches, logits, cache
    return out


def lm_tp_train_rank(rank: int, world: int, params: dict, cases: list) -> dict:
    """One rank of lm_tp_train (spawned over gloo; ``params`` is the main
    process's CUDA tensors, shared; the cases' one-device losses, step-1
    gradients and params after the steps are host tensors in shared
    memory): for each case (bf16 compute, f32 compute) and each layout
    (the config's seq_shard, then on), the rank's blocks of the params
    (cloned: Adam updates them in place), its batch block, the step-1
    gradients of ``loss_and_grads`` under the profiler, then
    TP_TRAIN_STEPS steps of ``make_train_step(mesh=...)`` with the train
    cell's Adam, launch counts and bytes read around them; each against the
    one device's."""
    from repro_torch.configs import lm_common
    from repro_torch.core.sharding import PartitionSpec as P
    from repro_torch.core.sharding import is_spec
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as TF
    from repro_torch.utils import keystr, tree_flatten_with_path, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dev = torch.device(DEVICE)
    mesh = M.Mesh(TP_MESH, ("data", "model"))
    ba = ("data",)
    out = {"coords": dict(mesh.coords)}
    for case in cases:
        want = case["want"]
        for seq_shard in (case["cfg"].seq_shard, True):
            cfg = dataclasses.replace(case["cfg"], seq_shard=seq_shard)
            name = f"{case['name']} seq_shard={seq_shard}"
            label = f"[lm_tp_train] rank {rank} {dict(mesh.coords)} {name}"
            layout = TF.mesh_param_specs(cfg, mesh, ba)
            p = tree_map(lambda t: t.clone(), R.shard_params(params, layout, mesh))
            batch = {k: L.constrain(v, P(ba), mesh).to(dev) for k, v in case["batch"].items()}
            (loss1, grads), prof = profiled_counts(
                lambda: TF.loss_and_grads(cfg, p, batch["tokens"], batch["labels"], mesh, ba),
                TP_TRAIN_KERNELS)
            specs = {keystr(k): s for k, s in tree_flatten_with_path(layout, is_spec)}
            grad_errs, grad_shares = {}, {}
            for key, g in tree_flatten_with_path(grads):
                k = keystr(key)
                w = on_card_block(want["grads"][k], specs[k], mesh, dev)
                if case["hold"]:
                    grad_errs[k] = hold_scaled(f"{label}: step-1 gradient {k}", g, w)
                    continue
                grad_errs[k] = err = max_err(g, w)
                grad_shares[k] = share = limit_share(g, w, *TP_BF16_GRAD_TOL)
                if not share <= 1.0:
                    raise AssertionError(
                        f"{label}: step-1 gradient {k} {list(g.shape)} disagrees with one "
                        f"device's (max abs err {err:.3e}, {share:.3f} of the limit: rtol "
                        f"{TP_BF16_GRAD_TOL[0]}, {TP_BF16_GRAD_TOL[1]} of the row's RMS)")
            if grad_shares:
                worst = max(grad_shares, key=grad_shares.get)
                log(f"  {label}: step-1 gradients ok, at most {grad_shares[worst]:.3f} of the "
                    f"limit ({worst}; rtol {TP_BF16_GRAD_TOL[0]}, {TP_BF16_GRAD_TOL[1]} of the "
                    f"row's RMS)")
            del grads
            opt, _ = lm_common.make_optimizer("adam")
            state = opt.init(p)
            step = TF.make_train_step(cfg, opt, mesh, ba, grad_specs=layout)
            reset_counts()
            before = M.comm_bytes()
            losses, walls = [], []
            for _ in range(TP_TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, state, m = step(p, state, batch)
                losses.append(float(m["loss"]))
                walls.append(time.perf_counter() - t0)
            counts, sent = launch_counts(), bytes_since(before)
            rtol, atol = TRAIN_GRAD_TOL if case["hold"] else (TP_BF16_LOSS_RTOL, 0.0)
            if not (np.allclose(losses, want["losses"], rtol=rtol, atol=atol)
                    and np.allclose(float(loss1), want["losses"][0], rtol=rtol, atol=atol)):
                raise AssertionError(f"{label}: losses {losses} (step-1 gradients' "
                                     f"{float(loss1)}) vs one device's {want['losses']} "
                                     f"(rtol {rtol}, atol {atol})")
            log(f"  {label}: losses {losses} vs one device's {want['losses']}: ok "
                f"(rtol {rtol}, atol {atol})")
            param_errs, freed = {}, 0
            for key, t in tree_flatten_with_path(p):
                k = keystr(key)
                w = on_card_block(want["params"][k], specs[k], mesh, dev)
                if case["hold"]:
                    g1 = on_card_block(want["grads"][k], specs[k], mesh, dev)
                    param_errs[k], n = hold_adam(f"{label}: {k} after {TP_TRAIN_STEPS} steps",
                                                 t, w, g1, TP_TRAIN_STEPS)
                    freed += n
                else:
                    param_errs[k] = max_err(t, w)
            log(f"  {label}: step-1 gradients' and params' max abs err "
                f"{max(grad_errs.values()):.3e}, {max(param_errs.values()):.3e}"
                + (f", held at {TRAIN_GRAD_TOL} scaled ({freed} param elements of "
                   f"{sum(t.numel() for _, t in tree_flatten_with_path(p))} past it, within "
                   "Adam's freedom)" if case["hold"] else
                   ", the gradients held by limit_share, the params reported"))
            out[name] = {"launches": counts, "profiled_kernels": prof, "bytes": sent,
                         "losses": losses, "step_wall_s": walls, "params_freed": freed,
                         "grads_max_abs_err": max(grad_errs.values()),
                         "params_max_abs_err": max(param_errs.values()),
                         "grads_max_abs_err_by_leaf": grad_errs,
                         "grads_limit_share_by_leaf": grad_shares,
                         "params_max_abs_err_by_leaf": param_errs,
                         "held": case["hold"]}
            del p, state, batch
    return out


def lm_tp(dev: torch.device) -> dict:
    """Phases 9l and 9m, the LM's tensor-, sequence- and FSDP-parallel
    paths (the docstring at the top): each runs its one-device computation
    on the card first, keeps its outputs in host shared memory, frees what
    the card held for it but the params, and spawns TP_RANKS gloo ranks.
    Returns each path's launches summed over the ranks and the phases'
    summaries."""
    from repro_torch.configs.lm_common import make_optimizer, serving_config
    from repro_torch.configs.qwen2_72b import make_config as make_qwen2
    from repro_torch.configs.stablelm_3b import make_config as make_stablelm
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as TF
    from repro_torch.utils import keystr, tree_flatten_with_path, tree_map

    f32 = torch.float32
    amesh = M.AbstractMesh(TP_MESH, ("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {"paths": {}}

    def sum_launches(results, names) -> dict:
        total: dict = {}
        for res in results:
            for n in names:
                for k, v in res[n]["launches"].items():
                    total[k] = total.get(k, 0) + v
        return total

    # --------------------------------------------------------- lm_tp_prefill
    base = dataclasses.replace(serving_config(make_qwen2()), fsdp=True)  # fsdp_serve
    runs = [("bf16", dataclasses.replace(base, n_layers=TP_PREFILL_LAYERS), TP_PREFILL_SEQ,
             TP_CACHE, True, TP_BF16_TOL),
            ("f32", dataclasses.replace(base, n_layers=TP_F32_LAYERS, param_dtype=f32,
                                        compute_dtype=f32), TP_F32_SEQ, TP_F32_CACHE, False,
             TP_F32_TOL)]
    log(f"[lm_tp_prefill] {base.name} at full width on {TP_RANKS} gloo ranks, mesh "
        f"{dict(zip(('data', 'model'), TP_MESH))}: {TP_PREFILL_LAYERS} layers bf16 at "
        f"{TP_PREFILL_BATCH} x {TP_PREFILL_SEQ}, {TP_F32_LAYERS} layer f32 at "
        f"{TP_PREFILL_BATCH} x {TP_F32_SEQ}; {TP_DECODE_STEPS} decode steps each")
    cases, whole_params, one_device, floors = [], [], {}, {}
    for name, cfg, S, cache_len, rows, tol in runs:
        t0 = time.perf_counter()
        params = TF.init_params(cfg, seed=0, device=dev, mesh=amesh)
        toks = torch.randint(0, cfg.vocab, (TP_PREFILL_BATCH, S), generator=gen, device=dev,
                             dtype=torch.int32)
        dec = torch.randint(0, cfg.vocab, (TP_DECODE_STEPS, TP_PREFILL_BATCH), generator=gen,
                            device=dev, dtype=torch.int32)
        with torch.no_grad():
            last, (k, v) = TF.prefill(cfg, params, toks)
            pad = (0, 0, 0, 0, 0, cache_len - S)
            cache = (torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad))
            pos = torch.tensor(S, dtype=torch.int32, device=dev)
            logits = []
            for i in range(TP_DECODE_STEPS):
                lg, cache = TF.decode_step(cfg, params, cache, dec[i], pos)
                logits.append(lg)
                pos += 1
        want = host_shared({"last": last, "k": k, "v": v, "decode": torch.stack(logits),
                            "decode_k": cache[0], "decode_v": cache[1]})
        one_device[name] = time.perf_counter() - t0
        if not rows:  # the card's own floor: each prompt alone, other GEMM shapes
            with torch.no_grad():
                alone = [TF.prefill(cfg, params, toks[b:b + 1]) for b in range(TP_PREFILL_BATCH)]
            floors[name] = {
                "last logits": max(max_err(a[0][0], last[b]) for b, a in enumerate(alone)),
                "prefill k cache": max(max_err(a[1][0][:, 0], k[:, b])
                                       for b, a in enumerate(alone))}
            log(f"  [lm_tp_prefill] {name}: one device, each prompt alone against the batch: "
                f"max abs err {floors[name]} (the card's f32 floor at these widths)")
            del alone
        del last, k, v, cache, logits
        cases.append({"name": name, "cfg": cfg, "cache": cache_len, "rows": rows, "tol": tol,
                      "tokens": host_shared(toks), "decode_tokens": host_shared(dec),
                      "want": want})
        whole_params.append(params)
    gc.collect()
    torch.cuda.empty_cache()
    res = M.spawn(lm_tp_prefill_rank, TP_RANKS, (whole_params, cases), timeout=TP_TIMEOUT_S)
    for (name, cfg, S, cache_len, rows, tol) in runs:
        ring = lm_tp_prefill_ring_bytes(cfg, TP_MESH[1], TP_MESH[0],
                                        TP_PREFILL_BATCH // TP_MESH[0], S, TP_DECODE_STEPS)
        for r, rr in enumerate(res):
            run = rr[name]
            want_k6 = {"flash_attention": cfg.n_layers,
                       "flash_attention_f32": cfg.n_layers * (cfg.compute_dtype == f32),
                       "flash_decode": cfg.n_layers * TP_DECODE_STEPS,
                       "flash_decode_partial": cfg.n_layers * TP_DECODE_STEPS}
            got = {k: run["launches"][k] for k in want_k6}
            if got != want_k6:
                raise AssertionError(f"lm_tp_prefill rank {r} {name}: launches {got}, want "
                                     f"{want_k6}")
            f32_run = cfg.compute_dtype == f32
            want_prof = {"flash_attention_bf16_kernel": cfg.n_layers * (not f32_run),
                         "flash_attention_f32_kernel": cfg.n_layers * f32_run,
                         "flash_decode": cfg.n_layers * TP_DECODE_STEPS}
            hold_profiled(f"lm_tp_prefill rank {r} {name}", run["profiled_kernels"],
                          want_prof)
            if run["bytes"] != ring:
                raise AssertionError(f"lm_tp_prefill rank {r} {name}: bytes {run['bytes']} "
                                     f"!= the ring model's {ring}")
    out["paths"]["lm_tp_prefill"] = sum_launches(res, [n for n, *_ in runs])
    out["lm_tp_prefill"] = summary = {
        "card": nvidia_smi(), "config": f"{base.name} widths", "mesh": dict(zip(("data", "model"),
                                                                          TP_MESH)),
        "backend": "gloo, CUDA tensors staged through host memory (walls: no interconnect, "
                   "not a speed number)",
        "one_device_s": one_device, "one_device_batch_shape_max_abs_err": floors,
        "runs": {name: {
            "layers": cfg.n_layers, "batch": TP_PREFILL_BATCH, "seq": S, "cache": cache_len,
            "compute": str(cfg.compute_dtype)[6:], "params": str(cfg.param_dtype)[6:],
            "tolerance": ("assert_close_rows rtol %g, %g of the row's RMS" if rows
                          else "allclose rtol %g, atol %g") % tol,
            "coords_per_rank": [rr["coords"] for rr in res],
            "max_abs_err_per_rank": [rr[name]["max_abs_err"] for rr in res],
            "limit_share_per_rank": [rr[name]["limit_share"] for rr in res],
            "launches_per_rank": [{k: v for k, v in rr[name]["launches"].items() if v}
                                  for rr in res],
            "profiled_kernels_per_rank": [rr[name]["profiled_kernels"] for rr in res],
            "bytes_per_rank": [rr[name]["bytes"] for rr in res],
            "ring_model_bytes": lm_tp_prefill_ring_bytes(
                cfg, TP_MESH[1], TP_MESH[0], TP_PREFILL_BATCH // TP_MESH[0], S,
                TP_DECODE_STEPS),
            "prefill_wall_s_per_rank": [rr[name]["prefill_wall_s"] for rr in res],
            "decode_step_wall_s_per_rank": [rr[name]["decode_step_wall_s"] for rr in res],
            "cache_block_per_rank": [rr[name]["cache_block"] for rr in res]}
            for name, cfg, S, cache_len, rows, tol in runs}}
    log("[lm_tp_prefill] " + json.dumps(summary))
    del whole_params, cases, res
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- lm_tp_train
    cfg_b = dataclasses.replace(make_stablelm(), n_layers=TP_TRAIN_LAYERS, remat_groups=1,
                                param_dtype=f32)  # build_lm_cell's train rule
    runs = [("bf16", cfg_b, TP_TRAIN_SEQ, False),
            ("f32", dataclasses.replace(cfg_b, compute_dtype=f32), TP_TRAIN_F32_SEQ, True)]
    log(f"[lm_tp_train] {cfg_b.name} at full width, {TP_TRAIN_LAYERS} of 32 layers, f32 params, "
        f"Adam, {TP_TRAIN_STEPS} steps on {TP_RANKS} gloo ranks, mesh "
        f"{dict(zip(('data', 'model'), TP_MESH))}, at seq_shard {cfg_b.seq_shard} and True: "
        f"bf16 compute at {TP_TRAIN_BATCH} x {TP_TRAIN_SEQ}, f32 at {TP_TRAIN_BATCH} x "
        f"{TP_TRAIN_F32_SEQ}")
    p0 = TF.init_params(cfg_b, seed=0, device=dev, mesh=amesh)
    cases, floors = [], {}
    for name, cfg, S, hold in runs:
        t0 = time.perf_counter()
        host = {k: torch.from_numpy(v) for k, v in syn.lm_batch(
            np.random.default_rng(11), cfg.vocab, TP_TRAIN_BATCH, S).items()}
        batch = {k: v.to(dev) for k, v in host.items()}
        _, grads = TF.loss_and_grads(cfg, p0, batch["tokens"], batch["labels"])
        if hold:  # the card's own floor: the mean of each sequence's gradients alone
            halves = [TF.loss_and_grads(cfg, p0, batch["tokens"][b:b + 1],
                                        batch["labels"][b:b + 1])[1]
                      for b in range(TP_TRAIN_BATCH)]
            floors[name] = max(max_err(sum(ts) / TP_TRAIN_BATCH, g) for (_, g), *ts in zip(
                tree_flatten_with_path(grads), *([t for _, t in tree_flatten_with_path(h)]
                                                 for h in halves)))
            log(f"  [lm_tp_train] {name}: one device, the step-1 gradients as the mean of each "
                f"sequence's alone against the batch's: max abs err {floors[name]:.3e}")
            del halves
        grads = host_shared({keystr(k): g for k, g in tree_flatten_with_path(grads)})
        p = tree_map(lambda t: t.clone(), p0)
        opt, _ = make_optimizer("adam")
        state = opt.init(p)
        step = TF.make_train_step(cfg, opt)
        losses = []
        for _ in range(TP_TRAIN_STEPS):
            p, state, m = step(p, state, batch)
            losses.append(float(m["loss"]))
        want = {"losses": losses, "grads": grads,
                "params": host_shared({keystr(k): t for k, t in tree_flatten_with_path(p)})}
        del p, state, batch
        cases.append({"name": name, "cfg": cfg, "hold": hold, "batch": host_shared(host),
                      "want": want, "one_device_s": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()
    res = M.spawn(lm_tp_train_rank, TP_RANKS, (p0, cases), timeout=TP_TIMEOUT_S)
    names = []
    for name, cfg, S, hold in runs:
        for seq_shard in (cfg.seq_shard, True):
            lay = dataclasses.replace(cfg, seq_shard=seq_shard)
            key = f"{name} seq_shard={seq_shard}"
            names.append(key)
            ring = {op: TP_TRAIN_STEPS * v for op, v in lm_tp_train_ring_bytes(
                lay, TP_MESH[1], TP_MESH[0], TP_TRAIN_BATCH // TP_MESH[0], S).items()}
            k6 = (3 * cfg.n_layers - cfg.groups()) * TP_TRAIN_STEPS
            want_k = {"flash_attention": k6, "flash_attention_backward":
                      cfg.n_layers * TP_TRAIN_STEPS,
                      "flash_attention_f32": k6 * (cfg.compute_dtype == f32),
                      "flash_attention_backward_f32":
                          cfg.n_layers * TP_TRAIN_STEPS * (cfg.compute_dtype == f32)}
            f32_run = cfg.compute_dtype == f32
            k6_call = 3 * cfg.n_layers - cfg.groups()  # the profiled loss_and_grads
            want_prof = {"flash_attention_bf16_kernel": k6_call * (not f32_run),
                         "flash_attention_f32_kernel": k6_call * f32_run,
                         "flash_attention_bwd_dq": cfg.n_layers}
            for r, rr in enumerate(res):
                got = {k: rr[key]["launches"][k] for k in want_k}
                if got != want_k:
                    raise AssertionError(f"lm_tp_train rank {r} {key}: launches {got}, the "
                                         f"remat predicts {want_k}")
                hold_profiled(f"lm_tp_train rank {r} {key}", rr[key]["profiled_kernels"],
                              want_prof)
                if rr[key]["bytes"] != ring:
                    raise AssertionError(f"lm_tp_train rank {r} {key}: bytes "
                                         f"{rr[key]['bytes']} != the ring model's {ring}")
    out["paths"]["lm_tp_train"] = sum_launches(res, names)
    out["lm_tp_train"] = summary = {
        "card": nvidia_smi(), "config": f"{cfg_b.name} widths, {TP_TRAIN_LAYERS} layers, one remat "
        "group", "mesh": dict(zip(("data", "model"), TP_MESH)),
        "backend": "gloo, CUDA tensors staged through host memory (walls: no interconnect, "
                   "not a speed number)",
        "one_device_s": {c["name"]: c["one_device_s"] for c in cases},
        "one_device_losses": {c["name"]: c["want"]["losses"] for c in cases},
        "one_device_batch_shape_grads_max_abs_err": floors,
        "runs": {key: {
            "held_at": "TRAIN_GRAD_TOL %s, atol times a leaf's largest magnitude past 1; "
                       "params plus Adam's freedom near a zero gradient" % (TRAIN_GRAD_TOL,)
                       if res[0][key]["held"]
                       else f"losses at rtol {TP_BF16_LOSS_RTOL}; step-1 gradients by "
                            f"limit_share, rtol {TP_BF16_GRAD_TOL[0]} plus "
                            f"{TP_BF16_GRAD_TOL[1]} of the row's RMS; params reported",
            "losses_per_rank": [rr[key]["losses"] for rr in res],
            "grads_max_abs_err_per_rank": [rr[key]["grads_max_abs_err"] for rr in res],
            "grads_limit_share_by_leaf_per_rank": [rr[key]["grads_limit_share_by_leaf"]
                                                   for rr in res],
            "params_max_abs_err_per_rank": [rr[key]["params_max_abs_err"] for rr in res],
            "params_past_train_grad_tol_per_rank": [rr[key]["params_freed"] for rr in res],
            "launches_per_rank": [{k: v for k, v in rr[key]["launches"].items() if v}
                                  for rr in res],
            "profiled_kernels_per_rank": [rr[key]["profiled_kernels"] for rr in res],
            "bytes_per_rank": [rr[key]["bytes"] for rr in res],
            "step_wall_s_per_rank": [rr[key]["step_wall_s"] for rr in res]}
            for key in names}}
    log("[lm_tp_train] " + json.dumps(summary))
    del p0, cases, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


DRY_CELLS = (("stablelm-3b", "train_4k"), ("dlrm-flexemr", "train_batch"))  # on the 16x16 pod
DRY_CACHE_SLOTS = 1 << 12  # the traced cached forward's hash cache
DRY_BATCH = 256  # dlrm-100m's train step and cached forward
DRY_LM_BATCH, DRY_LM_SEQ = 8, 128  # lm-small's train and decode steps
DRY_K5 = (MINER_ROWS, 16, 12)  # K5 at the miner's shape, f64
# a trace's peak live bytes against the allocator's requested bytes (or the
# other trace's): an op may ask the allocator for a temporary below the
# dispatcher, and meta sees a tensor constructor's host copy that the card
# makes below it
DRY_PEAK_TOL = (0.01, 512)  # (share of the peak, bytes a storage the traces made)


def dry_vs_card(name: str, card_fn, meta_fn) -> dict:
    """Phase 10b's check of one program: ``card_fn`` once untraced (its
    kernels' scratch made), then traced with the launch counts reset, and
    ``meta_fn`` traced (the dry run's route).  FLOPs by class, launches by
    kernel and collective bytes must be equal, the launches equal to the
    wrappers' counts, and the memory bytes equal but for scratch fills
    (``zero_``/``fill_`` on the card only), which are named.  The card
    trace's peak live bytes must match the caching allocator's peak of
    requested bytes over the same run (less what was requested before),
    and the meta trace's the card trace's, within DRY_PEAK_TOL; the
    allocator's block bytes (``max_memory_allocated``'s) are reported."""
    from repro_torch.launch.hlo_analysis import Trace

    card_fn()
    torch.cuda.synchronize()
    reset_counts()
    before = torch.cuda.memory_stats()
    torch.cuda.reset_peak_memory_stats()
    with Trace() as card:
        card_fn()
        torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    # the allocator's peak of the bytes asked of it (its blocks' bytes add
    # a 512-byte rounding and the unsplit rest of a reused cached block)
    requested = after["requested_bytes.all.peak"] - before["requested_bytes.all.current"]
    blocks = after["allocated_bytes.all.peak"] - before["allocated_bytes.all.current"]
    counts = {k: v for k, v in launch_counts().items() if v}
    with Trace() as dry:
        meta_fn()
    peaks = {"allocator_requested": requested, "card_trace": card.peak_bytes,
             "meta_trace": dry.peak_bytes, "allocator_blocks": blocks}
    rel, per_storage = DRY_PEAK_TOL
    tol = per_storage * max(card.storages, dry.storages)
    for a, b in (("allocator_requested", "card_trace"), ("card_trace", "meta_trace")):
        if abs(peaks[a] - peaks[b]) > rel * peaks[a] + tol:
            raise AssertionError(f"dryrun {name}: peak live bytes {peaks} ({a} against {b}, "
                                 f"tolerance {rel} of it + {tol} bytes)")
    for what, a, b in (("flops", card.flops, dry.flops),
                       ("launches", card.kernel_launches(), dry.kernel_launches()),
                       ("collective bytes", card.collective_bytes(), dry.collective_bytes())):
        if a != b:
            raise AssertionError(f"dryrun {name}: {what} on the card {a} != on meta {b}")
    if card.kernel_launches() != counts:
        raise AssertionError(f"dryrun {name}: traced launches {card.kernel_launches()} != the "
                             f"wrappers' counts {counts}")
    diff = {op: card.bytes_by_op.get(op, 0) - dry.bytes_by_op.get(op, 0)
            for op in set(card.bytes_by_op) | set(dry.bytes_by_op)}
    diff = {op: d for op, d in diff.items() if d}
    if any(d < 0 or op.split(".")[0] not in ("zero_", "fill_") for op, d in diff.items()) \
            or card.mem_bytes - dry.mem_bytes != sum(diff.values()):
        raise AssertionError(f"dryrun {name}: memory bytes on the card {card.mem_bytes} against "
                             f"{dry.mem_bytes} on meta, by op {diff}")
    row = {"flops_by_class": dry.flops, "launches": counts, "mem_bytes": dry.mem_bytes,
           "scratch_fill_bytes_on_the_card": diff, "kernels": dry.kernels,
           "peak_bytes": peaks}
    log(f"[dryrun] {name}: card = meta: FLOPs {dry.flops}, launches {counts}, "
        f"{dry.mem_bytes:.0f} bytes (+ {diff or 'no'} scratch fills on the card); "
        f"peak live bytes {peaks}")
    return row


def dryrun(dev: torch.device, lm_train_summary: dict) -> dict:
    """Phase 10, dryrun: (a) ``launch.dryrun.run_cell`` of DRY_CELLS on the
    16x16 ``DryMesh`` (terms, per-device memory beside an H100's 80 GB);
    (b) the trace of each program on the card against the same on meta
    (``dry_vs_card``): one lm-small train step in f32 (K6 f32, K6' f32),
    one lm-small decode step (K7 f32), one dlrm-100m train step (K1
    masked, K2, K1', K2'), a cached forward of dlrm-100m over a hash cache
    (K3, K1, K2) beside K4's swap-in of the cache's rows, and K5 at the
    miner's shape; (c) stablelm-3b's train step of phase 9i traced on meta
    at mesh None: its roofline bound (H100 SXM data sheet) beside the busy
    time 9i measured, the first share of a whole step's roofline.  Returns
    the paths' launches and the summary."""
    from repro_torch.configs import lm_common
    from repro_torch.configs.stablelm_3b import make_config as make_stablelm
    from repro_torch.core.embedding import make_hash_cache_from_table
    from repro_torch.data import synthetic as syn
    from repro_torch.hotcache import kernels as HK
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch import train as launch_train
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as TF
    from repro_torch.prefetch import kernels as PK
    from repro_torch.utils import tree_map

    t_phase = time.perf_counter()
    out: dict = {"paths": {}, "card": nvidia_smi()}
    log(f"[dryrun] {out['card']}; bounds from the H100 SXM data sheet (989/495/67 TFLOP/s "
        "bf16/tf32/f32, 3.35 TB/s, NVLink 450 GB/s a direction, 50 GB/s across nodes)")

    # ---- (a) two registry cells on the 16x16 pod, one rank traced on meta
    out["cells"] = {}
    for arch_id, shape in DRY_CELLS:
        rec = DR.run_cell(arch_id, shape, False, ROOT / "build" / "dryrun")
        mem, roof = rec["memory_analysis"], rec["roofline"]
        out["cells"][f"{arch_id}.{shape}"] = {
            "trace_s": rec["compile_seconds"], "per_device_total_gb": mem["per_device_total"] / 1e9,
            "of_80_gb": mem["per_device_total"] / HA.HBM_BYTES, "roofline": roof}
        log(f"[dryrun] {arch_id} x {shape} x 16x16: {mem['per_device_total'] / 1e9:.3f} GB a "
            f"device ({mem['per_device_total'] / HA.HBM_BYTES:.3f} of 80 GB), compute "
            f"{roof['compute_s'] * 1e3:.3f} ms, memory {roof['memory_s'] * 1e3:.3f} ms, "
            f"collective {roof['collective_s'] * 1e3:.3f} ms: {roof['dominant']}-bound")

    def on_meta(tree):
        return tree_map(lambda t: torch.empty_like(t, device="meta")
                        if isinstance(t, torch.Tensor) else t, tree)

    # ---- (b) card against meta
    checks = {}
    lcfg = launch_train.make_lm_small()
    lparams = TF.init_params(lcfg, seed=0, device=dev)
    lopt, _ = lm_common.make_optimizer("adam")
    lstate = lopt.init(lparams)
    lbatch = {k: torch.from_numpy(v).to(dev) for k, v in syn.lm_batch(
        np.random.default_rng(0), lcfg.vocab, DRY_LM_BATCH, DRY_LM_SEQ).items()}
    lstep = TF.make_train_step(lcfg, lopt)
    m_lp, m_ls, m_lb = on_meta(lparams), on_meta(lopt.init(lparams)), on_meta(lbatch)
    checks["lm_small_train"] = dry_vs_card(
        "lm-small train step (f32)", lambda: lstep(lparams, lstate, lbatch),
        lambda: lstep(m_lp, m_ls, m_lb))
    out["paths"]["dryrun.lm_small_train"] = launch_counts()
    cache = TF.init_decode_cache(lcfg, DRY_LM_BATCH, 2 * DRY_LM_SEQ, torch.float32, device=dev)
    pos = torch.full((), DRY_LM_SEQ, dtype=torch.int32, device=dev)
    tok = lbatch["tokens"][:, 0]
    m_cache, m_pos, m_tok = on_meta(cache), on_meta(pos), on_meta(tok)
    with torch.no_grad():
        checks["lm_small_decode"] = dry_vs_card(
            "lm-small decode step (f32)", lambda: TF.decode_step(lcfg, lparams, cache, tok, pos),
            lambda: TF.decode_step(lcfg, m_lp, m_cache, m_tok, m_pos))
    out["paths"]["dryrun.lm_small_decode"] = launch_counts()
    del lparams, lstate, cache, m_lp, m_ls

    tcfg = launch_train.make_dlrm_100m()
    tparams = R.init_params(tcfg, seed=0, device=dev)
    topt = launch_train.make_optimizer()
    tstate = topt.init(tparams)
    host = syn.recsys_batch(np.random.default_rng(0), tcfg.tables, DRY_BATCH,
                            n_dense=tcfg.n_dense)
    tbatch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    tstep = R.make_train_step(tcfg, topt)
    m_tp, m_ts, m_tb = on_meta(tparams), on_meta(tstate), on_meta(tbatch)
    checks["dlrm_train"] = dry_vs_card(
        "dlrm-100m train step", lambda: tstep(tparams, tstate, tbatch),
        lambda: tstep(m_tp, m_ts, m_tb))
    out["paths"]["dryrun.dlrm_train"] = launch_counts()

    emb = tcfg.embedding()
    fused = emb._fused_rows(emb.sharded, torch.from_numpy(host["indices"]))
    hot_ids, counts_ = np.unique(fused.numpy()[host["mask"]], return_counts=True)
    hot_ids = hot_ids[np.argsort(-counts_, kind="stable")][:DRY_CACHE_SLOTS // 2]
    hcache = make_hash_cache_from_table(emb, tparams["emb"], hot_ids, DRY_CACHE_SLOTS, device=dev)
    m_hcache = dataclasses.replace(hcache, **{f.name: on_meta(getattr(hcache, f.name))
                                              for f in dataclasses.fields(hcache)})
    fbatch = {k: tbatch[k] for k in ("indices", "mask", "dense")}
    m_fb = on_meta(fbatch)
    with torch.no_grad():
        checks["cached_forward"] = dry_vs_card(
            "dlrm-100m cached forward", lambda: R.forward(tcfg, tparams, fbatch, cache=hcache),
            lambda: R.forward(tcfg, m_tp, m_fb, cache=m_hcache))
    out["paths"]["dryrun.cached_forward"] = launch_counts()
    slots = torch.arange(hot_ids.size, dtype=torch.int32, device=dev)
    rows = tparams["emb"]["table"][torch.from_numpy(hot_ids).to(dev).long()]
    values = hcache.rows.clone()
    m_values, m_slots, m_rows = on_meta(values), on_meta(slots), on_meta(rows)
    checks["cache_swap_in"] = dry_vs_card(
        "K4 swap-in of the cache's rows", lambda: HK.scatter_update(values, slots, rows),
        lambda: HK.scatter_update(m_values, m_slots, m_rows))
    out["paths"]["dryrun.cache_swap_in"] = launch_counts()
    M_, L_, k_ = DRY_K5
    scores = torch.randn((M_, L_), dtype=torch.float64, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    m_scores = on_meta(scores)
    checks["k5"] = dry_vs_card("K5 at the miner's shape", lambda: PK.topk_neighbor_select(
        scores, k_), lambda: PK.topk_neighbor_select(m_scores, k_))
    out["paths"]["dryrun.k5"] = launch_counts()
    covered = set().union(*(c["launches"] for c in checks.values()))
    for name in ("embedding_bag", "embedding_bag_masked", "dot_interaction",
                 "embedding_bag_backward", "dot_interaction_backward", "probe_gather_pool",
                 "scatter_update", "topk_neighbor_select", "flash_attention",
                 "flash_attention_f32", "flash_attention_backward",
                 "flash_attention_backward_f32", "flash_decode"):
        if name not in covered:
            raise AssertionError(f"dryrun: no card-vs-meta check launched {name}")
    out["card_vs_meta"] = checks
    del tparams, tstate, m_tp, m_ts, hcache, values, rows
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) stablelm-3b's train step of phase 9i on meta: its bound
    cfg = dataclasses.replace(make_stablelm(), param_dtype=torch.float32)
    opt, _ = lm_common.make_optimizer("adam")
    params = TF.init_params(cfg, device="meta")
    state = opt.init(params)
    batch = {k: torch.empty((LMT_BATCH, LMT_SEQ), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    with HA.Trace() as tr:
        TF.make_train_step(cfg, opt)(params, state, batch)
    terms = HA.analyze(tr)
    busy = lm_train_summary["step_device_busy_ms"]
    if not busy:
        raise AssertionError("dryrun: phase 9i measured no busy time to hold the bound against")
    out["stablelm_train_step"] = {
        "trace_s": time.perf_counter() - t0, "roofline": terms.as_dict(),
        "bound_ms": terms.bound_s * 1e3, "bound_by": terms.dominant,
        "flops_by_class": tr.flops, "kernels": tr.kernels,
        "busy_ms_9i": busy, "share_of_roofline": terms.bound_s * 1e3 / busy,
        "card": out["card"]}
    log(f"[dryrun] stablelm-3b train step {LMT_BATCH} x {LMT_SEQ} (phase 9i's): bound "
        f"{terms.bound_s * 1e3:.3f} ms ({terms.dominant}: compute {terms.compute_s * 1e3:.3f}, "
        f"memory {terms.memory_s * 1e3:.3f}) against 9i's {busy:.3f} ms busy: "
        f"{terms.bound_s * 1e3 / busy:.4f} of the roofline ({out['card']})")
    out["seconds"] = time.perf_counter() - t_phase
    log("[dryrun] " + json.dumps({k: v for k, v in out.items() if k != "paths"}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU present", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.configs.dlrm_flexemr import make_config
    from repro_torch.configs.lm_common import LM_SHAPES, serving_config
    from repro_torch.configs.stablelm_3b import make_config as make_lm_config
    from repro_torch.configs import arctic_480b, llama3_405b, qwen2_72b
    from repro_torch.configs.olmoe_1b_7b import make_config as make_olmoe
    from repro_torch import chaos as CH
    from repro_torch.core.adaptive_cache import AdaptiveCacheController, MemoryModel
    from repro_torch.core.embedding import make_hash_cache_from_table
    from repro_torch.core.sharding import make_fused_tables
    from repro_torch.data import synthetic as syn
    from repro_torch.data.pipeline import BucketBatcher
    from repro_torch.hotcache import kernels as HK
    from repro_torch.hotcache import ref as HREF
    from repro_torch.hotcache import table as T
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import dot_interaction as K2
    from repro_torch.kernels import embedding_bag as K1
    from repro_torch.kernels import flash_attention as K6
    from repro_torch.kernels import flash_decode as K7
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe as MOE
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as TF
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.prefetch import CooccurrenceMiner, PrefetchEngine, PrefetchPolicy
    from repro_torch.prefetch import kernels as PK
    from repro_torch.prefetch import ref as PREF
    from repro_torch.runtime.elastic import reshard_tables
    from repro_torch.runtime.serving import ATTR_STAGES, FlexEMRServer
    from repro_torch.utils import (keystr, tree_flatten_with_path, tree_leaves, tree_size_bytes,
                                   tree_to)

    def require(path: str, counts: dict, names) -> None:
        missing = [n for n in names if counts[n] < 1]
        if missing:
            raise AssertionError(f"{path} did not launch {missing}: {counts}")
        if "embedding_bag" in names and counts["embedding_bag_masked"] != counts["embedding_bag"]:
            raise AssertionError(f"{path} launched K1 outside its masked mode: {counts}")

    dev = torch.device(DEVICE)
    # ---------------------------------------------------------------- device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch: {kind} (count {torch.cuda.device_count()}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmul and cuDNN: f32 products run in full f32")
    # What could still turn TF32 on inside the plain versions' cuBLAS calls
    log(f"[device] TF32 state: matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
        f"float32_matmul_precision {torch.get_float32_matmul_precision()!r}, "
        + ", ".join(f"{v}={os.environ.get(v)!r}" for v in ("TORCH_ALLOW_TF32_CUBLAS_OVERRIDE",
                                                           "NVIDIA_TF32_OVERRIDE")))

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    planted_build, planted_so = start_planted_build(build)  # used in phase 5f
    k6b_planted = start_planted_build(build, K6.NAME_BWD, K6B_PLANT)  # used in phase 9g
    k6_planted = start_planted_build(build, K6.NAME, K6_PLANT)  # used in phase 6
    report = build.build([K1.NAME, K2.NAME, HK.PROBE, HK.SCATTER, PK.NAME, K6.NAME,
                          K6.NAME_BWD, K7.NAME], ptxas_verbose=True)
    log(f"[build] {time.perf_counter() - t0:.2f}s wall for "
        + ", ".join(f"{n} {r['seconds']:.2f}s" for n, r in report.items()))
    spills = []
    for name, r in report.items():  # nvcc -Xptxas -v: registers, spills, warnings
        fn = ""
        for line in r["log"].splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            props = re.search(r"Function properties for (\w+)", line)
            if props:  # the spill line that follows is this function's
                fn = kernel_name(props.group(1))
            if entry:
                fn = kernel_name(entry.group(1))
                log(f"  {name}: {fn}")
            elif "registers" in line or "spill" in line or "C75" in line:
                log(f"  {name}: {line.strip()}")
                if "wgmma" in fn and "spill" in line and not re.search(
                        r"\b0 bytes spill stores, 0 bytes spill loads", line):
                    spills.append(f"{fn}: {line.strip()}")
    if report[K6.NAME_BWD]["log"] and spills:  # the log is empty where the library was built
        raise AssertionError("K6' bf16 spills: " + "; ".join(spills))

    # ------------------------------------------- main-path model and inputs
    cfg = make_config()
    t0 = time.perf_counter()
    params = R.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    table = params["emb"]["table"]
    log(f"[forward] dlrm-flexemr table {tuple(table.shape)} f32 "
        f"({table.numel() * 4 / 1e9:.1f} GB) made on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    host = syn.recsys_batch(rng, cfg.tables, FORWARD_BATCH, n_dense=cfg.n_dense)
    batch = {k: torch.from_numpy(host[k]).to(dev) for k in ("indices", "mask", "dense")}
    emb = cfg.embedding()
    # K1's inputs exactly as DisaggEmbedding.lookup hands them to the kernel
    # (masked mode; a masked slot's id is the padding 0 of its field).
    fused = emb._fused_rows(emb.sharded, batch["indices"])
    ids = fused.reshape(-1).contiguous()
    wts = batch["mask"].reshape(-1).to(torch.float32).contiguous()
    n_bags = FORWARD_BATCH * cfg.num_fields
    nnz = ids.numel() // n_bags
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    # --------------------------------------------------------------- kernels
    log("[kernels] each kernel against its plain version on the card")
    k1_out = K1.embedding_bag(table, ids, wts, n_bags, masked=True)
    k1_err = assert_close(f"K1 embedding_bag masked f32 [{n_bags} bags x {nnz}, "
                          f"D={table.shape[1]}]", k1_out,
                          ref.embedding_bag_ref(table, ids, wts, n_bags, masked=True), 1e-5, 1e-5)
    k1w_err = assert_close("K1 embedding_bag weighted f32 (same bags)",
                           K1.embedding_bag(table, ids, wts, n_bags),
                           ref.embedding_bag_ref(table, ids, wts, n_bags), 1e-5, 1e-5)
    small = torch.empty((1 << 20, 64), dtype=torch.bfloat16, device=dev).normal_(
        0, 0.01, generator=torch.Generator(device=dev).manual_seed(1))
    ids_small = (ids % small.shape[0]).to(torch.int32)
    for masked in (True, False):
        assert_close(f"K1 embedding_bag {'masked' if masked else 'weighted'} bf16 "
                     "[1M-row table, same bags]",
                     K1.embedding_bag(small, ids_small, wts, n_bags, masked=masked),
                     ref.embedding_bag_ref(small, ids_small, wts, n_bags, masked=masked),
                     1e-5, 1e-5)
    # NaN in every row that only zero-weight slots point to: the masked mode
    # reads none of them, the weighted mode gives NaN where its plain version does.
    dead = ~torch.isin(ids_small, ids_small[wts != 0]) & (wts == 0)
    for dt in (torch.float32, torch.bfloat16):
        nan_tab = small.to(dt)
        nan_tab[ids_small[dead].long()] = float("nan")
        got = K1.embedding_bag(nan_tab, ids_small, wts, n_bags, masked=True)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 masked {dtype_name(nan_tab)}: NaN behind w = 0 reached "
                                 "the output")
        assert_close(f"K1 embedding_bag masked {dtype_name(nan_tab)}, NaN in the "
                     f"{int(dead.sum())} zero-weight slots' rows: finite, vs plain", got,
                     ref.embedding_bag_ref(nan_tab, ids_small, wts, n_bags, masked=True),
                     1e-5, 1e-5)
        got = K1.embedding_bag(nan_tab, ids_small, wts, n_bags)
        want = ref.embedding_bag_ref(nan_tab, ids_small, wts, n_bags)
        if not torch.equal(got.isnan(), want.isnan()) or not bool(want.isnan().any()):
            raise AssertionError(f"K1 weighted {dtype_name(nan_tab)}: NaN at other places "
                                 f"than the plain version's ({int(got.isnan().sum())} vs "
                                 f"{int(want.isnan().sum())})")
        fin = ~want.isnan()
        assert_close(f"K1 embedding_bag weighted {dtype_name(nan_tab)}, same table: NaN in "
                     f"the same {int((~fin).sum())} outputs, the rest", got[fin], want[fin],
                     1e-5, 1e-5)
    del small, nan_tab, got, want, fin, dead
    # Edge cases: nnz with and without an unrolled loop, 1003 bags (no
    # multiple of a block's 8, 16 or 32), ids outside [0, V), fractional
    # weights, rows of 17 (element loads) and 256 (two passes of 32 lanes).
    egen = torch.Generator(device=dev).manual_seed(4)
    for nnz_e, width, dt in ((1, 64, torch.float32), (3, 64, torch.float32),
                             (4, 64, torch.float32), (8, 64, torch.float32),
                             (1, 64, torch.bfloat16), (3, 64, torch.bfloat16),
                             (4, 64, torch.bfloat16), (8, 64, torch.bfloat16),
                             (4, 17, torch.float32), (3, 17, torch.bfloat16),
                             (4, 256, torch.float32), (8, 256, torch.bfloat16)):
        V_e, bags_e = 5000, 1003
        tab = torch.randn((V_e, width), device=dev, generator=egen).to(dt)
        ids_e = torch.randint(-50, V_e + 50, (bags_e * nnz_e,), device=dev, generator=egen,
                              dtype=torch.int32)
        w_e = torch.rand(bags_e * nnz_e, device=dev, generator=egen) + 0.5
        w_e[torch.rand(bags_e * nnz_e, device=dev, generator=egen) < 0.5] = 0.0
        for masked in (True, False):
            assert_close(f"K1 embedding_bag {'masked' if masked else 'weighted'} "
                         f"{dtype_name(tab)} nnz {nnz_e} D {width} [{bags_e} bags, ids in "
                         f"[-50, {V_e + 50})]",
                         K1.embedding_bag(tab, ids_e, w_e, bags_e, masked=masked),
                         ref.embedding_bag_ref(tab, ids_e, w_e, bags_e, masked=masked),
                         1e-5, 1e-5)
    del tab, ids_e, w_e
    gen = torch.Generator(device=dev).manual_seed(2)
    x_fwd = torch.randn((FORWARD_BATCH, cfg.num_fields + 1, cfg.embed_dim),
                        device=dev, generator=gen)
    k2_err = assert_close(f"K2 dot_interaction f32 {list(x_fwd.shape)}",
                          K2.dot_interaction(x_fwd), ref.dot_interaction_ref(x_fwd), 1e-4, 1e-4)
    x_bf = x_fwd.to(torch.bfloat16)
    assert_close(f"K2 dot_interaction bf16 {list(x_bf.shape)}",
                 K2.dot_interaction(x_bf), ref.dot_interaction_ref(x_bf), 1e-4, 1e-4)
    k2_buckets = {}  # the serve buckets' [B, 17, 64] inputs, checked here, timed below
    for bucket in SERVE_BUCKETS:
        x_srv = torch.randn((bucket, SERVE_FIELDS, cfg.embed_dim), device=dev, generator=gen)
        for x_ in (x_srv, x_srv.to(torch.bfloat16)):
            assert_close(f"K2 dot_interaction {dtype_name(x_)} {list(x_.shape)} (serve bucket)",
                         K2.dot_interaction(x_), ref.dot_interaction_ref(x_), 1e-4, 1e-4)
        k2_buckets[bucket] = x_srv
    x_big = torch.randn((3, 40, 512), device=dev, generator=gen)
    for x_ in (x_big, x_big.to(torch.bfloat16)):
        assert_close(f"K2 dot_interaction {dtype_name(x_)} {list(x_.shape)} (one sample "
                     "> 48 KB shared)", K2.dot_interaction(x_), ref.dot_interaction_ref(x_),
                     1e-4, 1e-4)

    D = table.shape[1]
    live = ids[wts != 0]

    def k1_bytes(rows):
        return (torch.unique(rows).numel() * D * 4  # rows the bags need, once
                + ids.numel() * 8  # ids + weights
                + n_bags * D * 4)  # pooled output

    k1_bound, k1_by = bound(k1_bytes(live), 2 * live.numel() * D)  # masked: live slots
    k1w_bound = bound(k1_bytes(ids), 2 * ids.numel() * D)  # weighted: every slot
    B, Fx, Dx = x_fwd.shape
    k2_bound, k2_by = bound(B * Fx * Dx * 4 + B * Fx * Fx * 4, 2 * B * Fx * Fx * Dx)
    ids_2d = ids.view(n_bags, nnz)
    k1_lib_ms = cuda_ms(lambda: F.embedding_bag(ids_2d, table, mode="sum",
                                                per_sample_weights=wts.view(n_bags, nnz)),
                        flush)
    timings = {
        "embedding_bag": (
            cuda_ms(lambda: K1.embedding_bag(table, ids, wts, n_bags, masked=True), flush),
            cuda_ms(lambda: ref.embedding_bag_ref(table, ids, wts, n_bags, masked=True), flush),
            k1_lib_ms,
        ),
        "dot_interaction": (
            cuda_ms(lambda: K2.dot_interaction(x_fwd), flush),
            cuda_ms(lambda: ref.dot_interaction_ref(x_fwd), flush),
            cuda_ms(lambda: torch.bmm(x_fwd, x_fwd.transpose(1, 2)), flush),
        ),
    }
    bounds = {"embedding_bag": (k1_bound, k1_by), "dot_interaction": (k2_bound, k2_by)}
    errs = {"embedding_bag": k1_err, "dot_interaction": k2_err}
    # K1's weighted mode (the Pallas kernel's contract), beside the masked one
    # that the main path runs: its own bound reads every slot's row.
    k1_weighted = {
        "ms": cuda_ms(lambda: K1.embedding_bag(table, ids, wts, n_bags), flush),
        "plain_ms": cuda_ms(lambda: ref.embedding_bag_ref(table, ids, wts, n_bags), flush),
        "library_ms": k1_lib_ms, "bound_ms": k1w_bound[0], "bound_by": k1w_bound[1],
        "max_abs_err": k1w_err,
    }
    # The same launches with the L2 flushed by a read (no dirty lines left
    # for the kernel to write back), beside the write-flushed medians.
    k1_weighted["ms_read_flush"] = cuda_ms(
        lambda: K1.embedding_bag(table, ids, wts, n_bags), flush, read_flush=True)
    read_flushed = {"embedding_bag": cuda_ms(
        lambda: K1.embedding_bag(table, ids, wts, n_bags, masked=True), flush, read_flush=True)}
    log(f"  bounds: K1 masked moves {k1_bytes(live) / 1e6:.2f} MB ({torch.unique(live).numel()} "
        f"unique live rows of {live.numel()} live slots), weighted {k1_bytes(ids) / 1e6:.2f} MB "
        f"({torch.unique(ids).numel()} unique rows of {ids.numel()} slots); K2 moves "
        f"{(B * Fx * Dx + B * Fx * Fx) * 4 / 1e6:.2f} MB")
    log(f"  K1 weighted: kernel {k1_weighted['ms']:.4f} ms, plain {k1_weighted['plain_ms']:.4f} "
        f"ms, F.embedding_bag {k1_lib_ms:.4f} ms, bound {k1w_bound[0]:.6f} ms (the kernel "
        f"reaches {k1w_bound[0] / k1_weighted['ms']:.1%} of it); L2 flushed by a read "
        f"{k1_weighted['ms_read_flush']:.4f} ms")
    k2_rows = []  # K2 at the serve buckets, beside torch.bmm, in turns
    for bucket, x_ in k2_buckets.items():
        Bb, Fb, Db = x_.shape
        kern = lambda: K2.dot_interaction(x_)  # noqa: E731
        lib = lambda: torch.bmm(x_, x_.transpose(1, 2))  # noqa: E731
        t_kern, t_lib = [], []
        for fn, times in ((kern, t_kern), (lib, t_lib), (lib, t_lib), (kern, t_kern)):
            times.append(cuda_ms(fn, flush))
        k2_rows.append({"case": f"K2 f32 [{Bb}, {Fb}, {Db}] (serve bucket)",
                        "ms": statistics.median(t_kern), "library_ms": statistics.median(t_lib),
                        "bound_ms": bound(Bb * Fb * Db * 4 + Bb * Fb * Fb * 4,
                                          2 * Bb * Fb * Fb * Db)[0]})
    log("[kernels] K2 at the serve buckets: " + json.dumps(k2_rows))
    del x_fwd, x_bf, x_srv, x_big, k1_out, k2_buckets

    # ---- hot set of the cached forward: fused ids of warm-up batches by count
    warm = np.random.default_rng(1)
    warm_ids = []
    for _ in range(WARMUP_BATCHES):
        wb = syn.recsys_batch(warm, cfg.tables, FORWARD_BATCH, n_dense=cfg.n_dense)
        wf = emb._fused_rows(emb.sharded, torch.from_numpy(wb["indices"])).numpy()
        warm_ids.append(wf[wb["mask"]])
    uniq, counts = np.unique(np.concatenate(warm_ids), return_counts=True)
    hot_ids = uniq[np.argsort(-counts, kind="stable")].astype(np.int32)
    log(f"  hot set: {len(hot_ids)} unique fused ids in {WARMUP_BATCHES} warm-up "
        f"batches of {FORWARD_BATCH}; cache of {HOT_SLOTS} slots, P = {MAX_PROBES}")

    # ---- K4 at the cache build's writes (the swap-in of make_hash_cache_from_table)
    C = HOT_SLOTS
    h = hot_ids[:C]
    keys_np, freq_np, _, w_slots, w_idx = T.insert_plan(
        np.full((C,), T.EMPTY_KEY, np.int32), np.zeros((C,), np.int32), h,
        np.arange(len(h), 0, -1, dtype=np.int32), 1, MAX_PROBES)
    hot_rows = emb.gather_rows(params["emb"], torch.from_numpy(h).to(dev))
    slots_t = torch.from_numpy(w_slots).to(dev)
    rows_w = hot_rows[torch.from_numpy(w_idx).to(dev)]
    values = torch.zeros((C, D), dtype=torch.float32, device=dev)
    k4_err = assert_equal(
        f"K4 scatter_update f32 [{len(w_slots)} writes into {C} x {D}] (cache build)",
        HK.scatter_update(values, slots_t, rows_w),
        HREF.scatter_update_ref(torch.zeros_like(values), slots_t, rows_w))
    assert_equal("K4 scatter_update f32 rows -> bf16 values (cache build)",
                 HK.scatter_update(torch.zeros((C, D), dtype=torch.bfloat16, device=dev),
                                   slots_t, rows_w),
                 HREF.scatter_update_ref(torch.zeros((C, D), dtype=torch.bfloat16,
                                                     device=dev), slots_t, rows_w))
    rep_slots = torch.randint(0, 4096, (65536,), device=dev, generator=gen,
                              dtype=torch.int32)  # every slot written ~16 times
    rep_rows = torch.randn((65536, D), device=dev, generator=gen)
    for vdt in (torch.float32, torch.bfloat16):
        base = torch.randn((8192, D), device=dev, generator=gen).to(vdt)
        assert_equal(f"K4 scatter_update f32 rows -> {str(vdt)[6:]} values, 65536 "
                     "writes to 4096 repeated slots (last write wins)",
                     HK.scatter_update(base.clone(), rep_slots, rep_rows),
                     HREF.scatter_update_ref(base.clone(), rep_slots, rep_rows))
    del rep_rows
    # Slots outside [0, C) mixed in, one write, bf16 rows, and a width of 17
    # (rows of 68 or 34 bytes: the element-wise copy).
    mixed = torch.randint(-64, 8192 + 64, (4096,), device=dev, generator=gen,
                          dtype=torch.int32)
    one = torch.tensor([5000], dtype=torch.int32, device=dev)
    f32_, bf16_ = torch.float32, torch.bfloat16
    for sl, vdt, rdt, width in ((mixed, f32_, f32_, D), (mixed, bf16_, bf16_, D),
                                (mixed, f32_, bf16_, D), (mixed, bf16_, f32_, D),
                                (mixed, f32_, f32_, 17), (mixed, bf16_, f32_, 17),
                                (mixed, f32_, bf16_, 17), (mixed, bf16_, bf16_, 17),
                                (one, f32_, f32_, D), (one, bf16_, f32_, 17)):
        base = torch.randn((8192, width), device=dev, generator=gen).to(vdt)
        rows_x = torch.randn((sl.shape[0], width), device=dev, generator=gen).to(rdt)
        what = "one write (K = 1)" if sl is one else "4096 writes, slots outside [0, C) mixed in"
        assert_equal(f"K4 scatter_update {dtype_name(rows_x)} rows -> {dtype_name(base)} "
                     f"values, D = {width}, 8192 slots, {what}",
                     HK.scatter_update(base.clone(), sl, rows_x),
                     HREF.scatter_update_ref(base.clone(), sl, rows_x))
    del mixed, one, base, rows_x
    check_cache = T.HashCacheState(keys=torch.from_numpy(keys_np).to(dev), rows=values,
                                   freq=torch.from_numpy(freq_np).to(dev))
    occupied = int(check_cache.occupancy())

    # ---- K3 on the forward batch's sharded-field query over that cache
    msk = batch["mask"].reshape(-1)
    query = torch.where(msk, fused.reshape(-1), T.EMPTY_KEY).contiguous()
    k3_out = HK.probe_gather_pool(check_cache.keys, check_cache.rows, query, wts,
                                  n_bags, MAX_PROBES)
    k3_want = HREF.probe_gather_pool_ref(check_cache.keys, check_cache.rows, query,
                                         wts, n_bags, MAX_PROBES)
    assert_equal(f"K3 probe_gather_pool miss [{n_bags} bags x {nnz}, C = {C}]",
                 k3_out[1], k3_want[1])
    k3_err = assert_close(f"K3 probe_gather_pool pooled f32 [{n_bags}, {D}]",
                          k3_out[0], k3_want[0], 1e-5, 1e-5)
    rows_bf = check_cache.rows.to(torch.bfloat16)
    got_bf = HK.probe_gather_pool(check_cache.keys, rows_bf, query, wts, n_bags, MAX_PROBES)
    want_bf = HREF.probe_gather_pool_ref(check_cache.keys, rows_bf, query, wts, n_bags,
                                         MAX_PROBES)
    assert_equal("K3 probe_gather_pool miss (bf16 rows)", got_bf[1], want_bf[1])
    assert_close("K3 probe_gather_pool pooled (bf16 rows)", got_bf[0], want_bf[0],
                 1e-5, 1e-5)
    del rows_bf, got_bf, want_bf
    # Edge cases: nnz 1, 3, 4, 8; 1003 bags; caches of 1 and 4 slots (the
    # window repeats slots) and of 1024 (some windows wrap past C - 1); ids
    # resident, cold, negative, past every fused row (2^30 and up) and
    # EMPTY_KEY; fractional weights; rows of 17 (element loads).
    kgen = np.random.default_rng(5)
    for C_e, nnz_e, width, dt in ((1024, 1, 64, torch.float32), (1024, 3, 64, torch.float32),
                                  (1024, 4, 64, torch.float32), (1024, 8, 64, torch.float32),
                                  (1024, 4, 64, torch.bfloat16), (1024, 8, 64, torch.bfloat16),
                                  (4, 3, 64, torch.float32), (1, 4, 64, torch.bfloat16),
                                  (1024, 4, 17, torch.float32), (1024, 3, 17, torch.bfloat16)):
        bags_e, n_e = 1003, 1003 * nnz_e
        res = kgen.choice(1 << 20, max(1, int(C_e * 0.6)), replace=False).astype(np.int32)
        keys_e = T.insert_plan(np.full((C_e,), T.EMPTY_KEY, np.int32),
                               np.zeros((C_e,), np.int32), res,
                               np.ones(len(res), np.int32), 1, MAX_PROBES)[0]
        held = keys_e[keys_e != T.EMPTY_KEY]
        pick = kgen.integers(0, 5, n_e)
        q_np = np.select([pick == 0, pick == 1, pick == 2, pick == 3],
                         [kgen.choice(held, n_e), kgen.integers(1 << 20, 1 << 30, n_e),
                          -kgen.integers(1, 1 << 30, n_e),
                          kgen.integers(1 << 30, (1 << 31) - 1, n_e)],
                         T.EMPTY_KEY).astype(np.int32)
        q_e = torch.from_numpy(q_np).to(dev)
        w_e = torch.from_numpy(kgen.random(n_e).astype(np.float32) + 0.5).to(dev)
        keys_t = torch.from_numpy(keys_e).to(dev)
        vals_e = torch.randn((C_e, width), device=dev, generator=gen).to(dt)
        got = HK.probe_gather_pool(keys_t, vals_e, q_e, w_e, bags_e, MAX_PROBES)
        want = HREF.probe_gather_pool_ref(keys_t, vals_e, q_e, w_e, bags_e, MAX_PROBES)
        what = (f"{dtype_name(vals_e)} C {C_e} nnz {nnz_e} D {width} [{bags_e} bags, "
                f"{int((~want[1]).sum())} hits of {n_e}]")
        assert_equal(f"K3 probe_gather_pool miss {what}", got[1], want[1])
        assert_close(f"K3 probe_gather_pool pooled {what}", got[0], want[0], 1e-5, 1e-5)
    del keys_t, vals_e, q_e, w_e, got, want
    hit = ~k3_out[1]
    n_live = int((query != T.EMPTY_KEY).sum())
    n_hits = int(hit.sum())
    uniq_hit_rows = torch.unique(query[hit]).numel()
    k3_bytes = (ids.numel() * 8  # ids + weights
                + n_live * 4  # one key per live id
                + uniq_hit_rows * D * 4  # the hit rows, once
                + n_bags * D * 4 + ids.numel())  # pooled output + miss bytes
    bounds["probe_gather_pool"] = bound(k3_bytes, 2 * n_hits * D)
    errs["probe_gather_pool"] = k3_err
    log(f"  K3 query: {n_live} live ids, {n_hits} hits ({uniq_hit_rows} unique rows) "
        f"in a cache holding {occupied} of {len(h)} hot ids; moves {k3_bytes / 1e6:.2f} MB")

    # ---- K5: the miner's [M, 16] f64 lists and the TPU-shaped [4096, 128] f32
    def tied_scores(m, width, dtype):
        """Scores on a grid of 1/4 (ties), with -inf, NaN, -0.0 and +0.0
        scattered in, an all-NaN row and an all -inf last row (it walks its
        columns in order)."""
        s = torch.round(torch.randn((m, width), device=dev, generator=gen) * 4) / 4
        u = torch.rand((m, width), device=dev, generator=gen)
        s[u < 0.2] = float("-inf")
        s[(u >= 0.2) & (u < 0.3)] = float("nan")
        s[(u >= 0.3) & (u < 0.4)] = -0.0
        s[(u >= 0.4) & (u < 0.5)] = 0.0
        s[-2] = float("nan")
        s[-1] = float("-inf")
        return s.to(dtype).contiguous()

    k5_cases = {}
    for m, width, k in ((MINER_ROWS, 16, 12), (2048, 16, 12), (4096, 128, 32)):
        for dt in (torch.float32, torch.float64):
            s = tied_scores(m, width, dt)
            gv, gi = PK.topk_neighbor_select(s, k)
            wv, wi = PREF.topk_neighbor_select_ref(s, k)
            name = f"K5 topk_neighbor_select {str(dt)[6:]} [{m}, {width}] k={k}"
            assert_bits(f"{name} values", gv, wv)
            assert_equal(f"{name} indices", gi, wi)
            k5_cases[(m, width, dt)] = (s, k)
    # Edges of the kernel's row plan: one column, a group of 16 lanes and one
    # column past it, a whole warp and one column past it (a warp a row), and
    # 1003 rows (no multiple of a block's rows); k = 1 and k = L.
    for width in K5_EDGE_WIDTHS:
        for k in sorted({1, width}):
            for dt in (torch.float32, torch.float64):
                s = tied_scores(1003, width, dt)
                gv, gi = PK.topk_neighbor_select(s, k)
                wv, wi = PREF.topk_neighbor_select_ref(s, k)
                name = f"K5 topk_neighbor_select {str(dt)[6:]} [1003, {width}] k={k}"
                assert_bits(f"{name} values", gv, wv)
                assert_equal(f"{name} indices", gi, wi)
    errs["topk_neighbor_select"] = 0.0
    errs["scatter_update"] = k4_err

    # ---- timings of K3, K4, K5 (plain versions and library calls beside)
    last = torch.full((C,), -1, dtype=torch.int64, device=dev)
    order = torch.arange(len(w_slots), device=dev)
    last.scatter_reduce_(0, slots_t.long(), order, reduce="amax")
    keep = last[slots_t.long()] == order
    slots_u, rows_u = slots_t[keep].long(), rows_w[keep]
    scratch = torch.zeros((C, D), dtype=torch.float32, device=dev)
    bounds["scatter_update"] = bound(int(keep.sum()) * D * 8 + len(w_slots) * 4, 0)
    s_miner, k_miner = k5_cases[(MINER_ROWS, 16, torch.float64)]
    bounds["topk_neighbor_select"] = bound(
        s_miner.numel() * 8 + s_miner.shape[0] * k_miner * 12, 0)
    timings["probe_gather_pool"] = (
        cuda_ms(lambda: HK.probe_gather_pool(check_cache.keys, check_cache.rows, query,
                                             wts, n_bags, MAX_PROBES), flush),
        cuda_ms(lambda: HREF.probe_gather_pool_ref(check_cache.keys, check_cache.rows,
                                                   query, wts, n_bags, MAX_PROBES), flush),
        None,  # no single PyTorch call probes a hash table
    )
    read_flushed["probe_gather_pool"] = cuda_ms(
        lambda: HK.probe_gather_pool(check_cache.keys, check_cache.rows, query, wts, n_bags,
                                     MAX_PROBES), flush, read_flush=True)
    timings["scatter_update"] = (
        cuda_ms(lambda: HK.scatter_update(scratch, slots_t, rows_w), flush),
        cuda_ms(lambda: HREF.scatter_update_ref(scratch, slots_t, rows_w), flush),
        cuda_ms(lambda: scratch.index_copy_(0, slots_u, rows_u), flush),
    )
    timings["topk_neighbor_select"] = (
        cuda_ms(lambda: PK.topk_neighbor_select(s_miner, k_miner), flush),
        cuda_ms(lambda: PREF.topk_neighbor_select_ref(s_miner, k_miner), flush),
        cuda_ms(lambda: torch.topk(s_miner, k_miner, dim=1), flush),
    )
    s_tpu, k_tpu = k5_cases[(4096, 128, torch.float32)]
    k5_tpu = (cuda_ms(lambda: PK.topk_neighbor_select(s_tpu, k_tpu), flush),
              cuda_ms(lambda: PREF.topk_neighbor_select_ref(s_tpu, k_tpu), flush),
              cuda_ms(lambda: torch.topk(s_tpu, k_tpu, dim=1), flush),
              bound(s_tpu.numel() * 4 + s_tpu.shape[0] * k_tpu * 8, 0)[0])
    for name, (ms, plain_ms, lib_ms) in timings.items():
        bms, by = bounds[name]
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        rf = (f"; L2 flushed by a read {read_flushed[name]:.4f} ms"
              if name in read_flushed else "")
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib}, bound {bms:.6f} ms (by {by}; the "
            f"kernel reaches {bms / ms:.1%} of it){rf}")
    log(f"  K4 timed at the cache build: {len(w_slots)} writes, {int(keep.sum())} "
        f"survive; K5 timed at the miner's [{MINER_ROWS}, 16] f64, k={k_miner}")
    log(f"  K5 at [4096, 128] f32 k={k_tpu}: kernel {k5_tpu[0]:.4f} ms, plain "
        f"{k5_tpu[1]:.4f} ms, torch.topk {k5_tpu[2]:.4f} ms, bound {k5_tpu[3]:.6f} ms")
    del scratch, last, order, keep, slots_u, rows_u, k5_cases, s_tpu, k3_out, k3_want
    del check_cache, values, hot_rows, rows_w, slots_t

    # --------------------------------------------------------------- forward
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        scores = R.forward(cfg, params, batch)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_launches = launch_counts()
    require("forward", fwd_launches, ("embedding_bag", "dot_interaction"))
    if scores.shape != (FORWARD_BATCH,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"forward scores not finite [{FORWARD_BATCH}]: {scores.shape}")
    with torch.no_grad():
        pooled_plain = emb.lookup_reference(params["emb"], batch["indices"], batch["mask"])
        pooled = emb.lookup(params["emb"], batch["indices"], batch["mask"])
        dense_cpu = tree_to({k: v for k, v in params.items() if k != "emb"}, "cpu")
        # Plain forward: the plain gather + pool on the card, the dense stage
        # on the CPU, where every wrapper takes its plain version.
        scores_plain = R.dense_forward(cfg, dense_cpu, pooled_plain.cpu(),
                                       batch["dense"].cpu())
    assert_close("forward pooled [2048, 26, 64] vs lookup_reference", pooled, pooled_plain,
                 1e-5, 1e-5)
    assert_close("forward scores [2048] vs plain forward", scores.cpu(), scores_plain,
                 1e-4, 1e-5)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: R.forward(cfg, params, batch), flush)
    log(f"[forward] first call {fwd_s * 1e3:.2f} ms wall, then {fwd_ms:.4f} ms "
        f"device median (L2 cold); launches in the first call {fwd_launches}")

    # -------------------------------------------------------- cached forward
    host2 = syn.recsys_batch(np.random.default_rng(2), cfg.tables, FORWARD_BATCH,
                             n_dense=cfg.n_dense)
    batch2 = {k: torch.from_numpy(host2[k]).to(dev) for k in ("indices", "mask", "dense")}
    with torch.no_grad():
        scores2 = R.forward(cfg, params, batch2)  # uncached, outside the window
    fused_b = emb._fused_rows(emb.sharded, batch["indices"])[batch["mask"]].cpu().numpy()
    ref_ids, ref_counts = np.unique(fused_b, return_counts=True)

    def hit_rate(cache, b) -> float:
        f = emb._fused_rows(emb.sharded, b["indices"])
        q = torch.where(b["mask"], f, T.EMPTY_KEY)
        return float(T.cache_lookup(cache, q, MAX_PROBES)[1].sum()) / float(b["mask"].sum())

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = make_hash_cache_from_table(emb, params["emb"], hot_ids, HOT_SLOTS,
                                       max_probes=MAX_PROBES, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the state as built, which sharded_forward's build from the sharded table
    # must equal (cache_insert below returns a new state and leaves this one)
    built = cache
    with torch.no_grad():
        scores_c = R.forward(cfg, params, batch, cache=cache)
    hit1 = hit_rate(cache, batch)
    t0 = time.perf_counter()
    ref_rows = emb.gather_rows(params["emb"], torch.from_numpy(ref_ids.astype(np.int32)).to(dev))
    cache, admitted = T.cache_insert(cache, ref_ids, ref_rows, ref_counts, 2, MAX_PROBES)
    cache = T.decay_freq(cache, 0.5)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    with torch.no_grad():
        scores_c2 = R.forward(cfg, params, batch2, cache=cache)
    torch.cuda.synchronize()
    hit2 = hit_rate(cache, batch2)
    cached_launches = launch_counts()
    require("cached_forward", cached_launches,
            ("probe_gather_pool", "scatter_update", "embedding_bag", "dot_interaction"))
    for name, got in (("scores", scores_c), ("scores after refresh", scores_c2)):
        if got.shape != (FORWARD_BATCH,) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"cached forward {name} not finite: {got.shape}")
    assert_close("cached forward scores [2048] vs uncached forward", scores_c, scores,
                 1e-4, 1e-5)
    assert_close("cached forward scores after refresh vs uncached forward", scores_c2,
                 scores2, 1e-4, 1e-5)
    with torch.no_grad():
        pooled_c = emb.lookup(params["emb"], batch["indices"], batch["mask"], cache=cache)
    assert_close("cached lookup pooled [2048, 26, 64] vs lookup_reference", pooled_c,
                 pooled_plain, 1e-5, 1e-5)
    # Cached and uncached forward timed in turns (plain, cached, cached,
    # plain, ...) in this one call, so clocks and allocator state are shared.
    turns = {False: [], True: []}
    with torch.no_grad():
        for i in range(FORWARD_TURNS):
            for cached in ((False, True) if i % 2 == 0 else (True, False)):
                c = cache if cached else None
                turns[cached].append(
                    cuda_ms(lambda: R.forward(cfg, params, batch, cache=c), flush))
    with torch.no_grad():  # device work of each, one profiled window of 3 calls
        profiles = {"uncached": device_busy(lambda: R.forward(cfg, params, batch), 3),
                    "cached": device_busy(lambda: R.forward(cfg, params, batch, cache=cache), 3)}
    log("[cached_forward] " + json.dumps({
        "cache_slots": HOT_SLOTS, "occupancy": int(cache.occupancy()),
        "build_seconds": build_s, "refresh_seconds": refresh_s,
        "refresh_admitted": int(admitted.sum()), "refresh_candidates": len(ref_ids),
        "hit_rate_first": hit1, "hit_rate_after_refresh": hit2,
        "cached_forward_ms": statistics.median(turns[True]),
        "uncached_forward_ms": statistics.median(turns[False]),
        "cached_forward_ms_turns": turns[True], "uncached_forward_ms_turns": turns[False],
        "launches": cached_launches, "profiles": profiles,
    }))
    # -------------------------------------------- sharded_forward, sharded_train
    # Both phases run on SHARDED_RANKS processes of this one card, spawned
    # once, over gloo (NCCL refuses two ranks on one GPU): collectives stage
    # CUDA tensors through host memory, so their wall times are no
    # interconnect's.  The ranks read phase 4's table, batch, cache and
    # outputs and the one-device run's states below through CUDA IPC: the
    # 38.4 GB table is held once.  sharded_train's one-device reference
    # first: dlrm-100m, 3 steps on the card, the state after step 1 saved.
    t_sh = time.perf_counter()
    shcfg = launch_train.make_dlrm_100m()
    sh_p0 = R.init_params(shcfg, seed=0, device=dev)
    sh_opt = launch_train.make_optimizer()
    sh_batches = [{k: torch.from_numpy(v).to(dev) for k, v in syn.recsys_batch(
        np.random.default_rng(i), shcfg.tables, TRAIN_BATCH, n_dense=shcfg.n_dense).items()}
        for i in range(SHARDED_TRAIN_STEPS)]
    sh_ck = ROOT / "build" / "chip_smoke_sharded_ckpt"
    shutil.rmtree(sh_ck, ignore_errors=True)
    sh_step = R.make_train_step(shcfg, sh_opt)
    sh_p, sh_s = sh_p0, sh_opt.init(sh_p0)
    sh_losses = []
    for i, b in enumerate(sh_batches):
        sh_p, sh_s, m = sh_step(sh_p, sh_s, b)
        sh_losses.append(float(m["loss"]))
        if i == 0:
            sh_p1s1 = (sh_p, sh_s)
            CheckpointManager(sh_ck).save(1, sh_p1s1, blocking=True)
    t_spawn, sh_main = time.time(), {"one_device_reference_s": time.perf_counter() - t_sh}
    sh_out = M.spawn(sharded_rank, SHARDED_RANKS, (
        {"table": table, "dense": {k: v for k, v in params.items() if k != "emb"},
         "batch": batch, "cache": (cache.keys, cache.rows, cache.freq),
         "pooled": pooled, "scores": scores,
         "hot_ids": torch.from_numpy(hot_ids).to(dev),  # a handle: big pickles block the spawn
         "built_cache": (built.keys, built.rows, built.freq)},
        {"params0": sh_p0, "p1s1": sh_p1s1, "p3s3": (sh_p, sh_s), "batches": sh_batches,
         "ckpt": str(sh_ck)}), timeout=SHARDED_TIMEOUT_S)
    shutil.rmtree(sh_ck, ignore_errors=True)
    # seconds from the spawn to each rank's start and to the ends of its parts
    sh_stamps = [{k: v - t_spawn for k, v in r["stamps"].items()} for r in sh_out]
    sh_main["spawn_s"] = time.time() - t_spawn

    def summed(phase: str, key: str) -> dict:
        """Launch counts of every rank's runs, summed."""
        total: dict = {}
        for r in sh_out:
            for run in r[phase].values():
                for k, v in run[key].items():
                    total[k] = total.get(k, 0) + v
        return total

    for r, res in enumerate(sh_out):
        require(f"sharded_forward rank {r} cache build", res["cache_build"]["launches"],
                ("scatter_update",))
        for name, mode, _, cached in SHARDED_FWD_CASES:
            # the baseline gathers raw rows by indexing: no K1 on its path
            need = (("dot_interaction",) + (("embedding_bag",) if mode != "baseline" else ())
                    + (("probe_gather_pool",) if cached else ()))
            require(f"sharded_forward rank {r} {name}", res["forward"][name]["launches"], need)
        for layout, run in res["train"].items():
            require(f"sharded_train rank {r} {layout}", run["launches"],
                    ("embedding_bag", "embedding_bag_backward", "dot_interaction",
                     "dot_interaction_backward"))
        fb = {n: res["forward"][n]["bytes"] for n, _, _, _ in SHARDED_FWD_CASES}
        nnz_pad = cfg.max_nnz
        if fb["baseline"]["all_reduce"] != nnz_pad * fb["hierarchical"]["all_reduce"]:
            raise AssertionError(f"rank {r}: baseline bytes {fb['baseline']} are not "
                                 f"{nnz_pad} x hierarchical's {fb['hierarchical']}")
        g = SHARDED_FWD_MESH[1]
        ring = 2 * FORWARD_BATCH * cfg.num_fields * cfg.embed_dim * 4 * (g - 1) / g
        if fb["hierarchical"] != {"all_reduce": ring} \
                or fb["hierarchical_chunks2"] != fb["hierarchical"]:
            raise AssertionError(f"rank {r}: hierarchical bytes {fb['hierarchical']}, "
                                 f"{fb['hierarchical_chunks2']} != the ring model's {ring}")
    sh_fwd_launches, sh_train_launches = summed("forward", "launches"), summed("train",
                                                                                "launches")
    for r in sh_out:
        sh_fwd_launches["scatter_update"] += r["cache_build"]["launches"]["scatter_update"]
    # the hierarchical lookup at one rank over NCCL: bit-equal to one device
    t_nccl = time.perf_counter()
    nccl_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl_"))
    dist.init_process_group("nccl", init_method=f"file://{nccl_dir / 'store'}",
                            world_size=1, rank=0)
    try:
        emb1 = cfg.embedding(1)
        with torch.no_grad():
            nccl_pooled = emb1.lookup(params["emb"], batch["indices"], batch["mask"],
                                      mesh=M.make_debug_mesh(1, 1))
            one_pooled = emb1.lookup(params["emb"], batch["indices"], batch["mask"])
        torch.cuda.synchronize()
        assert_equal("[sharded_forward] hierarchical lookup at one NCCL rank vs one-device "
                     "lookup", nccl_pooled, one_pooled)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(nccl_dir, ignore_errors=True)
    sh_main["nccl_check_s"] = time.perf_counter() - t_nccl
    sh_seconds = time.perf_counter() - t_sh
    log("[sharded_forward] " + json.dumps({
        "config": cfg.name, "batch": FORWARD_BATCH, "mesh": {"data": SHARDED_FWD_MESH[0],
                                                            "model": SHARDED_FWD_MESH[1]},
        "backend": "gloo, CUDA tensors staged through host memory (walls: no interconnect)",
        "cases": {name: {
            "bytes_per_rank": sh_out[0]["forward"][name]["bytes"],
            "max_abs_err": [r["forward"][name]["max_abs_err"] for r in sh_out],
            "launches_per_rank": [{k: v for k, v in r["forward"][name]["launches"].items() if v}
                                  for r in sh_out],
            "lookup_wall_s_per_rank": [r["forward"][name]["lookup_wall_s"] for r in sh_out],
            "forward_wall_s_per_rank": [r["forward"][name]["forward_wall_s"] for r in sh_out],
        } for name, _, _, _ in SHARDED_FWD_CASES},
        "baseline_over_hierarchical_bytes": sh_out[0]["forward"]["baseline"]["bytes"][
            "all_reduce"] / sh_out[0]["forward"]["hierarchical"]["bytes"]["all_reduce"],
        "nccl_one_rank_bit_equal": True, "sharded_cache_build_bit_equal": True,
        "cache_build_launches_per_rank": [{k: v for k, v in r["cache_build"]["launches"].items()
                                           if v} for r in sh_out],
        "launches": sh_fwd_launches,
    }))
    log("[sharded_train] " + json.dumps({
        "config": shcfg.name, "global_batch": TRAIN_BATCH, "steps": SHARDED_TRAIN_STEPS,
        "mesh": {"data": SHARDED_TRAIN_MESH[0], "model": SHARDED_TRAIN_MESH[1]},
        "one_device_losses": sh_losses,
        "layouts": {layout: {
            "losses_per_rank": [r["train"][layout]["losses"] for r in sh_out],
            "max_abs_err_per_rank": [r["train"][layout]["max_abs_err"] for r in sh_out],
            "steps_wall_s_per_rank": [r["train"][layout]["steps_wall_s"] for r in sh_out],
            "restored_checkpoint_bit_equal": all(r["train"][layout]["continued_bit_equal"]
                                                 for r in sh_out),
            "launches_per_rank": [{k: v for k, v in r["train"][layout]["launches"].items() if v}
                                  for r in sh_out],
        } for layout in sh_out[0]["train"]},
        "launches": sh_train_launches, "phases_seconds": sh_seconds,
        "seconds_after_spawn_per_rank": sh_stamps, "main_seconds": sh_main,
    }))
    del sh_p0, sh_p1s1, sh_p, sh_s, sh_batches, sh_out, nccl_pooled, one_pooled, built
    del params, table, batch, batch2, fused, ids, wts, ids_2d, live, pooled, pooled_plain
    del scores, scores2, scores_c, scores_c2, pooled_c, cache, ref_rows, query
    del flush
    torch.cuda.empty_cache()
    log(f"[sharded] card memory after the phases: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")

    # ----------------------------------------------------------------- serve
    args = launch_serve.parse_args(["--requests", str(SERVE_REQUESTS)])
    reset_counts()
    out = launch_serve.run(args)
    srv_launches = launch_counts()
    if not out["requests"] == out["submitted"] == SERVE_REQUESTS:
        raise AssertionError(f"served {out['requests']} of {out['submitted']} "
                             f"(wanted {SERVE_REQUESTS})")
    if out["nonfinite_scores"]:
        raise AssertionError(f"{out['nonfinite_scores']} non-finite serve scores")
    if srv_launches["dot_interaction"] < out["batches"]:
        raise AssertionError(f"K2 launched {srv_launches['dot_interaction']} times "
                             f"for {out['batches']} batches")
    log("[serve] " + json.dumps({
        "device": out["device"], "requests": out["requests"], "batches": out["batches"],
        "throughput_rps": out["throughput_rps"], "p50_latency_ms": out["p50_latency_ms"],
        "p99_latency_ms": out["p99_latency_ms"], "dense_seconds": out["dense_seconds"],
        "dense_ms_per_batch": 1e3 * out["dense_seconds"] / out["batches"],
        "lookup_seconds": out["lookup_seconds"], "hit_rate": out["hit_rate"],
        "attr_mean_ms": {k: 1e3 * out["attr"][k]["mean"] for k in ATTR_STAGES},
        "launches": srv_launches,
    }))

    # -------------------------------------------------------- serve_prefetch
    scfg = launch_serve.make_serving_dlrm(1.0)
    sparams = R.init_params(scfg, 0, device=dev)
    # launch.serve.run's controller, with a row cap below the traffic's
    # working set: with its default 65,536 rows every co-occurring partner
    # of a newly planned row is already resident, and nothing is prefetched.
    controller = AdaptiveCacheController(
        scfg.tables, scfg.embed_dim,
        MemoryModel(fixed_bytes=2 << 28, bytes_per_sample=1 << 14, hbm_bytes=1 << 30),
        max_rows=PREFETCH_CACHE_ROWS, field_replication=False)
    engine = PrefetchEngine(
        CooccurrenceMiner(list_len=16, max_rows=16_384, decay=0.99, device=dev),
        PrefetchPolicy(k_neighbors=12, byte_budget=1 << 18, min_score=1.0))
    server = FlexEMRServer(scfg, sparams, make_fused_tables(scfg.tables, scfg.embed_dim, 8),
                           controller=controller, prefetcher=engine,
                           cache_refresh_every=PREFETCH_REFRESH_EVERY,
                           registry=MetricsRegistry(), device=dev)
    wl = syn.CooccurrenceWorkload(scfg.tables, batch=1, alpha=1.1, cooccur_frac=0.8,
                                  pool_size=32, n_dense=scfg.n_dense, seed=0)
    reqs = []
    for _ in range(SERVE_REQUESTS):
        b = wl.next_batch()
        reqs.append({"indices": b["indices"][0], "mask": b["mask"][0],
                     "dense": b["dense"][0]})
    nonfinite = 0
    reset_counts()
    try:
        t0 = time.perf_counter()
        for i in range(0, SERVE_REQUESTS, PREFETCH_BURST):
            for r in reqs[i:i + PREFETCH_BURST]:
                server.submit(r)
            while (res := server.step()) is not None:
                nonfinite += int((~np.isfinite(res["scores"])).sum())
        while server.metrics.requests < SERVE_REQUESTS:
            if (res := server.step()) is not None:
                nonfinite += int((~np.isfinite(res["scores"])).sum())
        torch.cuda.synchronize()
        pf_wall = time.perf_counter() - t0
        pf_launches = launch_counts()
        pf = server.metrics.summary()
    finally:
        server.close()
    if pf["requests"] != SERVE_REQUESTS:
        raise AssertionError(f"serve_prefetch retired {pf['requests']} of {SERVE_REQUESTS}")
    if nonfinite:
        raise AssertionError(f"{nonfinite} non-finite serve_prefetch scores")
    if pf["prefetch_issued"] <= 0:
        raise AssertionError(f"serve_prefetch prefetched nothing: {pf}")
    require("serve_prefetch", pf_launches, ("topk_neighbor_select", "dot_interaction"))
    if pf_launches["dot_interaction"] < pf["batches"]:
        raise AssertionError(f"K2 launched {pf_launches['dot_interaction']} times "
                             f"for {pf['batches']} batches")
    log("[serve_prefetch] " + json.dumps({
        "device": str(server.device), "requests": pf["requests"], "batches": pf["batches"],
        "throughput_rps": SERVE_REQUESTS / pf_wall, "p50_latency_ms": pf["p50_latency_ms"],
        "p99_latency_ms": pf["p99_latency_ms"], "hit_rate": pf["hit_rate"],
        "dense_seconds": pf["dense_seconds"], "lookup_seconds": pf["lookup_seconds"],
        **{k: pf[k] for k in ("prefetch_issued", "prefetch_hits", "prefetch_evicted",
                              "bytes_prefetch", "prefetch_useful_rate")},
        "miner_pairs_observed": engine.miner.pairs_observed,
        "prefetch_triggers": engine.stats.triggers, "launches": pf_launches,
    }))

    # ------------------------------------------------------- serve_open_loop
    qps = int(out["throughput_rps"] / 2)  # half of the closed loop's rate above
    args = launch_serve.parse_args(["--arrival", "poisson", "--qps", str(qps),
                                    "--duration", str(OPEN_LOOP_SECONDS)])
    t0 = time.perf_counter()
    reset_counts()
    ol = launch_serve.run(args)
    ol_launches = launch_counts()
    ol_seconds = time.perf_counter() - t0
    lg = ol["loadgen"]
    if ol["requests"] + lg["shed"] != lg["submitted"] or ol["requests"] == 0:
        raise AssertionError(f"serve_open_loop retired {ol['requests']} and shed "
                             f"{lg['shed']} of {lg['submitted']} arrivals")
    if ol["nonfinite_scores"]:
        raise AssertionError(f"{ol['nonfinite_scores']} non-finite serve_open_loop scores")
    if ol_launches["dot_interaction"] < ol["batches"]:
        raise AssertionError(f"K2 launched {ol_launches['dot_interaction']} times "
                             f"for {ol['batches']} batches")
    log("[serve_open_loop] " + json.dumps({
        "device": ol["device"], "qps_arg": qps, "offered_qps": lg["offered_qps"],
        "achieved_qps": lg["achieved_qps"], "arrivals": lg["submitted"],
        "shed": lg["shed"], "requests": ol["requests"], "batches": ol["batches"],
        "p50_latency_ms": ol["p50_latency_ms"], "p99_latency_ms": ol["p99_latency_ms"],
        "submit_lag_mean_ms": 1e3 * lg["submit_lag_mean_s"],
        "submit_lag_max_ms": 1e3 * lg["submit_lag_max_s"], "driver_wall_s": lg["wall_s"],
        "driver_steps": lg["steps"],
        "queue_wait_p50_ms": 1e3 * ol["queue_wait"]["p50"],
        "queue_wait_p99_ms": 1e3 * ol["queue_wait"]["p99"],
        "attr_mean_ms": {k: 1e3 * ol["attr"][k]["mean"] for k in ATTR_STAGES},
        "slo": {k: ol["slo"][k] for k in ("requests", "good_fraction", "breaches",
                                          "throughput_rps", "goodput_rps", "burn_fast",
                                          "burn_slow", "alerting", "alerts_fired")},
        "slo_target_ms": 1e3 * ol["slo"]["objective"]["latency_target_s"],
        "phase_seconds": ol_seconds, "launches": ol_launches,
    }))

    # ----------------------------------------------------------- serve_chaos
    crng = np.random.default_rng(0)
    cb = syn.recsys_batch(crng, scfg.tables, CHAOS_BATCHES * CHAOS_BUCKET,
                          n_dense=scfg.n_dense)
    chaos_reqs = [{"indices": cb["indices"][i], "mask": cb["mask"][i],
                   "dense": cb["dense"][i]} for i in range(len(cb["dense"]))]
    chaos_tables = make_fused_tables(scfg.tables, scfg.embed_dim, CHAOS_SHARDS)
    scenario = CH.FaultSchedule(faults=(  # one fault of each kind
        CH.FaultSpec(CH.FAULT_KILL_ENGINE, at_batch=2, target=1),
        CH.FaultSpec(CH.FAULT_DROP_SHARD, at_batch=3, target=0, duration_batches=2),
        CH.FaultSpec(CH.FAULT_STRAGGLER_STORM, at_batch=4, target=1,
                     duration_batches=2, latency_mult=8.0),
        CH.FaultSpec(CH.FAULT_RESHARD, at_batch=5, target=CHAOS_RESHARD_TO),
    ), seed=0)

    def drive_chaos(schedule):
        """launch.serve's server (depth 2, 4 engines) over one fixed bucket,
        the queue pre-filled, driven by explicit admits and retires: every
        run forms the same batches, so the dense stage's GEMMs see the same
        shapes and their bits can be compared."""
        injector = (None if schedule is None
                    else CH.ChaosInjector(schedule, watchdog_s=CHAOS_WATCHDOG_S))
        server = FlexEMRServer(
            scfg, sparams, chaos_tables,
            controller=AdaptiveCacheController(
                scfg.tables, scfg.embed_dim,
                MemoryModel(fixed_bytes=2 << 28, bytes_per_sample=1 << 14,
                            hbm_bytes=1 << 30),
                max_rows=65536, field_replication=False),
            num_engines=4, pipeline_depth=2,
            batcher=BucketBatcher(buckets=(CHAOS_BUCKET,), max_wait=CHAOS_WAIT_S),
            chaos=injector, registry=MetricsRegistry(), device=dev)
        outs = []
        try:
            for r in chaos_reqs:
                server.submit(r)
            t0 = time.perf_counter()
            admitted = 0
            while True:
                while len(server._pipeline) < server.pipeline_depth \
                        and admitted < CHAOS_BATCHES:
                    if not server._admit_next():
                        raise AssertionError("serve_chaos: a pre-filled poll came back empty")
                    admitted += 1
                if not server._pipeline:
                    break
                outs.append(server._retire_oldest()["scores"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            vlat = np.asarray(server.service.virtual_latencies)
            eng = server.engine_summary()
        finally:
            server.close()
        return outs, injector, wall, vlat, eng

    t0 = time.perf_counter()
    clean, _, clean_wall, _, _ = drive_chaos(None)
    reset_counts()
    faulty, injector, chaos_wall, chaos_vlat, chaos_eng = drive_chaos(scenario)
    chaos_launches = launch_counts()
    again, injector2, _, _, _ = drive_chaos(scenario)
    chaos_seconds = time.perf_counter() - t0
    cs = injector.summary()
    if not len(clean) == len(faulty) == len(again) == CHAOS_BATCHES:
        raise AssertionError(f"serve_chaos retired {len(clean)}, {len(faulty)} and "
                             f"{len(again)} batches (wanted {CHAOS_BATCHES})")
    for i, (a, b) in enumerate(zip(clean, faulty)):
        if not (a.shape == b.shape and a.dtype == b.dtype == np.float32
                and np.array_equal(a.view(np.int32), b.view(np.int32))):
            raise AssertionError(f"serve_chaos: batch {i}'s scores under faults are not "
                                 f"bit-equal to the fault-free run's "
                                 f"(max abs diff {np.abs(a - b).max():.3e})")
        if not np.isfinite(a).all():
            raise AssertionError(f"serve_chaos: non-finite scores in batch {i}")
    log(f"  serve_chaos: {CHAOS_BATCHES} batches of {CHAOS_BUCKET}, scores under "
        "faults bit-equal to the fault-free run's, batch by batch")
    if cs["by_kind"] != {k: 1 for k in CH.FAULT_KINDS} or cs["faults_skipped"] \
            or [k for (_, k, _) in cs["firing_log"]] != list(CH.FAULT_KINDS):
        raise AssertionError(f"serve_chaos: not every fault fired once: {cs}")
    if cs["restores"] != 1 or cs["active_drops"] or chaos_eng["killed_threads"] != 1:
        raise AssertionError(f"serve_chaos: a fault did not recover: {cs}, {chaos_eng}")
    want_moved = reshard_tables(chaos_tables, sparams["emb"]["table"].cpu().numpy(),
                                CHAOS_RESHARD_TO).moved_rows
    if cs["moved_rows"] != want_moved or cs["reshards"] != 1:
        raise AssertionError(f"serve_chaos: reshard moved {cs['moved_rows']} rows, "
                             f"reshard_tables counts {want_moved}")
    if injector2.summary()["firing_log"] != cs["firing_log"]:
        raise AssertionError(f"serve_chaos: a second run fired "
                             f"{injector2.summary()['firing_log']}, the first "
                             f"{cs['firing_log']}")
    if chaos_launches["dot_interaction"] < CHAOS_BATCHES:
        raise AssertionError(f"K2 launched {chaos_launches['dot_interaction']} times "
                             f"for {CHAOS_BATCHES} batches")
    log("[serve_chaos] " + json.dumps({
        "batches": CHAOS_BATCHES, "bucket": CHAOS_BUCKET,
        "clean_wall_s": clean_wall, "chaos_wall_s": chaos_wall,
        "firing_log": cs["firing_log"], "moved_rows": cs["moved_rows"],
        "moved_rows_host": want_moved, "inflight_invalidated": cs["inflight_invalidated"],
        "rows_re_replicated": cs["rows_re_replicated"], "restores": cs["restores"],
        "wall": cs["wall"], "virtual_p50_us": 1e6 * float(np.median(chaos_vlat)),
        "virtual_p99_us": 1e6 * float(np.quantile(chaos_vlat, 0.99)),
        "same_firing_log_twice": True, "phase_seconds": chaos_seconds,
        "launches": chaos_launches,
    }))

    # --------------------------------------------------------- serve_reshard
    args = launch_serve.parse_args(["--requests", str(SERVE_REQUESTS), "--chaos-seed", "0",
                                    "--reshard-to", str(RESHARD_TO)])
    t0 = time.perf_counter()
    reset_counts()
    rs = launch_serve.run(args)
    rs_launches = launch_counts()
    rs_seconds = time.perf_counter() - t0
    if not rs["requests"] == rs["submitted"] == SERVE_REQUESTS:
        raise AssertionError(f"serve_reshard served {rs['requests']} of {rs['submitted']} "
                             f"(wanted {SERVE_REQUESTS})")
    if rs["nonfinite_scores"]:
        raise AssertionError(f"{rs['nonfinite_scores']} non-finite serve_reshard scores")
    rc = rs["chaos"]
    if ("reshard", RESHARD_TO) not in [(k, t) for (_, k, t) in rc["firing_log"]] \
            or rc["moved_rows"] <= 0 or rc["active_drops"]:
        raise AssertionError(f"serve_reshard: no reshard to {RESHARD_TO} reported: {rc}")
    if rs_launches["dot_interaction"] < rs["batches"]:
        raise AssertionError(f"K2 launched {rs_launches['dot_interaction']} times "
                             f"for {rs['batches']} batches")
    log("[serve_reshard] " + json.dumps({
        "requests": rs["requests"], "batches": rs["batches"],
        "throughput_rps": rs["throughput_rps"], "p50_latency_ms": rs["p50_latency_ms"],
        "p99_latency_ms": rs["p99_latency_ms"], "chaos": rc,
        "phase_seconds": rs_seconds, "launches": rs_launches,
    }))
    # ----------------------------------------------------------------- train
    t_train = time.perf_counter()
    tcfg = launch_train.make_dlrm_100m()
    temb = tcfg.embedding()
    tparams = R.init_params(tcfg, seed=0, device=dev)
    table_t = tparams["emb"]["table"]
    V_t, D_t = table_t.shape
    # the trainer's batch of step 0 (seed 0), and K1's and K1''s inputs as the
    # lookup hands them over (masked mode, a masked slot's id the padding 0
    # of its field)
    tbatch = {k: torch.from_numpy(v).to(dev) for k, v in syn.recsys_batch(
        np.random.default_rng(0), tcfg.tables, TRAIN_BATCH, n_dense=tcfg.n_dense).items()}
    nnz_t = tbatch["indices"].shape[2]
    ids_t = temb._fused_rows(temb.sharded, tbatch["indices"]).reshape(-1).contiguous()
    w_t = tbatch["mask"].reshape(-1).to(torch.float32).contiguous()
    bags_t = ids_t.numel() // nnz_t
    live_t = ids_t[w_t != 0]
    live_rows, live_counts = torch.unique(live_t, return_counts=True)
    pad_rows = torch.unique(ids_t[w_t == 0])
    pad_only = pad_rows[~torch.isin(pad_rows, live_t)].long()
    log(f"[train] {tcfg.name} table {tuple(table_t.shape)} f32 "
        f"({table_t.numel() * 4 / 1e6:.1f} MB); the batch of {TRAIN_BATCH}: "
        f"{ids_t.numel()} slots, {live_t.numel()} live over {live_rows.numel()} rows "
        f"({int((live_counts > 1).sum())} rows named more than once, one "
        f"{int(live_counts.max())} times); {pad_only.numel()} rows named by padding alone")
    tgen = torch.Generator(device=dev).manual_seed(5)
    g_t = torch.randn((bags_t, D_t), device=dev, generator=tgen)
    def check_k1b(name, got, g, ids, w, V, masked) -> float:
        assert_bits(f"{name} vs its plain version on the CPU (slot order)", got.cpu(),
                    ref.embedding_bag_backward_ref(g.cpu(), ids.cpu(), w.cpu(), V,
                                                   masked=masked))
        return assert_close(f"{name} vs its plain version on the card (atomics)", got,
                            ref.embedding_bag_backward_ref(g, ids, w, V, masked=masked),
                            *K1B_TOL)

    k1b_out = K1.embedding_bag_backward(g_t, ids_t, w_t, V_t, masked=True)
    assert_equal("K1' twice on the same inputs (no atomics: deterministic)",
                 K1.embedding_bag_backward(g_t, ids_t, w_t, V_t, masked=True), k1b_out)
    k1b_err = check_k1b(f"K1' embedding_bag_backward masked f32 [{bags_t} bags x {nnz_t}] "
                        f"-> [{V_t}, {D_t}]", k1b_out, g_t, ids_t, w_t, V_t, True)
    if bool(k1b_out[pad_only].ne(0).any()):
        raise AssertionError("K1' wrote to a row that only padding names")
    log(f"  the {pad_only.numel()} rows padding alone names stay 0")
    egen = torch.Generator(device=dev).manual_seed(6)
    for nnz_e, width in ((1, 64), (3, 64), (4, 64), (1, 17), (3, 17), (4, 17)):
        V_e, bags_e = 5000, 1003
        ids_e = torch.randint(-50, V_e + 50, (bags_e * nnz_e,), device=dev, generator=egen,
                              dtype=torch.int32)
        w_e = torch.rand(bags_e * nnz_e, device=dev, generator=egen) + 0.5
        w_e[torch.rand(bags_e * nnz_e, device=dev, generator=egen) < 0.4] = 0.0
        g_e = torch.randn((bags_e, width), device=dev, generator=egen)
        check_k1b(f"K1' weighted nnz {nnz_e} D {width} [{bags_e} bags, ids in "
                  f"[-50, {V_e + 50})]", K1.embedding_bag_backward(g_e, ids_e, w_e, V_e),
                  g_e, ids_e, w_e, V_e, False)
        # masked: NaN in the gradient of every bag whose slots all weigh 0
        g_e[(w_e.view(bags_e, nnz_e) == 0).all(dim=1)] = float("nan")
        got = K1.embedding_bag_backward(g_e, ids_e, w_e, V_e, masked=True)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("K1' masked: the gradient of an all-padding bag reached a row")
        check_k1b(f"K1' masked nnz {nnz_e} D {width} [{bags_e} bags, ids in "
                  f"[-50, {V_e + 50}), NaN in the all-padding bags' gradient]", got,
                  g_e, ids_e, w_e, V_e, True)
    # torch.empty and one write a row: K1' into a buffer filled with NaN
    # first (the caching allocator hands the freed buffer back), and a
    # planted fault, a fill that skips the last row, which the check refuses
    k1b_cpu = ref.embedding_bag_backward_ref(g_t.cpu(), ids_t.cpu(), w_t.cpu(), V_t,
                                             masked=True)

    def k1b_into_nan() -> torch.Tensor:
        buf = torch.full((V_t, D_t), float("nan"), device=dev)
        ptr = buf.data_ptr()
        del buf
        out = K1.embedding_bag_backward(g_t, ids_t, w_t, V_t, masked=True)
        if out.data_ptr() != ptr:
            raise AssertionError("K1''s output is not the NaN-filled buffer just freed")
        return out

    assert_bits("K1' into a NaN-filled buffer vs its plain version on the CPU",
                k1b_into_nan().cpu(), k1b_cpu)
    if bool((live_t == V_t - 1).any()):
        raise AssertionError(f"row {V_t - 1} is live: the planted fault needs an untouched row")
    plant_log, _ = planted_build.communicate()
    if planted_build.returncode:
        raise RuntimeError(f"nvcc failed for K1''s planted fault:\n{plant_log}")
    build.use_library(K1.NAME, planted_so)
    try:
        planted = k1b_into_nan().cpu()
    finally:
        build.use_library(K1.NAME, build.library_path(K1.NAME))
    assert_bits_refused(f"K1' with its fill made to skip row {V_t - 1}, into a NaN-filled "
                        "buffer", planted, k1b_cpu)
    del planted, k1b_cpu
    # one row named by every slot: a run of all 26,624
    hot_ids = torch.full_like(ids_t, V_t // 2)
    hot_w = torch.ones_like(w_t)
    hot = K1.embedding_bag_backward(g_t, hot_ids, hot_w, V_t, masked=True)
    assert_equal("K1' one row named by every slot, twice",
                 K1.embedding_bag_backward(g_t, hot_ids, hot_w, V_t, masked=True), hot)
    assert_bits(f"K1' one row named by all {hot_ids.numel()} slots vs its plain version on "
                "the CPU", hot.cpu(), ref.embedding_bag_backward_ref(
                    g_t.cpu(), hot_ids.cpu(), hot_w.cpu(), V_t, masked=True))
    del hot
    # every slot masked, NaN in every bag's gradient: all zeros
    none = K1.embedding_bag_backward(torch.full_like(g_t, float("nan")), ids_t,
                                     torch.zeros_like(w_t), V_t, masked=True)
    assert_bits("K1' every slot masked, NaN in every bag's gradient: all zeros", none,
                torch.zeros_like(none))
    del none
    # a table of 16,777,216 rows (4.3 GB): touched rows against the plain
    # version on the card, every other row exactly 0
    ids_big = torch.randint(0, K1B_BIG_ROWS, ids_t.shape, device=dev, generator=egen,
                            dtype=torch.int32)
    big = K1.embedding_bag_backward(g_t, ids_big, w_t, K1B_BIG_ROWS, masked=True)
    rows_big = torch.unique(ids_big[w_t != 0].long())
    assert_close(f"K1' into [{K1B_BIG_ROWS}, {D_t}] ({big.numel() * 4 / 1e9:.1f} GB), its "
                 f"{rows_big.numel()} touched rows", big[rows_big], ref.embedding_bag_backward_ref(
                     g_t, ids_big, w_t, K1B_BIG_ROWS, masked=True)[rows_big], *K1B_TOL)
    norms = torch.linalg.vector_norm(big, 1, dim=1)
    norms[rows_big] = 0.0
    if bool(norms.any()):
        raise AssertionError(f"K1' left {int((norms != 0).sum())} untouched rows of the "
                             f"{K1B_BIG_ROWS}-row table nonzero")
    log(f"  the other {K1B_BIG_ROWS - rows_big.numel()} rows are exactly 0")
    del big, norms
    F_t = tcfg.num_fields + 1
    x_tr = torch.randn((TRAIN_BATCH, F_t, D_t), device=dev, generator=tgen)
    gt_tr = torch.randn((TRAIN_BATCH, F_t * (F_t + 1) // 2), device=dev, generator=tgen)
    k2b_err = assert_close(f"K2' dot_interaction_backward f32 {list(x_tr.shape)}",
                           K2.dot_interaction_backward(x_tr, gt_tr),
                           ref.dot_interaction_backward_ref(x_tr, gt_tr), 1e-5, 1e-5)
    for bucket in SERVE_BUCKETS:
        x_b = torch.randn((bucket, SERVE_FIELDS, D_t), device=dev, generator=tgen)
        g_b = torch.randn((bucket, SERVE_FIELDS * (SERVE_FIELDS + 1) // 2), device=dev,
                          generator=tgen)
        assert_close(f"K2' dot_interaction_backward f32 {list(x_b.shape)} (serve bucket)",
                     K2.dot_interaction_backward(x_b, g_b),
                     ref.dot_interaction_backward_ref(x_b, g_b), 1e-5, 1e-5)
    # timings: the kernel, its plain version and one PyTorch call, L2 cold
    tflush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    live_idx = live_t.long()
    contrib = (g_t.repeat_interleave(nnz_t, dim=0) * w_t[:, None])[w_t != 0]
    iu, ju = torch.triu_indices(F_t, F_t, device=dev)
    g_full = torch.zeros((TRAIN_BATCH, F_t, F_t), device=dev)
    g_full[:, iu, ju] = gt_tr
    s_full = g_full + g_full.transpose(1, 2)
    backward = {
        "embedding_bag": {
            "ms": cuda_ms(lambda: K1.embedding_bag_backward(g_t, ids_t, w_t, V_t, masked=True),
                          tflush),
            "plain_ms": cuda_ms(lambda: ref.embedding_bag_backward_ref(
                g_t, ids_t, w_t, V_t, masked=True), tflush),
            "library_ms": cuda_ms(lambda: torch.zeros((V_t, D_t), device=dev).index_add_(
                0, live_idx, contrib), tflush),
            "max_abs_err": k1b_err, "bit_equal_to_cpu_plain": True,
            "case": f"masked, [{bags_t} bags x {nnz_t}] -> [{V_t}, {D_t}] f32",
            "hot_row_ms": cuda_ms(lambda: K1.embedding_bag_backward(
                g_t, hot_ids, hot_w, V_t, masked=True), tflush, reps=5, warmup=1),
            "big_table": {"rows": K1B_BIG_ROWS, "ms": cuda_ms(lambda: K1.embedding_bag_backward(
                g_t, ids_big, w_t, K1B_BIG_ROWS, masked=True), tflush, reps=5, warmup=1),
                "bound_ms": bound(K1B_BIG_ROWS * D_t * 4, 0)[0]},
        },
        "dot_interaction": {
            "ms": cuda_ms(lambda: K2.dot_interaction_backward(x_tr, gt_tr), tflush),
            "plain_ms": cuda_ms(lambda: ref.dot_interaction_backward_ref(x_tr, gt_tr), tflush),
            "library_ms": cuda_ms(lambda: torch.bmm(s_full, x_tr), tflush),
            "max_abs_err": k2b_err, "case": f"f32 {list(x_tr.shape)}",
        },
    }
    backward["embedding_bag"]["bound_ms"], backward["embedding_bag"]["bound_by"] = bound(
        V_t * D_t * 4 + g_t.numel() * 4 + ids_t.numel() * 8, 2 * live_t.numel() * D_t)
    n_tri = F_t * (F_t + 1) // 2
    backward["dot_interaction"]["bound_ms"], backward["dot_interaction"]["bound_by"] = bound(
        2 * x_tr.numel() * 4 + TRAIN_BATCH * n_tri * 4, 2 * TRAIN_BATCH * F_t * F_t * D_t)
    log("[train] backward kernels: " + json.dumps(backward))
    del tflush, contrib, live_idx, g_full, s_full, x_tr, gt_tr, k1b_out, got
    del hot_ids, hot_w, ids_big, rows_big

    # one train step on the card against the same step on the CPU (plain
    # versions), from the same params, with NaN in the rows padding alone names
    table_t[pad_only] = float("nan")
    cpu_params = tree_to(tparams, "cpu")
    cpu_batch = {k: v.cpu() for k, v in tbatch.items()}
    topt = launch_train.make_optimizer()
    reset_counts()
    loss_c, grads_c = R.loss_and_grads(tcfg, tparams, tbatch)
    torch.cuda.synchronize()
    step_launches = launch_counts()
    if any(step_launches[k] != 1 for k in ("embedding_bag_masked", "embedding_bag_backward",
                                            "dot_interaction", "dot_interaction_backward")):
        raise AssertionError(f"one step's gradient did not run K1 masked, K1', K2 and K2' "
                             f"once each: {step_launches}")
    loss_h, grads_h = R.loss_and_grads(tcfg, cpu_params, cpu_batch)
    if not bool(torch.isfinite(loss_c)):
        raise AssertionError(f"train step loss not finite with NaN behind padding: {loss_c}")
    for path, g in tree_flatten_with_path(grads_c):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient {keystr(path)} not finite")
    if bool(grads_c["emb"]["table"][pad_only].ne(0).any()):
        raise AssertionError("the table's gradient is not 0 on a row padding alone names")
    assert_close("train step loss, card vs CPU", loss_c.cpu(), loss_h, *TRAIN_GRAD_TOL)
    grad_err = assert_trees_close("train step gradients, card vs CPU", grads_c, grads_h,
                                  *TRAIN_GRAD_TOL)
    # The step's update from the card's gradients, on the card and on the
    # CPU.  Each side's own gradients are compared above and not fed on:
    # Adam's first step moves a parameter by lr g / (|g| + eps), which at
    # |g| near eps = 1e-8 turns a gradient difference of 1e-11 into one of
    # lr / eps * 1e-11 = 1e-6 in the parameter (reported below).
    step_fn = R.make_train_step(tcfg, topt)
    st_c, st_h = topt.init(tparams), topt.init(cpu_params)
    p1c, s1c = topt.update(grads_c, st_c, tparams)
    p1h, s1h = topt.update(tree_to(grads_c, "cpu"), st_h, cpu_params)
    step_err = assert_trees_close("params and optimizer state after the step (the card's "
                                  "gradients), card vs CPU", (p1c, s1c), (p1h, s1h),
                                  *TRAIN_STEP_TOL)
    p1s, s1s, _ = step_fn(tparams, st_c, tbatch)  # the card's own step function
    assert_trees_close("the card's train step against that update", (p1s, s1s), (p1c, s1c),
                       *TRAIN_STEP_TOL)
    step_bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for (_, a), (_, b) in zip(tree_flatten_with_path((p1s, s1s)),
                                              tree_flatten_with_path((p1c, s1c))))
    p1o, _, _ = step_fn(cpu_params, st_h, cpu_batch)  # the CPU's step, its own gradients
    own = []
    for (path, a), (_, b), (_, g) in zip(tree_flatten_with_path(p1s),
                                         tree_flatten_with_path(p1o),
                                         tree_flatten_with_path(grads_c)):
        d = (a.cpu() - b).abs().nan_to_num(0.0)
        i = int(d.argmax())
        own.append((float(d.reshape(-1)[i]), keystr(path), float(g.reshape(-1)[i])))
    own_err, own_leaf, own_grad = max(own)
    log(f"  the card's step bit-equal to the update from its gradients: {step_bits}; each "
        f"side's step from its own gradients differs by at most {own_err:.3e} at {own_leaf}, "
        f"where the gradient is {own_grad:.3e}")
    del cpu_params, cpu_batch, grads_h, p1h, s1h, grads_c, p1c, s1c, p1s, s1s, p1o
    table_t.normal_(0.0, 0.01, generator=tgen)  # no NaN in the timed window
    train_profile = device_busy(lambda: step_fn(tparams, st_c, tbatch), 3, kernels=(
        "embedding_bag_kernel", "bag_backward_kernel<", "dot_interaction_kernel",
        "dot_interaction_backward_kernel", "FillFunctor", "DeviceRadixSort", "gemm"))
    if train_profile["kernels_ms_per_call"]["bag_backward_kernel<"] <= 0 \
            or train_profile["kernels_ms_per_call"]["DeviceRadixSort"] > 0:
        raise AssertionError("the step's profile shows no K1' kernel, or a library sort: "
                             f"{train_profile['kernels_ms_per_call']}")
    # the trainer's step function learns: two alternating fixed batches
    fit_batches = [{k: torch.from_numpy(v).to(dev) for k, v in syn.recsys_batch(
        np.random.default_rng(i), tcfg.tables, TRAIN_BATCH, n_dense=tcfg.n_dense).items()}
        for i in range(2)]
    fp, fs, fit_losses = tparams, st_c, []
    for i in range(TRAIN_FIT_STEPS):
        fp, fs, m = step_fn(fp, fs, fit_batches[i % 2])
        fit_losses.append(float(m["loss"]))
    if not fit_losses[-1] < fit_losses[0]:
        raise AssertionError(f"two alternating fixed batches: loss did not fall: {fit_losses}")
    del tparams, st_c, fp, fs, fit_batches, table_t

    # launch.train at its defaults, then the restart through its own flags
    reset_counts()
    tout = launch_train.train_recsys(launch_train.parse_args([]))
    train_launches = launch_counts()
    steps = tout["steps"]
    if steps != TRAIN_STEPS or not all(np.isfinite(tout["step_seconds"])) \
            or not np.isfinite([tout["first_loss"], tout["final_loss"]]).all():
        raise AssertionError(f"launch.train at its defaults: {tout['steps']} steps, losses "
                             f"{tout['first_loss']} -> {tout['final_loss']}")
    per_step = ("embedding_bag", "embedding_bag_masked", "embedding_bag_backward",
                "dot_interaction", "dot_interaction_backward")
    if any(train_launches[k] != steps for k in per_step):
        raise AssertionError(f"train did not launch {per_step} once a step: {train_launches}")
    ck = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    first = launch_train.train_recsys(launch_train.parse_args(
        ["--steps", str(TRAIN_RESUME_AT), "--ckpt-dir", str(ck)]))
    if CheckpointManager(ck).latest_step() != TRAIN_RESUME_AT - 1:
        raise AssertionError(f"--steps {TRAIN_RESUME_AT} left step "
                             f"{CheckpointManager(ck).latest_step()} as the latest")
    resumed = launch_train.train_recsys(launch_train.parse_args(
        ["--steps", str(TRAIN_STEPS), "--ckpt-dir", str(ck), "--resume"]))
    shutil.rmtree(ck, ignore_errors=True)
    if resumed["steps"] != TRAIN_STEPS - TRAIN_RESUME_AT:
        raise AssertionError(f"--resume ran {resumed['steps']} steps")
    if not np.isclose(resumed["final_loss"], tout["final_loss"], rtol=1e-5, atol=0.0):
        raise AssertionError(f"resumed run's last loss {resumed['final_loss']} != the straight "
                             f"run's {tout['final_loss']} (rtol 1e-5)")
    log("[train] " + json.dumps({
        "model": tcfg.name, "batch": TRAIN_BATCH, "steps": steps,
        "first_loss": tout["first_loss"], "final_loss": tout["final_loss"],
        "final_below_first": tout["final_loss"] < tout["first_loss"],
        "median_step_ms": 1e3 * statistics.median(tout["step_seconds"]),
        "first_step_ms": 1e3 * tout["step_seconds"][0],
        "step_device": train_profile,
        "fit_two_batches_losses": fit_losses,
        "resume": {"first_run_steps": first["steps"], "resumed_steps": resumed["steps"],
                   "resumed_final_loss": resumed["final_loss"],
                   "bit_equal": resumed["final_loss"] == tout["final_loss"]},
        "grad_max_abs_err": grad_err, "step_max_abs_err": step_err,
        "step_bit_equal_to_update": step_bits,
        "own_gradient_steps": {"max_abs_err": own_err, "leaf": own_leaf, "grad": own_grad},
        "launches": train_launches, "phase_seconds": time.perf_counter() - t_train,
    }))
    gc.collect()
    torch.cuda.empty_cache()

    del sparams, server, controller, engine, reqs, wl, chaos_reqs, cb
    del clean, faulty, again, injector, injector2
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[recsys_archs] DLRM state freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "still allocated on the card")

    # ---------------------------------------------------------- recsys_archs
    archs = recsys_archs(dev)
    log("[recsys_archs] " + json.dumps({k: v for k, v in archs.items() if k != "paths"}))

    # ---------------------------------------------------------- recsys_cells
    cells = recsys_cells(dev)

    # ---------------------------------------------------------------- demos
    demo_res = demos(dev)

    # ------------------------------------------------------- gnn, gnn_sharded
    gnn_res = gnn(dev)
    gnn_blocks = gnn_res.pop("sharded_blocks")
    log("[gnn] " + json.dumps({k: v for k, v in gnn_res.items() if k != "paths"}))
    gnn_sh = gnn_sharded(dev, gnn_blocks)
    del gnn_blocks

    # ------------------------------------------------------------ lm kernels
    lm_cfg = serving_config(make_lm_config())
    Hq, Hkv, dh = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.d_head
    bf16, f32 = torch.bfloat16, torch.float32
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    lm_gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(shape, dtype):
        return torch.randn(shape, device=dev, generator=lm_gen).to(dtype)

    def k7_bound(q, kc, n):
        B_, _, Hkv_, d_ = kc.shape
        return bound(2 * B_ * n * Hkv_ * d_ * kc.element_size()  # K and V rows < n
                     + 2 * q.numel() * q.element_size(),  # q, out
                     4 * d_ * q.shape[0] * q.shape[1] * n)


    def k7_lib(q, kc, vc, n):
        return F.scaled_dot_product_attention(q[:, :, None], kc[:, :n].transpose(1, 2),
                                              vc[:, :n].transpose(1, 2), enable_gqa=True)

    def k7p_lib(q, kc, vc, n):
        # The shard's output and its logsumexp (= m + log l, all the combine
        # needs) from one call; K7's shard mode has no GQA case here.
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q[:, :, None], kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2), None, True)

    lm_rows = []
    k7p_rows = {}  # K7's shard mode timed, by dtype

    def device_times(row, kern, lib):
        """The kernel's and the library call's device time alone
        (``device_ms``) beside a row's event medians."""
        row["kernel_device_ms"], row["library_device_ms"] = device_ms(kern), device_ms(lib)

    def time_case(label, kern, plain, lib, bnd):
        row = {"case": label, "ms": cuda_ms(kern, flush),
               "plain_ms": None if plain is None else cuda_ms(plain, flush),
               "library_ms": None if lib is None else cuda_ms(lib, flush),
               "bound_ms": bnd[0], "bound_by": bnd[1]}
        lm_rows.append(row)
        return row

    log("[lm_kernels] K6 and K7 against their plain versions on the card")
    B, S = LM_BATCH, LM_PROMPT
    k6_cases = {
        "path bf16": ((B, S, Hq, dh), Hkv, bf16, True),
        "path f32": ((B, S, Hq, dh), Hkv, f32, True),
        # lm_f32's own prefill layer: the full-depth check's 2 x 1,024 tokens.
        "lm_f32 f32": ((2, LM_DEPTH_PROMPT, Hq, dh), Hkv, f32, True),
        "gqa bf16": ((1, S, LM_GQA_HEADS[0], LM_GQA_HEADS[2]), LM_GQA_HEADS[1], bf16, True),
        "dh128 bf16": ((1, S, Hq, LM_GQA_HEADS[2]), Hq, bf16, True),
        "ragged bf16": ((2, LM_RAGGED_SEQ, Hq, dh), Hkv, bf16, True),
        "ragged dh64 bf16": ((2, LM_RAGGED_SEQ, 4, 64), 2, bf16, True),
        "ragged dh96 bf16": ((2, LM_RAGGED_SEQ, 4, 96), 2, bf16, True),
        "ragged full bf16": ((2, LM_RAGGED_SEQ, Hq, dh), Hkv, bf16, False),
        "ragged full f32": ((2, LM_RAGGED_SEQ, Hq, dh), Hkv, f32, False),
        # f32 (3xTF32 on mma.sync) at every head dim, with GQA, ragged S
        # causal and full.
        "gqa f32": ((1, S, LM_GQA_HEADS[0], LM_GQA_HEADS[2]), LM_GQA_HEADS[1], f32, True),
        "dh128 f32": ((1, S, Hq, LM_GQA_HEADS[2]), Hq, f32, True),
        "ragged f32": ((2, LM_RAGGED_SEQ, Hq, dh), Hkv, f32, True),
        "ragged dh64 f32": ((2, LM_RAGGED_SEQ, 4, 64), 2, f32, True),
        "ragged dh96 f32": ((2, LM_RAGGED_SEQ, 4, 96), 2, f32, True),
        "ragged dh128 full f32": ((2, LM_RAGGED_SEQ, 4, 128), 1, f32, False),
        # The reference sweep's bf16 rows at head dims 16 and 32
        # (tests/test_kernels.py): one 16- or 32-column region a tile.
        "dh16 bf16": ((2, 64, 4, 16), 2, bf16, True),
        "dh32 full bf16": ((1, 128, 4, 32), 4, bf16, False),
    }
    # Each MoE / wide path's own prefill and decode layer: olmoe's 16/16
    # heads (bf16, and lm_moe_f32's f32 layer), arctic's 56/8 (groups of 7:
    # K7 takes its heads in chunks of 4, so the second chunk is partial),
    # qwen2's 64/8 and llama3's 128/8, all at head dim 128.
    olmoe = make_olmoe()
    wide_configs = {"arctic-480b": arctic_480b.make_config, "qwen2-72b": qwen2_72b.make_config,
                    "llama3-405b": llama3_405b.make_config}
    new_paths = {"lm_moe bf16": (LM_BATCH, LM_PROMPT, LM_CACHE, olmoe, bf16),
                 "lm_moe_f32 f32": (2, LM_DEPTH_PROMPT, LM_DEPTH_PROMPT + LM_CHECK_STEPS,
                                    olmoe, f32)}
    new_paths.update({f"lm_wide.{arch} bf16": (WIDE_BATCH, LM_PROMPT, WIDE_CACHE, make(), bf16)
                      for arch, make in wide_configs.items()})
    for label, (b_, s_, _, c_, dt_) in new_paths.items():
        k6_cases[label] = ((b_, s_, c_.n_heads, c_.d_head), c_.n_kv_heads, dt_, True)
    k6_f32 = {}  # f32 timing rows by label
    with torch.no_grad():
        for label, (shape, hkv, dt, causal) in k6_cases.items():
            q = rnd(shape, dt)
            k = rnd(shape[:2] + (hkv, shape[3]), dt)
            v = rnd(shape[:2] + (hkv, shape[3]), dt)
            check = assert_close_rows if dt == bf16 else assert_close
            tol = LM_BF16_TOL if dt == bf16 else LM_F32_TOL
            want = ref.flash_attention_ref(q, k, v, causal)
            err = check(f"K6 flash_attention {label} {list(shape[:3]) + [hkv, shape[3]]} "
                        f"{'causal' if causal else 'full'}",
                        K6.flash_attention(q, k, v, causal), want, *tol)
            if label in ("path bf16", "path f32"):
                # A kernel whose KV loop skips the first tile, seen only on
                # the later half of the rows, where |out| is smallest.
                t, h = LM_KV_TILE, S // 2
                planted = ref.flash_attention_ref(q[:, t:], k[:, t:], v[:, t:], True)
                refuse = assert_refused if dt == bf16 else assert_refused_close
                refuse(f"K6 {label} with the first KV tile skipped, rows {h}+",
                       planted[:, h - t:], want[:, h:], *tol)
                del planted
            if label == "dh32 full bf16":  # the same fault at head dim 32: half the keys
                t = LM_KV_TILE
                assert_refused(f"K6 {label} with the first KV tile skipped",
                               ref.flash_attention_ref(q, k[:, t:], v[:, t:], False), want, *tol)
            if label == "path bf16":
                errs["flash_attention"] = err
                timings["flash_attention"] = (
                    cuda_ms(lambda: K6.flash_attention(q, k, v, True), flush),
                    cuda_ms(lambda: ref.flash_attention_ref(q, k, v, True), flush),
                    cuda_ms(lambda: sdpa_forward(q, k, v, True), flush))
                bounds["flash_attention"] = k6_bound(q, k, True)
            elif label in ("path f32", "lm_f32 f32", "gqa bf16", "dh128 bf16", "dh16 bf16",
                           "dh32 full bf16"):
                # f32's bound is its design's: three tf32 products; the f32
                # FMA bound stands beside it.
                rate = TF32_TENSOR_FLOP_PER_S / 3 if dt == f32 else None
                row = time_case(f"K6 {label} {list(shape[:3]) + [hkv, shape[3]]}",
                                lambda: K6.flash_attention(q, k, v, causal),
                                lambda: ref.flash_attention_ref(q, k, v, causal),
                                lambda: sdpa_forward(q, k, v, causal), k6_bound(q, k, causal, rate))
                if shape[3] < 64:  # launch-sized: the host's enqueue fills the events
                    device_times(row, lambda: K6.flash_attention(q, k, v, causal),
                                 lambda: sdpa_forward(q, k, v, causal))
                if dt == f32:
                    row["bound_ms_fma"] = k6_bound(q, k, causal)[0]
                    row["max_abs_err"] = err
                    k6_f32[label] = row
            del q, k, v, want
        k6_trainer, k6_host = k6_walk_checks(dev, k6_planted, flush, lm_gen)
        # K6 at prefill_32k's length, one sequence: kernel and library only.
        Sp = LM_SHAPES["prefill_32k"]["seq"]
        q, k, v = (rnd((1, Sp, Hq, dh), bf16) for _ in range(3))
        time_case(f"K6 bf16 [1, {Sp}, {Hq}, {Hkv}, {dh}] causal (prefill_32k, B = 1)",
                  lambda: K6.flash_attention(q, k, v, True), None,
                  lambda: sdpa_forward(q, k, v, True), k6_bound(q, k, True))
        del q, k, v

        n_path = LM_PROMPT + 1  # the first decode step's valid length
        # K7 splits the positions into chunks (K7.plan_split): cache_len on a
        # chunk boundary of the g = 4 case, one past it, and the whole cache.
        g4_q = (2, 4 * LM_GQA_HEADS[1], LM_GQA_HEADS[2])
        g4_c = (2, LM_CACHE, LM_GQA_HEADS[1], LM_GQA_HEADS[2])
        g4_bounds = K7.chunk_bounds(LM_CACHE, K7.plan_split(LM_CACHE, 2, g4_c[2], 4))
        edge = g4_bounds[len(g4_bounds) // 2]
        k7_cases = {
            "path bf16": ((B, Hq, dh), (B, LM_CACHE, Hkv, dh), bf16, n_path),
            "cache_len 1": ((B, Hq, dh), (B, LM_CACHE, Hkv, dh), bf16, 1),
            "path f32": ((B, Hq, dh), (B, LM_CACHE, Hkv, dh), f32, n_path),
            "gqa bf16": ((2, LM_GQA_HEADS[0], LM_GQA_HEADS[2]),
                         (2, LM_CACHE, LM_GQA_HEADS[1], LM_GQA_HEADS[2]), bf16, n_path),
            "g4 chunk edge bf16": (g4_q, g4_c, bf16, edge),
            "g4 chunk edge + 1 bf16": (g4_q, g4_c, bf16, edge + 1),
            "g4 full cache bf16": (g4_q, g4_c, bf16, LM_CACHE),
            "g4 chunk edge + 1 f32": (g4_q, g4_c, f32, edge + 1),
            # the reference sweep's bf16 rows at head dims 16 and 32, and
            # lm_small_bf16's decode (8 prompts of 128, its first step)
            "dh16 bf16": ((2, 8, 16), (2, 128, 2, 16), bf16, 100),
            "dh32 bf16": ((1, 4, 32), (1, 256, 4, 32), bf16, 256),
            "lm-small bf16": ((LMB_PREFILL[0], 8, 32),
                              (LMB_PREFILL[0], LMB_PREFILL[1] + LMB_DECODE_STEPS, 4, 32), bf16,
                              LMB_PREFILL[1] + 1),
        }
        for label, (b_, s_, cache_, c_, dt_) in new_paths.items():  # the first step's length
            k7_cases[label] = ((b_, c_.n_heads, c_.d_head),
                               (b_, cache_, c_.n_kv_heads, c_.d_head), dt_, s_ + 1)
        log(f"  K7 chunks: {K7.plan_split(LM_CACHE, B, Hkv, Hq // Hkv)} at the path shape, "
            f"{len(g4_bounds) - 1} at g = 4 (chunk edge {edge})")
        for label, (qs, cs, dt, n) in k7_cases.items():
            q, kc, vc = rnd(qs, dt), rnd(cs, dt), rnd(cs, dt)
            kc[:, n:] = float("nan")  # garbage past cache_len is never read
            vc[:, n:] = float("nan")
            n_t = torch.tensor(n, dtype=torch.int32, device=dev)
            got = K7.flash_decode(q, kc, vc, n_t)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"K7 {label}: output not finite with NaN past cache_len")
            check = assert_close_rows if dt == bf16 else assert_close
            tol = LM_BF16_TOL if dt == bf16 else LM_F32_TOL
            want = ref.flash_decode_ref(q, kc, vc, n_t)
            err = check(f"K7 flash_decode {label} q {list(qs)} caches {list(cs)} "
                        f"cache_len {n}, NaN past it", got, want, *tol)
            if label in ("path bf16", "dh32 bf16"):
                assert_refused(f"K7 {label} with the last KV tile skipped",
                               ref.flash_decode_ref(q, kc, vc, n_t - LM_KV_TILE), want, *tol)
            if label == "path bf16":
                # A combine that drops the middle chunk of the split.
                bnd = K7.chunk_bounds(cs[1], K7.plan_split(cs[1], cs[0], cs[2], qs[1] // cs[2]))
                lo, hi = bnd[(len(bnd) - 1) // 2], bnd[(len(bnd) - 1) // 2 + 1]
                keep = torch.cat([torch.arange(lo, device=dev),
                                  torch.arange(hi, cs[1], device=dev)])
                assert_refused(f"K7 {label} with chunk [{lo}, {hi}) dropped",
                               ref.flash_decode_ref(q, kc[:, keep], vc[:, keep],
                                                    n - (hi - lo)), want, *tol)
                del keep
                errs["flash_decode"] = err
                timings["flash_decode"] = (
                    cuda_ms(lambda: K7.flash_decode(q, kc, vc, n_t), flush),
                    cuda_ms(lambda: ref.flash_decode_ref(q, kc, vc, n_t), flush),
                    cuda_ms(lambda: k7_lib(q, kc, vc, n), flush))
                bounds["flash_decode"] = k7_bound(q, kc, n)
            elif label in ("path f32", "gqa bf16", "dh16 bf16", "dh32 bf16", "lm-small bf16"):
                row = time_case(f"K7 {label} q {list(qs)} caches {list(cs)} cache_len {n}",
                                lambda: K7.flash_decode(q, kc, vc, n_t),
                                lambda: ref.flash_decode_ref(q, kc, vc, n_t),
                                lambda: k7_lib(q, kc, vc, n), k7_bound(q, kc, n))
                if qs[2] < 64:
                    device_times(row, lambda: K7.flash_decode(q, kc, vc, n_t),
                                 lambda: k7_lib(q, kc, vc, n))
            del q, kc, vc, got, want
        # K7 at decode_32k's length, B = 8, a full cache: kernel and library only.
        Bl, Sl = LM_LONG_DECODE_BATCH, LM_SHAPES["decode_32k"]["seq"]
        q = rnd((Bl, Hq, dh), bf16)
        kc, vc = rnd((Bl, Sl, Hkv, dh), bf16), rnd((Bl, Sl, Hkv, dh), bf16)
        n_t = torch.tensor(Sl, dtype=torch.int32, device=dev)
        time_case(f"K7 bf16 q [{Bl}, {Hq}, {dh}] caches [{Bl}, {Sl}, {Hkv}, {dh}] cache_len "
                  f"{Sl} (decode_32k, B = {Bl})", lambda: K7.flash_decode(q, kc, vc, n_t),
                  None, lambda: k7_lib(q, kc, vc, Sl), k7_bound(q, kc, Sl))
        del q, kc, vc

        # K7's shard mode on lm_sharded_decode's model_b4 shard (olmoe's 16
        # heads of 128, 1,032 positions): the shard wholly below cache_len,
        # cache_len inside it, at its start (empty) and before it (empty),
        # NaN from cache_len on (an empty shard is NaN throughout and must
        # give m = -inf, l = 0, acc = 0).  The normalised acc / l against the
        # plain version's at the output tolerances, m and l at f32's.
        # Then, untimed, bf16 at head dims 16 and 32 on shards of
        # K7P_SMALL positions: lm_smoke's 4 heads over 1 and lm-small's 8
        # over 4.
        k7p_errs = {}
        for sq, sc, dts, timed in (
                ((LM_BATCH, 16, 128), (LM_BATCH, K7P_SHARD, 16, 128), (f32, bf16), True),
                ((4, 4, 16), (4, K7P_SMALL, 1, 16), (bf16,), False),
                ((8, 8, 32), (8, K7P_SMALL, 4, 32), (bf16,), False)):
            shard = sc[1]
            n_glob = shard + shard // 2
            partial_cases = {"below cache_len": 0, "cache_len inside": shard,
                             "cache_len at the start": n_glob, "past cache_len": 2 * shard}
            for dt in dts:
                for label, start in partial_cases.items():
                    q, kc, vc = rnd(sq, dt), rnd(sc, dt), rnd(sc, dt)
                    live = max(0, min(n_glob - start, shard))
                    kc[:, live:] = float("nan")
                    vc[:, live:] = float("nan")
                    n_t = torch.tensor(n_glob, dtype=torch.int32, device=dev)
                    s_t = torch.tensor(start, dtype=torch.int32, device=dev)
                    o, m, l_ = K7.flash_decode_partial(q, kc, vc, n_t, s_t)
                    wo, wm, wl = ref.flash_decode_partial_ref(q, kc, vc, n_t, s_t)
                    name = (f"K7 shard mode {dtype_name(q)} q {list(sq)} shard {list(sc)} start "
                            f"{start} cache_len {n_glob} ({label}, {live} rows)")
                    if not (bool(torch.isfinite(o).all()) and not bool(torch.isnan(m).any())
                            and bool(torch.isfinite(l_).all())):
                        raise AssertionError(f"{name}: NaN or inf in the partials")
                    if live == 0:
                        if not (bool((m == float("-inf")).all()) and not l_.any() and not o.any()):
                            raise AssertionError(f"{name}: an empty shard must give m = -inf, "
                                                 "l = 0, acc = 0")
                        log(f"  {name}: ok, m = -inf, l = 0, acc = 0")
                        continue
                    assert_close(f"{name}: m", m, wm, *LM_F32_TOL)
                    assert_close(f"{name}: l", l_, wl, *LM_F32_TOL)
                    check = assert_close_rows if dt == bf16 else assert_close
                    k7p_errs[(dtype_name(q), label)] = check(
                        f"{name}: acc / l", o / l_[..., None], wo / wl[..., None],
                        *(LM_BF16_TOL if dt == bf16 else LM_F32_TOL))
                    if timed and label == "below cache_len":
                        bnd = bound(2 * kc.numel() * kc.element_size()
                                    + q.numel() * q.element_size()
                                    + o.numel() * 4 + 2 * m.numel() * 4,
                                    4 * sq[2] * sq[0] * sq[1] * live)
                        row = time_case(f"K7 shard mode {dtype_name(q)} q {list(sq)} shard "
                                        f"{list(sc)}, every row valid",
                                        lambda: K7.flash_decode_partial(q, kc, vc, n_t, s_t),
                                        lambda: ref.flash_decode_partial_ref(q, kc, vc, n_t, s_t),
                                        lambda: k7p_lib(q, kc, vc, live), bnd)
                        row["max_abs_err"] = k7p_errs[(dtype_name(q), label)]
                        # The yardstick's own partial: its lse against m + log l,
                        # its output against acc / l (reported, not gated).
                        lo, lse = k7p_lib(q, kc, vc, live)[:2]
                        row["library_partial_err"] = {
                            "lse": max_err(lse[..., 0], m + torch.log(l_)),
                            "out": max_err(lo[:, :, 0].float(), o / l_[..., None])}
                        # The event pair above also holds the wrapper's enqueue
                        # when the host trails the flush: the kernel's own device
                        # time, L2 flushed before each call, from the profiler.
                        row["kernel_device_ms"] = device_busy(
                            lambda: (flush.zero_(), K7.flash_decode_partial(q, kc, vc, n_t, s_t)),
                            15, kernels=("flash_decode_kernel",))["kernels_ms_per_call"][
                            "flash_decode_kernel"]
                        k7p_rows[dtype_name(q)] = row
                    del o, m, l_, wo, wm, wl
                del q, kc, vc
    for name in ("flash_attention", "flash_decode"):
        ms, plain_ms, lib_ms = timings[name]
        bms, by = bounds[name]
        log(f"  {name} at the path shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bms:.6f} ms (by {by}; the kernel reaches "
            f"{bms / ms:.1%} of it)")
    log("[lm_kernels] " + json.dumps(lm_rows))
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ lm_prefill
    t0 = time.perf_counter()
    lm_params = TF.init_params(lm_cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[lm_prefill] {lm_cfg.name}: {lm_cfg.num_params():,} parameters in bf16 "
        f"({tree_size_bytes(lm_params) / 1e9:.2f} GB) made on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    host_lm = syn.lm_batch(np.random.default_rng(0), lm_cfg.vocab, LM_BATCH, LM_PROMPT)
    tokens = torch.from_numpy(host_lm["tokens"]).to(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        last, (kc, vc) = TF.prefill(lm_cfg, lm_params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = launch_counts()
    if prefill_launches["flash_attention"] != lm_cfg.n_layers:
        raise AssertionError(f"lm_prefill launched K6 {prefill_launches['flash_attention']} "
                             f"times, want one per layer ({lm_cfg.n_layers})")
    Vp = lm_cfg.padded_vocab()
    if last.shape != (LM_BATCH, Vp) or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"lm_prefill last logits not finite [{LM_BATCH}, {Vp}]: "
                             f"{tuple(last.shape)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: TF.prefill(lm_cfg, lm_params, tokens), flush,
                             reps=5, warmup=1)
        prefill_busy = device_busy(lambda: TF.prefill(lm_cfg, lm_params, tokens), 1)
    log("[lm_prefill] " + json.dumps({
        "model": lm_cfg.name, "batch": LM_BATCH, "prompt": LM_PROMPT,
        "first_call_wall_ms": prefill_s * 1e3, "device_median_ms": prefill_ms,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / (prefill_ms / 1e3),
        "peak_memory_gb": peak_gb, "launches": prefill_launches,
        "profile": prefill_busy,
    }))

    # ------------------------------------------------------------- lm_decode
    def run_decode(cfg, params, last, kv, batch, cache_len, steps, busy_calls, kernels=()):
        """``steps`` greedy ``decode_step``s after a prefill (its last logits
        and caches ``kv``) against caches of ``cache_len`` positions, launch
        counts reset before them, one event pair a step and no host sync in
        the loop; then ``busy_calls`` more steps under the profiler from the
        first position again.  Checks that the steps' logits are finite;
        returns them, the tokens generated, the launches and the summary."""
        prompt = kv[0].shape[2]
        cache = TF.init_decode_cache(cfg, batch, cache_len, device=dev)
        for c, c_ in zip(cache, kv):
            c[:, :, :prompt] = c_
        tok = last[:, :cfg.vocab].argmax(-1).to(torch.int32)
        pos = torch.tensor(prompt, dtype=torch.int32, device=dev)
        events, generated = [], []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(steps):  # no host sync inside the loop
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                logits, cache = TF.decode_step(cfg, params, cache, tok, pos)
                end.record()
                events.append((start, end))
                tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
                generated.append(tok)
                pos += 1
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        if logits.shape != (batch, cfg.padded_vocab()) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name} decode logits not finite: {tuple(logits.shape)}")
        if int(pos) != prompt + steps:
            raise AssertionError(f"{cfg.name} decode ended at position {int(pos)}")
        step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
        pos.fill_(prompt)

        def step():
            tok_ = TF.decode_step(cfg, params, cache, tok, pos)[0]
            pos.add_(1)
            return tok_

        with torch.no_grad():
            busy = device_busy(step, busy_calls, kernels=kernels)
        del cache
        return logits, generated, launches, {
            "steps": steps, "wall_s": wall_s, "step_wall_median_ms": statistics.median(step_ms),
            "step_wall_ms_min_max": [min(step_ms), max(step_ms)],
            "step_device_busy_ms": busy["device_busy_ms"],
            "decode_tokens_per_s": batch * steps / wall_s, "launches": launches,
            "profile": busy}

    logits, generated, decode_launches, decode_run = run_decode(
        lm_cfg, lm_params, last, (kc, vc), LM_BATCH, LM_CACHE, LM_DECODE_STEPS, 2)
    del kc, vc
    want_launches = lm_cfg.n_layers * LM_DECODE_STEPS
    if decode_launches["flash_decode"] != want_launches:
        raise AssertionError(f"lm_decode launched K7 {decode_launches['flash_decode']} "
                             f"times, want {want_launches}")
    log("[lm_decode] " + json.dumps({
        "model": lm_cfg.name, "batch": LM_BATCH, "cache": LM_CACHE, **decode_run,
        "first_tokens_generated": torch.stack(generated[:4], 1).tolist()}))
    del logits, last, tokens
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- lm_checks
    def prefill_then_decode(cfg_, params_, toks, prompt, device):
        """Last prefill logits, then each teacher-forced decode step's, and
        the caches after the steps."""
        toks = toks.to(device)
        steps = toks.shape[1] - prompt
        with torch.no_grad():
            last_, (kc_, vc_) = TF.prefill(cfg_, params_, toks[:, :prompt])
            kd, vd = TF.init_decode_cache(cfg_, toks.shape[0], prompt + steps, device=device)
            kd[:, :, :prompt] = kc_
            vd[:, :, :prompt] = vc_
            outs = [last_]
            for i in range(steps):
                p_ = torch.tensor(prompt + i, dtype=torch.int32, device=device)
                outs.append(TF.decode_step(cfg_, params_, (kd, vd), toks[:, prompt + i], p_)[0])
        return torch.stack(outs), kd, vd

    log("[lm_checks] f32 compute, TF32 off")
    reset_counts()  # the lm_f32 path (the CPU's half takes the plain versions)
    cut_cfg = dataclasses.replace(lm_cfg, n_layers=LM_CUT_LAYERS, compute_dtype=f32)
    cut_params = dict(lm_params, layers={k: v[:LM_CUT_LAYERS]
                                         for k, v in lm_params["layers"].items()})
    cut_toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(1), lm_cfg.vocab, 2,
                                             LM_CUT_PROMPT + LM_CHECK_STEPS)["tokens"])
    on_card = prefill_then_decode(cut_cfg, cut_params, cut_toks, LM_CUT_PROMPT, dev)
    on_cpu = prefill_then_decode(cut_cfg, tree_to(cut_params, "cpu"), cut_toks,
                                 LM_CUT_PROMPT, "cpu")
    for what, got, want in zip(("logits", "k cache", "v cache"), on_card, on_cpu):
        assert_close(f"lm {LM_CUT_LAYERS}-layer cut, full width, prefill {LM_CUT_PROMPT} + "
                     f"{LM_CHECK_STEPS} decode steps: {what} on the card (K6/K7) vs the CPU "
                     "(plain versions)", got.cpu(), want, 1e-4, 1e-4)
    del on_card, on_cpu, cut_params
    deep_cfg = dataclasses.replace(lm_cfg, compute_dtype=f32)
    deep_toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(2), lm_cfg.vocab, 2,
                                              LM_DEPTH_PROMPT + LM_CHECK_STEPS)["tokens"])
    stepped = prefill_then_decode(deep_cfg, lm_params, deep_toks, LM_DEPTH_PROMPT, dev)[0]
    with torch.no_grad():
        full = TF.forward(deep_cfg, lm_params, deep_toks.to(dev))[0]
    lm_f32_launches = launch_counts()
    require("lm_f32", lm_f32_launches, ("flash_attention", "flash_attention_f32",
                                        "flash_decode"))
    if lm_f32_launches["flash_attention_f32"] != lm_f32_launches["flash_attention"]:
        raise AssertionError(f"lm_f32 launched K6 outside f32: {lm_f32_launches}")
    want = full[:, LM_DEPTH_PROMPT - 1:].transpose(0, 1)  # [steps + 1, B, Vp]
    assert_close(f"lm full depth f32: prefill {LM_DEPTH_PROMPT} + {LM_CHECK_STEPS} decode "
                 f"steps vs one forward over {LM_DEPTH_PROMPT + LM_CHECK_STEPS} tokens",
                 stepped, want, 1e-3, 1e-3)
    del stepped, full, want, lm_params
    torch.cuda.empty_cache()

    # -------------------------------------------------------- lm_moe_prefill
    moe_cfg = serving_config(make_olmoe())
    E_, K_, F_ = moe_cfg.moe.num_experts, moe_cfg.moe.top_k, moe_cfg.moe.d_ff
    D_, L_ = moe_cfg.d_model, moe_cfg.n_layers
    t0 = time.perf_counter()
    moe_params = TF.init_params(moe_cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    expert_bytes = sum(moe_params["layers"][k].numel() * 2 for k in ("xg", "xu", "xd"))
    log(f"[lm_moe_prefill] {moe_cfg.name}: {moe_cfg.num_params():,} parameters in bf16 "
        f"({tree_size_bytes(moe_params) / 1e9:.2f} GB, experts {expert_bytes / 1e9:.2f} GB) "
        f"made on the card in {time.perf_counter() - t0:.2f}s")
    tokens = torch.from_numpy(syn.lm_batch(np.random.default_rng(0), moe_cfg.vocab, LM_BATCH,
                                           LM_PROMPT)["tokens"]).to(dev)
    cap = MOE.moe_capacity(moe_cfg.moe, LM_BATCH * LM_PROMPT)
    expert_flop = 2 * 3 * E_ * cap * D_ * F_ * L_
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        last, (kc, vc) = TF.prefill(moe_cfg, moe_params, tokens)
    torch.cuda.synchronize()
    moe_prefill_s = time.perf_counter() - t0
    moe_prefill_launches = launch_counts()
    if moe_prefill_launches["flash_attention"] != L_:
        raise AssertionError(f"lm_moe_prefill launched K6 "
                             f"{moe_prefill_launches['flash_attention']} times, want {L_}")
    Vp = moe_cfg.padded_vocab()
    if last.shape != (LM_BATCH, Vp) or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"lm_moe_prefill last logits not finite [{LM_BATCH}, {Vp}]")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        moe_prefill_ms = cuda_ms(lambda: TF.prefill(moe_cfg, moe_params, tokens), flush,
                                 reps=5, warmup=1)
        moe_prefill_busy = device_busy(lambda: TF.prefill(moe_cfg, moe_params, tokens), 1,
                                       kernels=("flash_attention", "gemm", "sort"))
        with RoutingLog() as routing:  # one more call, uncounted: the drops
            TF.prefill(moe_cfg, moe_params, tokens)
    dropped = sum(int((kept < 0).sum()) for _, kept, _ in routing.calls)
    log("[lm_moe_prefill] " + json.dumps({
        "model": moe_cfg.name, "batch": LM_BATCH, "prompt": LM_PROMPT, "capacity": cap,
        "expert_tflop": expert_flop / 1e12,
        "dropped_assignment_share": dropped / (L_ * LM_BATCH * LM_PROMPT * K_),
        "first_call_wall_ms": moe_prefill_s * 1e3, "device_median_ms": moe_prefill_ms,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / (moe_prefill_ms / 1e3),
        "expert_tflop_per_s_at_the_median": expert_flop / 1e12 / (moe_prefill_ms / 1e3),
        "peak_memory_gb": peak_gb, "launches": moe_prefill_launches,
        "profile": moe_prefill_busy,
    }))
    del routing

    # --------------------------------------------------------- lm_moe_decode
    logits, _, moe_decode_launches, moe_decode_run = run_decode(
        moe_cfg, moe_params, last, (kc, vc), LM_BATCH, LM_CACHE, LM_DECODE_STEPS, 2,
        kernels=("flash_decode_kernel", "gemm"))
    del kc, vc
    if moe_decode_launches["flash_decode"] != L_ * LM_DECODE_STEPS:
        raise AssertionError(f"lm_moe_decode launched K7 {moe_decode_launches['flash_decode']} "
                             f"times, want {L_ * LM_DECODE_STEPS}")
    # A step runs every expert on its C = 8 slots: it reads all the experts.
    log("[lm_moe_decode] " + json.dumps({
        "model": moe_cfg.name, "batch": LM_BATCH, "cache": LM_CACHE,
        "capacity": MOE.moe_capacity(moe_cfg.moe, LM_BATCH),
        "expert_bytes_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3, **moe_decode_run}))
    del logits, last, tokens
    torch.cuda.empty_cache()

    # --------------------------------------------------------- lm_moe_checks
    log("[lm_moe_checks] f32 compute, TF32 off; routing compared first")
    reset_counts()  # the lm_moe_f32 path (the CPU's half takes the plain versions)
    cut_cfg = dataclasses.replace(moe_cfg, n_layers=LM_CUT_LAYERS, compute_dtype=f32)
    cut_params = dict(moe_params, layers={k: v[:LM_CUT_LAYERS]
                                          for k, v in moe_params["layers"].items()})
    cut_toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(1), moe_cfg.vocab, 2,
                                             LM_CUT_PROMPT + LM_CHECK_STEPS)["tokens"])
    with RoutingLog() as card_routes:
        on_card = prefill_then_decode(cut_cfg, cut_params, cut_toks, LM_CUT_PROMPT, dev)
    with RoutingLog() as cpu_routes:
        on_cpu = prefill_then_decode(cut_cfg, tree_to(cut_params, "cpu"), cut_toks,
                                     LM_CUT_PROMPT, "cpu")
    lay = (LM_CUT_LAYERS, 2, LM_CUT_PROMPT, LM_CHECK_STEPS)
    flagged, margins = routing_differs(f"lm_moe {LM_CUT_LAYERS}-layer cut, card vs CPU",
                                       card_routes.by_position(*lay),
                                       cpu_routes.by_position(*lay))
    log(f"  {LM_CUT_LAYERS}-layer cut: routing of {flagged.numel()} tokens x "
        f"{LM_CUT_LAYERS} layers, card vs CPU: {int(flagged.sum())} token(s) differ (left "
        f"out below; k-th margins of the near ties that start them: {margins})")
    rows = ~flagged[:, LM_CUT_PROMPT - 1:].T  # [steps + 1, B]: the compared logits
    moe_cut_err = {}
    for what, got, want in zip(("logits", "k cache", "v cache"), on_card, on_cpu):
        keep = rows if what == "logits" else ~flagged
        got = got.cpu()
        if what != "logits":  # [L, B, S, Hkv, dh] -> [B, S, L, Hkv, dh]
            got, want = got.permute(1, 2, 0, 3, 4), want.permute(1, 2, 0, 3, 4)
        moe_cut_err[what] = assert_close(
            f"lm_moe {LM_CUT_LAYERS}-layer cut, full width, prefill {LM_CUT_PROMPT} + "
            f"{LM_CHECK_STEPS} decode steps: {what} on the card (K6/K7) vs the CPU (plain "
            f"versions), {int(keep.sum())} of {keep.numel()} positions", got[keep],
            want[keep], *MOE_CUT_TOL)
    del on_card, on_cpu, cut_params, card_routes, cpu_routes
    # Decode against one forward: the forward routes all 2 x 1,028 tokens at
    # once, each decode step 2, so a capacity that drops nothing (factor
    # E / K: C >= T) makes them the same function.
    deep_cfg = dataclasses.replace(moe_cfg, compute_dtype=f32, moe=dataclasses.replace(
        moe_cfg.moe, capacity_factor=E_ / K_))
    deep_toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(2), moe_cfg.vocab, 2,
                                              LM_DEPTH_PROMPT + LM_CHECK_STEPS)["tokens"])
    with RoutingLog() as step_routes:
        stepped = prefill_then_decode(deep_cfg, moe_params, deep_toks, LM_DEPTH_PROMPT, dev)[0]
    with RoutingLog() as fwd_routes, torch.no_grad():
        full = TF.forward(deep_cfg, moe_params, deep_toks.to(dev))[0]
    lm_moe_f32_launches = launch_counts()
    require("lm_moe_f32", lm_moe_f32_launches, ("flash_attention", "flash_attention_f32",
                                                "flash_decode"))
    if lm_moe_f32_launches["flash_attention_f32"] != lm_moe_f32_launches["flash_attention"]:
        raise AssertionError(f"lm_moe_f32 launched K6 outside f32: {lm_moe_f32_launches}")
    lay = (L_, 2, LM_DEPTH_PROMPT, LM_CHECK_STEPS)
    flagged, margins = routing_differs("lm_moe full depth, decode path vs forward",
                                       step_routes.by_position(*lay),
                                       fwd_routes.by_position(*lay, forward=True))
    log(f"  full depth: routing of {flagged.numel()} tokens x {L_} layers, decode path vs "
        f"forward: {int(flagged.sum())} token(s) differ (near-tie margins {margins})")
    want = full[:, LM_DEPTH_PROMPT - 1:].transpose(0, 1)  # [steps + 1, B, Vp]
    rows = ~flagged[:, LM_DEPTH_PROMPT - 1:].T.to(dev)
    moe_depth_err = assert_close(
        f"lm_moe full depth f32: prefill {LM_DEPTH_PROMPT} + {LM_CHECK_STEPS} decode steps vs "
        f"one forward over {LM_DEPTH_PROMPT + LM_CHECK_STEPS} tokens, {int(rows.sum())} of "
        f"{rows.numel()} positions", stepped[rows], want[rows], *MOE_DEPTH_TOL)
    log("[lm_moe_checks] " + json.dumps({
        "cut_max_abs_err": moe_cut_err, "depth_max_abs_err": moe_depth_err,
        "launches": lm_moe_f32_launches}))
    del stepped, full, want, step_routes, fwd_routes, moe_params
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------- lm_sharded_decode
    sd_cfgs = {arch: sharded_decode_config(arch) for arch in SHARDED_DECODE_STEPS}
    sd_from = {"olmoe": "olmoe", "qwen2": "qwen2", "qwen2_f32": "qwen2"}  # whose params
    sd_params = {arch: TF.init_params(sd_cfgs[arch], seed=0, device=dev, mesh=M.AbstractMesh(
        next(c[2] for c in SHARDED_DECODE_CASES if c[1] == arch), ("data", "model")))
        for arch in set(sd_from.values())}
    sd_gen = torch.Generator(device=dev).manual_seed(4)
    sd_cases = []
    t_sd = time.perf_counter()
    for name, arch, shape, b, batch_axes, seq_axes, S_, pos0 in SHARDED_DECODE_CASES:
        cfg, steps = sd_cfgs[arch], SHARDED_DECODE_STEPS[arch]
        cache = TF.init_decode_cache(cfg, b, S_, device=dev)
        for c in cache:  # the prompt's rows random, NaN past the steps' rows: never read
            c[:, :, :pos0].normal_(generator=sd_gen)
            c[:, :, pos0 + steps:] = float("nan")
        toks = torch.randint(0, cfg.vocab, (steps, b), generator=sd_gen, device=dev,
                             dtype=torch.int32)
        work = tuple(c.clone() for c in cache)
        pos = torch.tensor(pos0, dtype=torch.int32, device=dev)
        want = []
        with torch.no_grad():
            for i in range(steps):
                want.append(TF.decode_step(cfg, sd_params[sd_from[arch]], work, toks[i],
                                           pos)[0])
                pos += 1
        del work
        sd_cases.append({"name": name, "arch": arch, "cfg": cfg, "params": sd_from[arch],
                         "mesh": shape,
                         "batch_axes": batch_axes, "seq_axes": seq_axes, "cache": cache,
                         "tokens": toks, "pos": pos0, "want": torch.stack(want)})
    torch.cuda.synchronize()
    sd_one_device_s = time.perf_counter() - t_sd
    sd_out = M.spawn(lm_sharded_rank, SHARDED_RANKS, (sd_params, sd_cases),
                     timeout=SHARDED_DECODE_TIMEOUT_S)
    sd_launches, sd_ring = {}, {}
    for name, arch, shape, b, batch_axes, seq_axes, S_, pos0 in SHARDED_DECODE_CASES:
        cfg, steps = sd_cfgs[arch], SHARDED_DECODE_STEPS[arch]
        sizes = dict(zip(("data", "model"), shape))
        sd_ring[name] = ring = lm_decode_ring_bytes(cfg, sizes, b, batch_axes, seq_axes,
                                                    ("data",), steps)
        wp = sd_params[sd_from[arch]]
        whole = {"layers": sum(t.numel() * t.element_size() for t in tree_leaves(wp["layers"])),
                 "embed_and_head": sum(wp[k].numel() * wp[k].element_size()
                                       for k in ("embed", "head"))}
        share = {"layers": sizes["model"] * (sizes["data"] if cfg.fsdp else 1),
                 "embed_and_head": sizes["model"]}
        for r, res in enumerate(sd_out):
            run = res[name]
            want_k7 = cfg.n_layers * steps
            if run["launches"]["flash_decode_partial"] != want_k7 \
                    or run["launches"]["flash_decode"] != want_k7:
                raise AssertionError(f"lm_sharded_decode rank {r} {name}: K7 launched "
                                     f"{run['launches']}, want {want_k7} in its shard mode")
            if run["bytes"] != ring:
                raise AssertionError(f"lm_sharded_decode rank {r} {name}: bytes {run['bytes']}"
                                     f" != the ring model's {ring}")
            # every matrix a share of the whole; norms, router and biases whole
            for part, n in share.items():
                if not run["param_bytes"][part] * n <= whole[part] * 1.01:
                    raise AssertionError(f"lm_sharded_decode rank {r} {name}: holds "
                                         f"{run['param_bytes'][part]} B of {part}, over 1/{n} "
                                         f"of the whole {whole[part]} B")
            for k, v in run["launches"].items():
                sd_launches[k] = sd_launches.get(k, 0) + v
        log(f"  [lm_sharded_decode] {name}: param bytes per rank "
            f"{[res[name]['param_bytes'] for res in sd_out]} of {whole}; K7 shard launches per "
            f"rank {[res[name]['launches']['flash_decode_partial'] for res in sd_out]}; bytes "
            f"per rank = the ring model's {ring}")
    log("[lm_sharded_decode] " + json.dumps({
        "card": nvidia_smi(),
        "configs": {arch: f"{cfg.name} widths, {cfg.n_layers} layers, params "
                          f"{str(cfg.param_dtype)[6:]}, compute {str(cfg.compute_dtype)[6:]}, "
                          f"fsdp {cfg.fsdp}" for arch, cfg in sd_cfgs.items()},
        "backend": "gloo, CUDA tensors staged through host memory (walls: no interconnect)",
        "one_device_reference_s": sd_one_device_s,
        "cases": {name: {
            "config": arch, "mesh": {"data": shape[0], "model": shape[1]}, "batch": b,
            "batch_axes": list(batch_axes), "seq_axes": list(seq_axes), "cache": S_,
            "first_position": pos0, "steps": SHARDED_DECODE_STEPS[arch],
            "coords_per_rank": [r[name]["coords"] for r in sd_out],
            "param_bytes_per_rank": [r[name]["param_bytes"] for r in sd_out],
            "cache_block_per_rank": [r[name]["cache_block"] for r in sd_out],
            "bytes_per_rank": sd_out[0][name]["bytes"], "ring_model_bytes": sd_ring[name],
            "max_abs_err_per_rank": [r[name]["max_abs_err"] for r in sd_out],
            "steps_wall_s_per_rank": [r[name]["wall_s"] for r in sd_out],
        } for name, arch, shape, b, batch_axes, seq_axes, S_, pos0 in SHARDED_DECODE_CASES},
        "launches": sd_launches,
    }))
    del sd_params, sd_cases, sd_out
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- lm_moe_wide
    wide, wide_launches = {}, {}
    for arch, n_layers in WIDE_CUTS:
        wcfg = dataclasses.replace(serving_config(wide_configs[arch]()), n_layers=n_layers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wparams = TF.init_params(wcfg, seed=0, device=dev)
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0
        wtok = torch.from_numpy(syn.lm_batch(np.random.default_rng(3), wcfg.vocab, WIDE_BATCH,
                                             LM_PROMPT)["tokens"]).to(dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            wlast, (kc, vc) = TF.prefill(wcfg, wparams, wtok)
        torch.cuda.synchronize()
        wprefill_s = time.perf_counter() - t0
        wprefill_launches = launch_counts()
        if wprefill_launches["flash_attention"] != n_layers \
                or not bool(torch.isfinite(wlast).all()):
            raise AssertionError(f"lm_moe_wide {arch} prefill: K6 "
                                 f"{wprefill_launches['flash_attention']} times (want "
                                 f"{n_layers}), finite {bool(torch.isfinite(wlast).all())}")
        with torch.no_grad():
            wprefill_ms = cuda_ms(lambda: TF.prefill(wcfg, wparams, wtok), flush, reps=3,
                                  warmup=1)
        wlogits, _, wdecode_launches, wdecode_run = run_decode(
            wcfg, wparams, wlast, (kc, vc), WIDE_BATCH, WIDE_CACHE, WIDE_DECODE_STEPS, 1,
            kernels=("flash_decode_kernel", "gemm"))
        del kc, vc
        if wdecode_launches["flash_decode"] != n_layers * WIDE_DECODE_STEPS:
            raise AssertionError(f"lm_moe_wide {arch} decode: K7 "
                                 f"{wdecode_launches['flash_decode']} times (want "
                                 f"{n_layers * WIDE_DECODE_STEPS})")
        wbytes = tree_size_bytes(wparams)
        # a step reads every weight once, but of the token table B rows only
        step_bytes = wbytes - wparams["embed"].numel() * wparams["embed"].element_size()
        wide[arch] = {
            "layers": f"{n_layers} of {wide_configs[arch]().n_layers}",
            "params": wcfg.num_params(), "param_gb": wbytes / 1e9, "made_s": made_s,
            "heads": [wcfg.n_heads, wcfg.n_kv_heads, wcfg.d_head],
            "prefill_first_call_wall_ms": wprefill_s * 1e3,
            "prefill_device_median_ms": wprefill_ms,
            "prefill_tokens_per_s": WIDE_BATCH * LM_PROMPT / (wprefill_ms / 1e3),
            "step_weights_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "prefill_launches": {k: v for k, v in wprefill_launches.items() if v},
            **wdecode_run, "launches": {k: v for k, v in wdecode_launches.items() if v},
        }
        log(f"[lm_moe_wide] {arch} " + json.dumps(wide[arch]))
        wide_launches.update({f"lm_wide_prefill.{arch}": wprefill_launches,
                              f"lm_wide_decode.{arch}": wdecode_launches})
        del wparams, wlast, wlogits, wtok
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------- lm_train .. lm_registry
    lmt = lm_train(dev, k6b_planted)

    # -------------------------------------------------- lm_tp_prefill, lm_tp_train
    tp = lm_tp(dev)

    # ---------------------------------------------------------------- dryrun
    dry = dryrun(dev, lmt["lm_train"])

    # ---------------------------------------------------------- kernels line
    sources = {
        "embedding_bag": "src/repro/kernels/embedding_bag.py:38",
        "dot_interaction": "src/repro/kernels/dot_interaction.py:28",
        "probe_gather_pool": "src/repro/hotcache/kernels.py:64",
        "scatter_update": "src/repro/hotcache/kernels.py:122",
        "topk_neighbor_select": "src/repro/prefetch/kernels.py:66",
        "flash_attention": "src/repro/kernels/flash_attention.py:76",
        "flash_decode": "src/repro/kernels/flash_decode.py:69",
    }
    paths = {"forward": fwd_launches, "serve": srv_launches,
             "cached_forward": cached_launches, "serve_prefetch": pf_launches,
             "serve_open_loop": ol_launches, "serve_chaos": chaos_launches,
             "serve_reshard": rs_launches, "train": train_launches,
             "sharded_forward": sh_fwd_launches, "sharded_train": sh_train_launches,
             "lm_prefill": prefill_launches, "lm_decode": decode_launches,
             "lm_f32": lm_f32_launches, "lm_moe_prefill": moe_prefill_launches,
             "lm_moe_decode": moe_decode_launches, "lm_moe_f32": lm_moe_f32_launches,
             "lm_sharded_decode": sd_launches, **wide_launches, **archs["paths"],
             **cells["paths"], **demo_res["paths"], **gnn_res["paths"], **gnn_sh["paths"],
             **lmt["paths"], **tp["paths"], **dry["paths"]}
    kernels = []
    for name, replaces in sources.items():
        ms, plain_ms, lib_ms = timings[name]
        bms, by = bounds[name]
        by_path = {p: c[name] for p, c in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "ok": True,
        })
        if name in read_flushed:
            kernels[-1]["ms_read_flush"] = read_flushed[name]
        if name in backward:  # K1' and K2', the train path's backward kernels
            kernels[-1]["backward"] = {
                **backward[name], "name": f"{name}_backward",
                "launches_by_path": {p: c[f"{name}_backward"] for p, c in paths.items()},
            }
        if name == "embedding_bag":  # timed in the masked mode, the main path's
            kernels[-1]["backward"]["train_shapes"] = archs["k1b_train_shapes"]
            kernels[-1].update({
                "forward_shapes": archs["k1_forward_shapes"],
                "mode": "masked", "bound_ms_weighted": k1_weighted["bound_ms"],
                "masked_launches_by_path": {p: c["embedding_bag_masked"]
                                            for p, c in paths.items()},
                "weighted": k1_weighted,
            })
        if name == "flash_decode":  # the shard mode, timed on lm_sharded_decode's shard
            kernels[-1]["partial"] = {
                "name": "flash_decode_partial", "times_by_dtype": k7p_rows,
                "launches_by_path": {p: c["flash_decode_partial"] for p, c in paths.items()},
            }
        if name == "flash_attention":  # timed in bf16 (lm_prefill's); f32 beside it
            f32_keys = ("case", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                        "bound_ms_fma", "max_abs_err")
            kernels[-1]["f32"] = {  # at lm_f32's shape, then at lm_prefill's
                **{key: k6_f32["lm_f32 f32"][key] for key in f32_keys},
                "launches_by_path": {p: c["flash_attention_f32"] for p, c in paths.items()},
                "prefill_shape": {key: k6_f32["path f32"][key] for key in f32_keys},
            }
            # with its row logsumexp (the train path's forward, K6''s input),
            # beside the same launch without it, its plain version, SDPA and
            # its bound, at phase 9g's timed cases
            kernels[-1]["trainer"] = k6_trainer
            kernels[-1]["host_split"] = k6_host
            kernels[-1]["lse"] = [{key: r[key] for key in (
                "case", "k6_forward_ms", "k6_forward_lse_ms", "k6_forward_plain_ms",
                "k6_forward_library_ms", "k6_forward_bound_ms")} for r in lmt["k6b_rows"]]
    # K6', the backward of K6: no Pallas kernel; the reference differentiates
    # its jnp attention with XLA.  Timed at lm_train's layer (stablelm-3b).
    k6b_path = next(r for r in lmt["k6b_rows"] if r["case"].startswith("stablelm bf16"))
    k6b_by_path = {p: c["flash_attention_backward"] for p, c in paths.items()}
    kernels.append({
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_backward.cu",
        "replaces": "none: XLA's autodiff of src/repro/models/layers.py:109 "
                    "(gqa_prefill_attention), no pallas_call",
        "launches": sum(k6b_by_path.values()), "launches_by_path": k6b_by_path,
        "f32_launches_by_path": {p: c["flash_attention_backward_f32"]
                                 for p, c in paths.items()},
        "max_abs_err": max(lmt["k6b_errs"].values()), "ms": k6b_path["ms"],
        "plain_ms": k6b_path["plain_ms"], "bound_ms": k6b_path["bound_ms"],
        "bound_by": k6b_path["bound_by"], "library_ms": k6b_path["library_ms"],
        "case": k6b_path["case"], "cases": lmt["k6b_rows"], "max_abs_err_by_case":
            lmt["k6b_errs"], "ok": True,
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
