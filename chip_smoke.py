#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py              # the full run: 100k x 128 vectors, 50k in 64 segments
    python3 chip_smoke.py --n 50000    # quick

Phases, each printing one JSON line (any failure raises, so the exit is
non-zero and no result line is printed):

1. device   the card's name and power limit; nvcc builds the seven kernels
            from ``src/repro_torch/kernels/csrc`` in parallel (seconds).
2. kernels  each kernel on the card at the paths' shapes, held against its
            plain PyTorch version (int32 tables bit-equal, float32 tables
            and ``l2_batch``/``sq_l2`` allclose, routes equal), timed
            beside its bound, the plain version and (``l2_batch``)
            ``torch.cdist``; ``flash_beam`` (1,000 queries over the
            phase's n-vertex graph, ef ∈ {64, 256}, W ∈ {1, 4}, and the
            build's 32-query insert batch) is also held bit-equal to, and
            timed beside, the loop of ``flash_expand`` launches it
            replaces; ``l2_batch`` is timed with L2 cold over a rotation of
            chunks (and warm), against its 3xTF32 and float32-FMA bounds,
            and held at the card tests' odd shapes too. ``torch.profiler``
            gives the device time of ``flash_expand``,
            ``flash_scan_blocked``, ``flash_beam`` and ``l2_batch`` beside
            the events'. Packed mirrors of M ∈ {5, 6, 7, 8, 12, 24} (rows
            that are not whole 8-byte words; an odd M's padding nibble set)
            take the byte-wise layout, bit-equal to the plain versions; M = 8
            is timed beside the M = 16 word row, and so is the M = 16 mirror
            read byte-wise (a copy off an 8-byte boundary). The shapes that
            raised before the limits were repaired: an (M, K) = (64, 256)
            int32 table (64 KiB) through ``flash_round``, ``flash_scan``,
            ``flash_scan_blocked`` and ``flash_expand``, and ``flash_beam``
            at W = 16, R = 96 (1,536 slots on 1,024 threads), ef ∈ {64,
            256}, against its plain version and the ``flash_expand`` loop:
            bit-equal. The flat graphs' shapes (``generality``): bulk
            rounds' (B, C) ∈ {16,384, 8,616} × {32, 48, 112} through
            ``flash_round``, ``flash_beam`` at W = 4, R = 24 with a quarter
            of the slots empty (ef 128, Q 1,000; ef 64, Q 32): bit-equal.
            ``l2_batch`` at the flash-ann width (1,024 x 100,000 x 768, the
            wide plan) against its plain version, with its top-10 ids.
3. build    ``AnnIndex.build(algo="hnsw", backend="flash_blocked",
            strategy="bulk")`` over the ``--n`` base rows of one
            ``vector_dataset(seed=0, n=--n + 1,000, d=128, n_clusters=64)``
            draw (SIFT1M's shape): seconds and n_dists per phase.
4. search   1,000 held-out queries, k = 10, exact rerank, ef ∈ {64, 256},
            width ∈ {1, 4}: QPS, recall@10 and ``flash_beam`` launches
            against the port's ``exact_knn`` (kernel ``l2_batch``), itself
            cross-checked on all 1,000 queries against a plain loop (ids
            may differ only at near ties; they are counted), and its time
            split into ``l2_batch`` device time and the rest; the unfused
            step loop must return the fused beam's ids; a profiler window
            over one search (ef = 64, W = 1) each way gives the device busy
            share and the top five kernels by device time.
5. check    on small inputs the card's path equals the plain CPU path: beam
            search on the built index with the same query tables, a whole
            5k-vector build from the same coder, and an 8k-row
            ``SegmentedAnnIndex`` (4 segments) built on the card, restored
            on the CPU, then grown, pruned, compacted and searched on both;
            and HNSW, Vamana and NSG, bulk and incremental, over fp32 and
            hand-made PQ (integer codebooks), SQ (s2 = 1) and PCA (zero
            mean, identity columns) backends on 500 integer rows in
            [−8, 8] at D = 32 (every distance an exact float32 integer):
            graphs, distances, entries and n_dists equal on card and CPU;
            and flat Vamana and NSG over ``flash_blocked`` at r_base 24,
            W 4 (bulk over 5,000 rows, incremental over 1,000, the NSG
            from one k-NN graph) from one coder fitted on the card: graphs,
            n_dists and a search at ef 128 equal where the query tables
            agree.
6. incremental  the paper's build, ``AnnIndex.build(strategy="incremental")``
            with ``BuildParams()`` and the main path's coder over the first
            ``--n-inc`` rows of the same draw: seconds (bootstrap, insert
            batches), n_dists by phase (bootstrap, beam_upper and beam_base
            must be non-zero), insert batches and ``flash_beam`` launches
            (one per batch), recall@10 at ef ∈ {64, 256}, W ∈ {1, 4}
            against ``exact_knn`` over those rows, a profiler window over 5
            insert batches (busy share, top five kernels, host and card ms
            per batch); beside it the bulk build of the same rows (counted
            apart, as ``incremental_bulk``); and a
            500-row incremental build with an M = 8 coder (the byte-wise
            mirror layout) on the card and on the CPU from one coder's
            state, bit-equal where the query tables agree.
7. snapshot the main index saved with ``serve.snapshot.save_index`` and
            loaded back on the card (save and load seconds, bytes): the
            1,000 queries at ef = 64, W = 1 must return the live ids and
            distances. Then ``ShardedBuilder(workers=2, snapshot_path=…,
            attach=True)`` over the first 4,096 rows in 8 segments (a spawn
            pool sharing the card) must attach segments bit-equal to the
            inline build of the same plan; both walls and
            ``model_parallel_wall`` of the inline walls.
7d. serving  the serving runtime (``repro_torch.serve``) over the main
            path's live index, k = 10, ef = 64, W = 1, exact rerank:
            ``SearchEngine`` (buckets 1/8/32) serves the 1,000 queries in
            blocks cycling through 1, 3, 8, 17, 32, 45 (45 chunked): no
            cold key after ``warmup``, ids equal ``index.search``'s,
            distances within rtol 1e-5, one ``flash_beam`` launch per
            padded dispatch; QPS and p50/p99 per block size, the device
            busy share of 100 one-query dispatches. ``Runtime`` (8
            closed-loop client threads, deadline 50 ms, max_wait 2 ms,
            max_queue 256), three waves of single-query requests: 1,000
            with no mutation; as many as arrive while ``add`` of 256 new
            rows of the main draw's distribution then ``delete`` of 10,000
            ids run, and 1,000 more (no request submitted after the delete
            resolved returns a deleted id, 0 cold dispatches); 1,000 after
            both (ids equal a direct search of the
            current generation); QPS, p50/p99, mean packed batch,
            admission counts and each flip's clone/apply/warm seconds.
            Durability: ``init_durable`` → ``attach`` → a Runtime adds
            256 rows and deletes 5,000 → ``recover`` on the card:
            graph, levels, entry, tombstones bit-equal, same ids; WAL
            bytes, fsyncs, replay seconds, ``verify_root``. The snapshot
            phase's 8-segment pool manifest adopted by
            ``init_from_manifest``, one WAL ``add`` of 256 rows replayed
            by ``recover`` (routed by ``l2_batch``): equal to a live
            ``add``. A future that raises (other than the admission
            policy's shed or reject, which are counted) or a supervisor
            restart fails the run.
7b. baselines  the paper's build-speed comparison: bulk HNSW with
            ``BuildParams()`` over the first ``--n-base`` (25,000) rows of the main
            draw for fp32, pq (m = 16, l_pq = 8, 10 k-means iterations), sq
            (8 bits), pca (α = 0.9) and ``flash_blocked`` (the main path's
            coder) (``benchmarks/bench_indexing.py:212-215``): coder fit and
            build seconds by phase, n_dists, index bytes, recall@10 and QPS
            at ef ∈ {64, 256}, W = 1, exact rerank (and reconstruct rerank
            at ef = 256 for the coded backends), each build's seconds over
            fp32's. The four baseline builds launch no Flash kernel. Each
            coded backend's recall at ef = 256 must reach half that of a
            scan of all its codes keeping 256.
7c. generality  Vamana and NSG (knn_k = 24), bulk, over fp32 and
            ``flash_blocked`` on the same rows with
            ``benchmarks/bench_generality.py:24-26``'s parameters (r_upper
            8, r_base 24, ef 64, batch 32, W 4, α 1.2): build seconds,
            n_dists, recall@10 and QPS at ef = 128 (Flash: at least half
            that of a scan of its codes keeping 128); every
            ``flash_blocked`` build launches ``flash_round`` and
            ``flash_beam``, every search ``flash_beam``.
8. sharded  the scale-out path: ``ShardedBuilder`` streams the first
            ``N_SCALE`` − ``ADD_ROWS`` rows (of ``--n``'s at most) into 64 balanced
            segments (inline,
            each a bulk Flash-HNSW build): assignment
            seconds (bootstrap, streaming pass), segment sizes, the sum and
            the largest of the per-segment build seconds, n_dists; the
            rows whose segment differs when the same capacity-capped
            routing runs on the plain version's distances (on the card,
            and on the CPU against the card), counted.
9. segmented_search  the held-out queries, k = 10, exact rerank, ef ∈ {64,
            256}, W = 4, the default fan-out (one card: the loop over
            segments): QPS, recall@10 against phase 4's ground truth,
            n_scan, n_rerank, ``flash_beam`` launches (one per segment
            and search); the fan-out threads must return the same ids.
10. maintenance  ``add`` the last ``ADD_ROWS`` rows (routed by ``nearest_centroid``),
            search, ``delete`` 10,000 ids, search (ef = 256, W = 4): no
            deleted id may come back; recall
            against an exact k-NN of the live rows.
10b. serving_router  ``SegmentRouter`` over phase 10's collection, 256
            queries, k = 10, ef = 64, W = 4: at n_probe = 64 the ids equal
            ``SegmentedAnnIndex.search``'s, the fan-out threads equal the
            loop; QPS and recall@10 (against the live rows' exact k-NN) at
            n_probe ∈ {1, 4, 64}.
11. retrieval  BERT4Rec next-item retrieval at the model's full config
            (1,048,575 items, D = 64, 2 blocks, 2 heads, S = 200): rows
            [0, n) of the item table hold a normalized
            ``vector_dataset(0, d=64, n_clusters=256)``; 64 sessions (and
            one) go through ``serve``; a Flash coder (d_f = 48, M = 16) codes
            the table; ``score_dense``, ``score_flash`` (k = 10, rerank 8;
            k = 100, rerank 4) are timed at B = 64 and B = 1, with recall@10
            against dense for the encoder queries and 64 near-item queries.
            Then ``retrieval_graph``: an ``AnnIndex`` over the whole table
            on the scan's coder and codes, ``search_index`` at ef = 96
            and 512 (build seconds, QPS, recall@10; on the near-item
            queries at ef = 512 it must reach ½ of ``score_flash``'s).
            ``flash_scan`` must equal its plain version
            over the catalog, and the card's ``score_flash`` ids the CPU
            path's on 8 queries whose query tables agree.
12. training  BERT4Rec training (``repro_torch.train``). (a) The train
            step (``make_train_step``, 2 microbatches) at the reduced config
            on the card against the CPU from one set of parameters and the
            same 3 batches, once per compression (none, bf16, int8_ef):
            loss and lr at rtol 1e-5, grad_norm at rtol 1e-4, every state
            element within atol/rtol 1e-4 except at most 1 in 10,000, each
            within 2·steps·lr. (b) ``train`` at the full config for 30
            steps of 64 sessions (8 microbatches of 8; AdamW lr 3e-3,
            constant), batches from ``sharded_batches`` seeded by (seed,
            step), a checkpoint every 10 steps, keep 2: s per step (median
            of steps 6–30), sessions and masked positions per second, peak
            memory, the loss at steps 1 and 30 (it must fall), checkpoint
            bytes and save / restore s, and the card's busy share over 2
            steps under the profiler. (c) The step-20 checkpoint restored
            into a fresh state and trained to step 30: the history continues
            at step 21 and the state equals (b)'s by (a)'s rule. (d) The
            step-30 checkpoint restored into a fresh ``Bert4Rec``; 64
            sessions ending in [MASK] through ``serve``; a Flash coder
            (d_f = 48, M = 16) on the trained table; ``score_flash`` (k =
            10, rerank 8) with one ``flash_scan`` launch per query and the
            CPU path's ids on 8 queries whose query tables agree; recall@10
            against ``score_dense``.
13. lm_serving  the LM family (``repro_torch.models.transformer``)
            serving prefill and greedy decode at full width, random weights
            from a seeded generator, bf16 compute: llama3.2-3b (28 layers)
            at B = 2 × S = 32,256 into caches of 32,768, 64 tokens;
            deepseek-v3-671b cut to 4 layers (3 dense + 1 MoE of 256
            experts) at B = 2 × S = 4,096, 32 tokens; qwen1.5-0.5b (24
            layers) at B = 2 × S = 4,096, 32 tokens. Per config: prefill s
            (after a warm-up prefill of 512 tokens) and tokens/s, decode ms
            per step (median) and tokens/s, model FLOPs over seconds against
            the dense bf16 peak (the reference's formulas), peak memory, a
            profiler window over 2 decode steps and one over the prefill at
            full length through one layer of each kind. (a) Decoding the last prompt token at S − 1 against the
            prefill's caches gives the prefill's argmax on every row and
            logits within ``LM_DECODE_ATOL`` (the MoE config at a 64-token
            prompt and a capacity factor at which no token is dropped). (b)
            The five reduced configs, and llama3.2-3b's full width at depth
            2, in float32: the card's prefill logits and caches and 4 decode
            steps equal the CPU path's within ``LM_CARD_ATOL``; the card's
            side again with TF32 on is printed as the control. No kernel
            of the repo runs here: the products and attention are plain
            PyTorch, as the reference computes them outside Pallas.
14. lm_training  the LM family trained (``repro_torch.train.train``, the
            donated step, over ``transformer.lm_loss``) at full width on
            ``lm_batch`` data at S = 4,096 (``train_4k``), seeded random
            weights, bf16 compute, remat on, ``lm_opt_cfg``'s moments, lr
            3e-4 constant after 2 warm-up steps, 8 steps: llama3.2-3b (28
            layers, B 1), qwen1.5-0.5b (24 layers, 2 microbatches of 1),
            moonshot-v1-16b-a3b cut to 5 layers (1 dense + 4 MoE) and
            deepseek-v3-671b cut to its 3 dense MLA layers and the MTP
            block (B 1 each). Per config: s per step (median of steps
            3–8), tokens/s, model FLOPs/s over the dense bf16 peak,
            peak memory, the losses and a profiler window over 1 more
            step. (a) The loss falls (the mean of the last 3 steps below
            step 1) and every loss and grad_norm is finite. (b) One float32
            step (float32 storage too, TF32 off) on the card against the
            CPU from one set of weights and one batch, on the five reduced
            configs, moonshot at capacity factor 1.0 (tokens drop) and
            llama3.2-3b's full width at depth 2: the loss, each metric,
            grad_norm and every parameter and moment leaf after the step
            within ``LM_TRAIN_CARD_RTOL`` of the tensor's largest
            magnitude (a parameter within 2·lr more); the card's step
            again with TF32 on must exceed it. One line per config
            (``lm_training_cell``), then the phase's. No kernel of the
            repo runs here either.
15. gnn_training  the GNN family (GatedGCN, EGNN, NequIP, Equiformer-v2)
            at full width trained by ``train`` (the donated step over
            ``launch/steps.gnn_loss_fn``), float32, TF32 off, the bundle's
            ``AdamWConfig()``, 6 steps, on three cells:
            ``full_graph_sm`` (2,708 nodes, 10,556 edges, d 1,433) and
            ``molecule`` (128 graphs, 3,840 nodes, 8,192 edges, d 8), one
            seeded ``random_graph_batch`` each, padded as the bundle pads;
            ``minibatch_lg``, successive ``minibatch_stream`` subgraphs of
            1,024 seeds (Equiformer 128), fanout 15-10, over
            ``random_csr_graph(232,965 nodes, avg degree 50)`` with seeded
            602-wide features. EGNN's positions are N(0, 0.1²): at the
            others' N(0, 2²) the reference's EGNN diverges at full depth,
            which ``egnn_reference_geometry`` records. Per cell: s per
            step (median of steps 3–6), edges/s, ``gnn_train_flops`` over s against the float32 peak,
            peak memory, the losses, launches per step, busy share and top
            kernels over 1 more step. (a) The loss falls and every loss
            and grad_norm is finite. (b) One float32 ``gnn_train_step``
            (``AdamWConfig()``) card against CPU on the four reduced configs
            at ``molecule``, GatedGCN at full width and Equiformer at full
            width, depth 2: the loss, grad_norm and every parameter and
            moment leaf within ``GNN_TRAIN_CARD_RTOL`` of the tensor's
            largest magnitude (a parameter within 2·lr more); the card's
            step again with TF32 on is printed as the control. (c) The
            path of ``examples/torch_gnn_graph_build.py`` (4,000 atoms: a
            HNSW-Flash build and search, exact kNN, EGNN on the kNN graph):
            ``flash_round`` and ``l2_batch`` must launch, the edge agreement
            reach half a scan of the same codes, and the energy equal the
            CPU path's. One line per cell (``gnn_training_cell``), then the
            phase's.
16. flash_ann  the paper's own workload, the registry's ``flash-ann``
            cells (D 768; coder d_f 256, M 16, 4-bit, H 8; 2 segments of
            20,000 rows, the registry's 100,000 cut; 1,024 queries, k 10) on
            ``vector_dataset(seed=0, n=41,024, d=768)``, ``BuildParams(r_upper=16, r_base=32, ef=128,
            batch=64, max_layers=3)``. (a) ``flash_ann_reference``: the
            reference's single-device programs (``fit_shared_coder``,
            ``build_segments_vmapped`` over the unblocked Flash backend,
            ``search_segments_local`` with the segments' vectors at ef ∈ {96,
            256}) over the first ``--ann-inc`` rows of each segment, and the
            card against the CPU on a ``ANN_CHECK_ROWS``-row ``build_segment``. (b)
            ``SegmentedAnnIndex.build`` over both 20,000-row segments (bulk
            ``flash_blocked``), the fan-out search at ef ∈ {96, 256}, W ∈ {1,
            4}, exact rerank, against ``exact_knn`` over the 40,000 rows
            (cross-checked against a plain loop); recall at ef 256 at least
            ½ a scan of every segment's codes keeping 256; ``flash_round``,
            ``flash_beam`` and ``l2_batch`` must launch.
16b. mesh   the segment layer across two ranks (``launch.mesh.run_ranks``:
            both on the one card over ``gloo``, or one a card over
            ``nccl`` where there are two or more). (a) phase 16 (a)'s
            inputs through ``make_segmented_build_fn`` (equal to its
            ``build_segments_vmapped`` tensor for tensor on every rank) and
            ``make_segmented_search_fn`` at ef ∈ {96, 256} (ids and dists
            equal to ``search_segments_local``'s): each rank's start-up,
            rendezvous, build and gather s and bytes (and the bytes staged
            through the host), QPS beside phase 16's one-card QPS. (b)
            ``ShardedBuilder(mesh=make_segment_mesh(2))`` over the main
            path's first 2 x 1,024 rows: mode "mesh", each rank's segment
            equal to ``build_segments_vmapped`` on the same plan and coder,
            recall@10 at ef 96 against ``exact_knn``, assignment and build
            s; ``l2_batch`` must launch (the ranks' counts summed).
17. recsys_cells  BERT4Rec's serving cells through
            ``launch/steps.build_bundle`` at the full config with seeded
            weights: ``serve_p99`` (B 512), ``serve_bulk`` (all 262,144
            sessions in blocks of 8,192, the first 256 held against the CPU's
            ``score_all`` top-100 except at near ties) and ``retrieval_cand``
            (B 1 over 1,000,000 Flash-coded candidates, one ``flash_scan`` a
            call): ms or s, model FLOPs/s over the float32 peak.
17b. mesh_steps  the recsys and GNN step bundles across two ranks sharing
            the card over ``gloo``, on a (data 1, model 2) mesh
            (``build_bundle(..., mesh=...)``: BERT4Rec tensor-parallel, the
            GNN step edge-sharded): BERT4Rec at its full config trained 3
            steps of 64 sessions (8 microbatches), ``serve_p99`` at B 512,
            ``serve_bulk`` over 8,192 sessions (cut from 262,144),
            ``retrieval_cand`` at B 1 over 1,000,000 rows (one
            ``flash_scan`` a rank over its 500,000 code rows); GatedGCN at
            full width and depth on ``full_graph_sm``, Equiformer-v2 at full
            width and depth 4 (of 12) on ``molecule``, 3 steps each. Each
            cell is held against the same cell in one process on the card
            (the first rank runs it): ids equal but at near ties, scores
            within 2e-5, BERT4Rec's state as the training phase's check, the
            GNNs' as phase 15's; one-process and per-rank seconds, the
            ranks' start-up, the bytes ``COMM`` counted, ``flash_scan``'s
            launches and ms a rank, beside the card's name and power limit.
17c. mesh_lm  LM serving across two ranks sharing the card over ``gloo``
            on a (data 1, model 2) mesh (``build_bundle``'s prefill and
            decode bundles under a mesh: heads, hidden columns, experts and
            the vocabulary over ``"model"``, the MoE expert-parallel with an
            ``all_to_all`` pair a layer, the caches' sequence over
            ``"model"``): moonshot-v1-16b-a3b at full width, depth 4 (the
            dense first layer and 3 MoE layers), seeded random weights,
            bf16: a prefill of B 2 × S 2,048 (4,096 tokens, 2,048 a rank
            through the ep branch), a prefill of B 8 × S 512 whose caches a
            batched decode continues for 4 greedy steps (4 tokens a rank
            through the ep branch), and a long-context decode of 4 steps at
            B 1 from its first row (the scatter branch over each rank's 32
            experts, the cache's sequence over both ranks). Each cell is
            held against the same cell in one process (the first rank runs
            it, its MoE as two ranks compute it): a float32 copy at depth 2
            within 1e-4 of the largest |logit|, then every bf16 argmax
            equal except at near ties, each printed with its margin. Per
            cell: seconds in one process and on each rank, ``COMM`` by kind
            (the ``all_to_all`` bytes apart, above 0 on every rank in the
            prefill and the batched decode), staged bytes, each rank's
            start-up and peak memory, beside the card's name and power
            limit. Then LM training across the same ranks
            (``build_bundle``'s train cell under the mesh: parameters and
            both Adam moments by ``lm_param_specs``, gradients through every
            collective, the vocabulary-parallel loss, the MoE aux losses over
            every token): a float32 copy at depth 2, B 2 × S 512, 2 steps
            (loss and grad_norm within 1e-5 relative of one process's, every
            parameter and moment within 1e-4 of its tensor's largest
            magnitude, parameters 2·steps·lr more), then moonshot at full
            width, depth 3 (the dense layer and 2 MoE layers), float32
            masters, bf16 compute, remat, ``train_4k``'s sequence at B 1
            (4,096 tokens, 2,048 a rank through the ep branch), 3 steps,
            every loss within 1% of one process's. Per step: seconds in one
            process and on each rank, ``COMM`` by kind with the forward's
            and the backward's ``all_to_all`` bytes apart (each equal to
            ``mesh_lm_train_exchange_bytes``, the backward's above 0),
            staged bytes, peak memory. No kernel of the repo runs here.
18. examples  ``examples/torch_quickstart.py``,
            ``torch_distributed_build.py`` (1,000 rows in 2 segments on 2
            ranks, ``--seg-size 250 --ranks 2``) and ``torch_retrieval_serving.py``, each
            ``main()`` on the card.

Launch counts are zeroed just before each path (the main path: phases 3–4;
the incremental path and the bulk build beside it: phase 6, each counted
apart, the profiler window in neither; the snapshot path: phase 7; the
serving path: phases 7d and 10b, each counted, then summed; the
baselines and generality paths: phases 7b and 7c; the scale-out path:
phases 8–10; the retrieval path: phase 11; the training path: phase 12
(b)–(d); the GNN example's path: phase 15 (c); the flash-ann paths:
phase 16 (a) and (b), each; the mesh path: phase 16b, in each rank,
then summed; the recsys cells: phase 17; the step bundles across ranks:
phase 17b, in each rank over its cells across the ranks, then summed; the
examples: phase 18, the
distributed example's ranks' counts added) and read just after it;
the script fails if a kernel of a path never launched there. The LM
serving and training paths (phases 13 and 14) and the GNN models (phase
15 (a), (b)) have no kernel of the repo to count. The main
path's M = 16 coder must read its mirror as 8-byte words on every launch
(``launches["mirror_*"]``). ``sq_l2`` and ``flash_expand`` are on no path:
phase 2 alone runs them (and ``flash_expand`` the loop that ``flash_beam``
is held against). Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

QUERIES = 1000  # held-out search queries, the search batch
SEGMENTS = 64  # the scale-out path's segments (benchmarks/bench_scalability.py:60-61)
N_SCALE = 34_000  # rows of the scale-out path (PERF.md §4 gives the cut)
ADD_ROWS = 1000  # rows the scale-out path adds through routed growth (2,000 cut, PERF.md §4)
REQUESTS = 64  # the retrieval path's request batch (examples/retrieval_serving.py:49)
GRAPH_EF = (96, 512)  # the example's ef_search (examples/retrieval_serving.py:72), and a wider beam
DELETE_ROWS = 10000  # ids the scale-out path deletes
N_INC = 1000  # rows of the incremental build (phase 6; PERF.md §4 gives the cut)
INC_CHECK_ROWS = 500  # rows of phase 6's M = 8 build, card against CPU (PERF.md §4 gives the cut)
N_BASE = 25_000  # rows of the baselines and generality phases (7b, 7c; PERF.md §4 gives the cut)
POOL_ROWS = 4096  # rows of the snapshot phase's pool and inline builds (PERF.md §4 gives the cut)
PROFILED_BATCHES = 5  # insert batches of the incremental path's profiler window (PERF.md §4)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CUDA_CORE_OPS_PER_S = 67e12  # float32 outside the tensor cores; int32 adds counted at it
TF32_TENSOR_OPS_PER_S = 495e12  # dense TF32 on the tensor cores, NVIDIA data sheet
L2_COLD_BYTES = 64 << 20  # operands rotated per l2_batch timing: above the 50 MB L2

REPLACES = {
    "flash_round": "src/repro/kernels/flash_round.py:49",
    "flash_expand": "src/repro/kernels/flash_expand.py:81",
    "flash_beam": "src/repro/kernels/flash_expand.py:81",
    "flash_scan_blocked": "src/repro/kernels/flash_scan.py:94",
    "l2_batch": "src/repro/kernels/l2_batch.py:43",
    "flash_scan": "src/repro/kernels/flash_scan.py:50",
    "sq_l2": "src/repro/kernels/sq_l2.py:34",
}
SOURCES = {
    "flash_round": "src/repro_torch/kernels/csrc/flash_round.cu",
    "flash_expand": "src/repro_torch/kernels/csrc/flash_expand.cu",
    "flash_beam": "src/repro_torch/kernels/csrc/flash_beam.cu",
    "flash_scan_blocked": "src/repro_torch/kernels/csrc/flash_scan_blocked.cu",
    "l2_batch": "src/repro_torch/kernels/csrc/l2_batch.cu",
    "flash_scan": "src/repro_torch/kernels/csrc/flash_scan.cu",
    "sq_l2": "src/repro_torch/kernels/csrc/sq_l2.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, *, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events (one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def device_events(prof) -> list:
    """The kernel events (device time) of a ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]


def profiled(fn, reps: int = 1, cpu: bool = True, warm: bool = True):
    """Run ``fn`` ``reps`` times under ``torch.profiler`` (CUDA activity, and
    CPU activity unless ``cpu`` is False) between two synchronizations,
    after one call outside the window unless ``warm`` is False: (profile,
    host ms of the window), or (None, the error) where the profiler
    cannot start here. An error raised by ``fn`` itself propagates."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with contextlib.ExitStack() as stack:
        try:  # the profiler is an observation, not the path
            prof = stack.enter_context(profile(activities=activities))
        except Exception as exc:
            return None, repr(exc)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return prof, wall


def profiler_kernel_ms(fn, kernel: str, reps: int = 5):
    """Device ms per call of ``fn`` spent in kernels whose name holds
    ``kernel``, from ``torch.profiler``; a string where it records none."""
    prof, wall = profiled(fn, reps)
    if prof is None:
        return f"profiler failed: {wall}"
    us = sum(e.time_range.elapsed_us() for e in device_events(prof) if kernel in e.name)
    return us / reps / 1e3 if us > 0 else "no device time recorded"


#: words in the names of cuBLAS's and CUTLASS's matrix-product kernels
PRODUCT_KERNEL_WORDS = ("gemm", "nvjet", "xmma", "cutlass")


def device_window(fn, cpu: bool = True, reps: int = 1, warm: bool = True) -> dict:
    """``reps`` calls of ``fn`` under the profiler (after one outside it
    unless ``warm`` is False): the window's host ms, the device busy share
    (kernel time over the window), the device ms in matrix-product kernels
    and the top five kernels by device time. ``cpu=False`` records the CUDA
    activity alone (a window of ~10⁵ launches takes minutes to parse with
    the CPU ops)."""
    prof, wall = profiled(fn, reps=reps, cpu=cpu, warm=warm)
    if prof is None:
        return {"error": wall}
    by_name: dict = {}
    for e in device_events(prof):
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    products = sum(ms for k, (ms, _) in by_name.items() if any(w in k for w in PRODUCT_KERNEL_WORDS))
    return {"window_ms": wall, "device_ms": busy, "busy_share": busy / wall if wall else None,
            "device_ops": sum(c for _, c in by_name.values()), "products_ms": products,
            "top5": [{"name": k[:120], "ms": ms, "count": c} for k, (ms, c) in top]}


def bound_ms(nbytes: float, ops: float, ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def embedding_bag_ms(idx, table, want) -> dict:
    """The one PyTorch call that computes a table kernel's function:
    ``F.embedding_bag(idx, table.view(-1, 1), mode="sum")`` over a float32
    copy of the tables, with ``idx`` the codes offset by m·K (and by the
    row's table). Exact while every sum stays below 2²⁴ (M·255 here): held
    equal to the kernel's int32 result ``want``, then timed alone (the
    offset indices and the float32 copy are made outside the timed call)."""
    import torch
    import torch.nn.functional as F

    t32 = table.reshape(-1, 1).to(torch.float32)
    got = F.embedding_bag(idx, t32, mode="sum")[:, 0]
    if not torch.equal(got, want.reshape(-1).to(torch.float32)):
        raise AssertionError("embedding_bag disagrees with the kernel it stands beside")
    return {"library_ms": time_ms(lambda: F.embedding_bag(idx, t32, mode="sum")),
            "library_call": "F.embedding_bag(codes + m*K, table.view(-1, 1), mode='sum')"}


def check_kernels(dev, n: int) -> dict:
    """Phase 2: every kernel vs its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import flash as fl
    from repro_torch.graph import engine
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    m, k, r = 16, 16, 32
    out = {}
    layouts0 = {key: ops.launches[f"mirror_{key}"] for key in ops.MIRROR_LAYOUTS}

    def ints(shape, hi, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device=dev, dtype=dtype)

    def compare(name, got, want, table):
        err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
        if table.dtype == torch.int32:
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: int32 table result differs from the plain version")
        else:
            atol = 1e-5 * m * float(table.abs().max())
            if not torch.allclose(got, want, rtol=1e-5, atol=atol):
                raise AssertionError(f"{name}: float32 result off by {err} (atol {atol})")
        return err

    # flash_round: one round_dists launch of the bulk build
    b, c = min(engine._BULK_CHUNK, n), 64 + 8 * 8
    codes = ints((b, c, m), k)
    errs = {}
    for dt in (torch.int32, torch.float32):
        adts = ints((b, m, k), 256) if dt == torch.int32 else torch.randn((b, m, k), generator=g, device=dev) * 50
        errs[dt] = compare("flash_round", ops.flash_round(codes, adts), ref.flash_round(codes, adts), adts)
    adts = ints((b, m, k), 256)
    nbytes = codes.numel() * 4 + adts.numel() * 4 + b * c * 4
    bnd, by = bound_ms(nbytes, b * c * m)
    mk = torch.arange(m, device=dev) * k
    idx = (codes.long() + mk + (torch.arange(b, device=dev) * m * k)[:, None, None]).reshape(b * c, m)
    out["flash_round"] = dict(
        shape=[b, c, m], max_abs_err=errs[torch.int32], max_abs_err_f32=errs[torch.float32],
        ms=time_ms(lambda: ops.flash_round(codes, adts)),
        device_ms=profiler_kernel_ms(lambda: ops.flash_round(codes, adts), "flash_round_kernel"),
        plain_ms=time_ms(lambda: ref.flash_round(codes, adts), reps=3, inner=2),
        bound_ms=bnd, bound_by=by, **embedding_bag_ms(idx, adts, ops.flash_round(codes, adts)),
    )
    del idx

    # flash_expand / flash_scan_blocked: one base-layer beam step of a
    # 1000-query search on an n-vertex graph
    q = QUERIES
    adjacency = ints((n, r), n)
    mirror = ints((n, r, m // 2), 256, torch.uint8)
    mirror_i32 = fl.unpack_codes(mirror, m).contiguous()
    for w in (1, 4):
        nodes = ints((q, w), n)
        if w > 1:
            nodes[:, 0] = -1  # an inactive slot, as a beam step has
        errs = {}
        for dt in (torch.int32, torch.float32):
            adt = ints((q, m, k), 256) if dt == torch.int32 else torch.randn((q, m, k), generator=g, device=dev) * 50
            for mir in (mirror, mirror_i32):
                rows, sums = ops.flash_expand(nodes, adjacency, mir, adt)
                rows_p, sums_p = ref.flash_expand(nodes, adjacency, mir, adt)
                if not torch.equal(rows, rows_p):
                    raise AssertionError("flash_expand: gathered rows differ from the plain version")
                errs[dt] = max(errs.get(dt, 0.0), compare("flash_expand", sums, sums_p, adt))
            blocks = fl.unpack_codes(mirror[nodes.clamp_min(0).long()], m).transpose(-1, -2).contiguous()
            got = ops.flash_scan_blocked(blocks, adt)
            errs[("scan", dt)] = compare("flash_scan_blocked", got, ref.flash_scan_blocked(blocks, adt), adt)
            if dt == torch.int32 and not torch.equal(got, sums):
                raise AssertionError("flash_scan_blocked and flash_expand disagree on the same rows")
        adt = ints((q, m, k), 256)
        slots = q * w * r
        nbytes = q * w * 4 + slots * (4 + m // 2) + adt.numel() * 4 + slots * 8
        bnd, by = bound_ms(nbytes, slots * m)
        out[f"flash_expand_w{w}"] = dict(
            shape=[q, w, r, m], n=n, max_abs_err=errs[torch.int32], max_abs_err_f32=errs[torch.float32],
            ms=time_ms(lambda: ops.flash_expand(nodes, adjacency, mirror, adt)),
            device_ms=profiler_kernel_ms(lambda: ops.flash_expand(nodes, adjacency, mirror, adt),
                                         "flash_expand_kernel"),
            plain_ms=time_ms(lambda: ref.flash_expand(nodes, adjacency, mirror, adt), reps=3, inner=2),
            bound_ms=bnd, bound_by=by, library_ms=None,
        )
        blocks = fl.unpack_codes(mirror[nodes.clamp_min(0).long()], m).transpose(-1, -2).contiguous()
        nbytes = blocks.numel() * 4 + adt.numel() * 4 + slots * 4
        bnd, by = bound_ms(nbytes, slots * m)
        mk = (torch.arange(m, device=dev) * k)[None, None, :, None]
        idx = (blocks.long() + mk + (torch.arange(q, device=dev) * m * k)[:, None, None, None])
        idx = idx.transpose(-1, -2).reshape(-1, m).contiguous()
        out[f"flash_scan_blocked_w{w}"] = dict(
            shape=list(blocks.shape), max_abs_err=errs[("scan", torch.int32)],
            max_abs_err_f32=errs[("scan", torch.float32)],
            ms=time_ms(lambda: ops.flash_scan_blocked(blocks, adt)),
            device_ms=profiler_kernel_ms(lambda: ops.flash_scan_blocked(blocks, adt),
                                         "flash_scan_blocked_kernel"),
            plain_ms=time_ms(lambda: ref.flash_scan_blocked(blocks, adt), reps=3, inner=2),
            bound_ms=bnd, bound_by=by,
            **embedding_bag_ms(idx, adt, ops.flash_scan_blocked(blocks, adt)),
        )
        del idx
    del mirror_i32
    out.update(check_flash_beam(ints, adjacency, n, m, k, r))
    out.update(check_any_m(ints, adjacency, n, k, r))
    # the layout each flash_expand / flash_beam launch of this phase read
    out["mirror_layout_launches"] = {key: ops.launches[f"mirror_{key}"] - v for key, v in layouts0.items()}

    out["limits"] = check_repaired_limits(dev, g)
    out["flat_shapes"] = check_flat_shapes(dev, g)
    out.update(check_l2_batch(dev, g, q))
    out["l2_batch_d768"] = check_l2_batch_d768(dev, g)
    # nearest_centroid: routed growth's shape, with a banned mask
    x = torch.randn((2000, 128), generator=g, device=dev) * 10
    cents = torch.randn((64, 128), generator=g, device=dev) * 10
    banned = torch.zeros(64, dtype=torch.bool, device=dev)
    banned[[5, 17]] = True
    route, d2 = ops.nearest_centroid(x, cents, banned=banned)
    plain = ref.l2_batch(x, cents).masked_fill(banned[None], float("inf"))
    flips, near = route_flips(route, plain, l2_atol(x, cents))
    if flips > near or bool(banned[route.long()].any()):
        raise AssertionError(f"nearest_centroid: {flips} routes differ, {near} of them at near ties")
    out["nearest_centroid"] = dict(shape=[2000, 64, 128], route_flips=flips, near_tie_flips=near)

    # flash_scan: one query's scan of the BERT4Rec catalog's codes
    from repro_torch.configs.registry import get_arch

    nc = get_arch("bert4rec").make_full().n_items
    codes = ints((nc, m), k)
    errs = {}
    for dt in (torch.int32, torch.float32):
        adt = ints((m, k), 256) if dt == torch.int32 else torch.randn((m, k), generator=g, device=dev) * 50
        errs[dt] = compare("flash_scan", ops.flash_scan(codes, adt), ref.flash_scan(codes, adt), adt)
    adt = ints((m, k), 256)
    bnd, by = bound_ms(codes.numel() * 4 + adt.numel() * 4 + nc * 4, nc * m)
    idx = codes.long() + torch.arange(m, device=dev) * k
    out["flash_scan"] = dict(
        shape=[nc, m, k], max_abs_err=errs[torch.int32], max_abs_err_f32=errs[torch.float32],
        ms=time_ms(lambda: ops.flash_scan(codes, adt)),
        device_ms=profiler_kernel_ms(lambda: ops.flash_scan(codes, adt), "flash_scan_kernel"),
        plain_ms=time_ms(lambda: ref.flash_scan(codes, adt), reps=3, inner=2),
        bound_ms=bnd, bound_by=by, **embedding_bag_ms(idx, adt, ops.flash_scan(codes, adt)),
    )
    del codes, idx

    # sq_l2: a 1M-row scan of 8-bit SQ codes at D = 128, positive scales
    ns, ds = 1 << 20, 128
    qc, db = ints((ds,), 256), ints((ns, ds), 256)
    s2 = torch.rand((ds,), generator=g, device=dev) * 1e-2 + 1e-4
    got, want = ops.sq_l2(qc, db, s2), ref.sq_l2(qc, db, s2)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
        raise AssertionError(f"sq_l2: off by {err} (rtol 1e-5)")
    bnd, by = bound_ms(db.numel() * 4 + 2 * ds * 4 + ns * 4, 3 * ns * ds)
    out["sq_l2"] = dict(
        shape=[ns, ds], max_abs_err=err, rtol=1e-5,
        ms=time_ms(lambda: ops.sq_l2(qc, db, s2)),
        device_ms=profiler_kernel_ms(lambda: ops.sq_l2(qc, db, s2), "sq_l2_kernel"),
        plain_ms=time_ms(lambda: ref.sq_l2(qc, db, s2), reps=3, inner=2),
        bound_ms=bnd, bound_by=by, library_ms=None,
    )
    del db
    torch.cuda.synchronize()
    return out


def check_l2_batch(dev, g, q: int) -> dict:
    """Phase 2's l2_batch rows: a ground-truth tile (exact_knn: the 1,000
    queries x one 8,192-row chunk) and an assignment chunk (65,536 rows x 64
    centroids), each held to its plain version and timed two ways: ``ms``
    as the path sees it, with L2 cold (a rotation of distinct chunks, more
    than 50 MB in all: data chunks for the ground truth, row chunks for the
    assignment), and ``ms_warm`` on the same inputs again (the method of
    the kernel table's earlier rows); ``device_ms`` is the profiler's kernel
    time over the cold rotation. ``bound_ms`` is the 3xTF32 bound (3 ·
    2·N·C·D at TF32's rate), the float32-FMA bound beside it. Then the card
    tests' odd shapes, compared only."""
    import itertools

    import torch

    from repro_torch.kernels import ops, ref

    out = {}
    d = 128
    for key, (nn, cc) in (("l2_batch_gt", (q, 8192)), ("l2_batch_assign", (65536, 64))):
        rotate = "y" if key == "l2_batch_gt" else "x"
        per = 4 * d * (cc if rotate == "y" else nn)
        reps = max(2, -(-L2_COLD_BYTES // per))
        xs = [torch.randn((nn, d), generator=g, device=dev) * 10 for _ in range(1 if rotate == "y" else reps)]
        ys = [torch.randn((cc, d), generator=g, device=dev) * 10 for _ in range(reps if rotate == "y" else 1)]
        pairs = [(xs[i % len(xs)], ys[i % len(ys)]) for i in range(reps)]
        err, atol = 0.0, 0.0
        for x, y in pairs[:2]:
            got, want = ops.l2_batch(x, y), ref.l2_batch(x, y)
            a = l2_atol(x, y)
            e = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=1e-5, atol=a):
                raise AssertionError(f"l2_batch {nn}x{cc}: off by {e} (atol {a})")
            err, atol = max(err, e), max(atol, a)
        del got, want
        cycle = itertools.cycle(pairs)

        def cold(cycle=cycle):
            return ops.l2_batch(*next(cycle))

        x, y = pairs[0]
        nbytes = 4 * (nn * d + cc * d + nn * cc)
        bnd, by = bound_ms(nbytes, 3 * 2 * nn * cc * d, TF32_TENSOR_OPS_PER_S)
        bnd_fma, by_fma = bound_ms(nbytes, 2 * nn * cc * d)
        out[key] = dict(
            shape=[nn, cc, d], max_abs_err=err, atol=atol, cold_rotation=reps,
            ms=time_ms(cold, reps=5, inner=max(10, 2 * reps)),
            ms_warm=time_ms(lambda: ops.l2_batch(x, y)),
            device_ms=profiler_kernel_ms(cold, "l2_batch_kernel", reps=2 * reps),
            plain_ms=time_ms(lambda: ref.l2_batch(x, y)),
            bound_ms=bnd, bound_by=by, bound_fp32_fma_ms=bnd_fma, bound_fp32_fma_by=by_fma,
            library_ms=time_ms(lambda: torch.cdist(x, y, compute_mode="use_mm_for_euclid_dist")),
        )
        del xs, ys, pairs, cycle
    # the card tests' odd shapes (compare only): D % 4 ≠ 0 (a padded copy),
    # ragged C and N, a view off TMA's 16-byte alignment
    odd = []
    for nn, cc, dd, skew in ((1, 8191, 25, 0), (300, 288, 100, 0), (77, 1, 960, 0), (1, 64, 960, 0),
                             (129, 8191, 100, 0), (2000, 64, 25, 0), (5, 1, 3, 0), (300, 70, 3, 1),
                             (300, 70, 128, 1)):
        x = (torch.randn((nn * dd + skew,), generator=g, device=dev) * 3.0)[skew:].view(nn, dd)
        y = torch.randn((cc, dd), generator=g, device=dev) * 3.0
        before = ops.launches["l2_batch_pad"]
        got, want = ops.l2_batch(x, y), ref.l2_batch(x, y)
        a = l2_atol(x, y)
        e = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=a):
            raise AssertionError(f"l2_batch {nn}x{cc}x{dd} (skew {skew}): off by {e} (atol {a})")
        odd.append({"shape": [nn, cc, dd], "skew_floats": skew, "max_abs_err": e, "atol": a,
                    "pad_copies": ops.launches["l2_batch_pad"] - before})
    out["l2_batch_odd_shapes"] = odd
    return out


def check_flash_beam(ints, adjacency, n: int, m: int, k: int, r: int) -> dict:
    """Phase 2's flash_beam rows: the base-layer search of the 1,000-query
    batch over the phase's random n-vertex graph (a code per vertex, the
    mirror built from them, one random entry per query), at ef ∈ {64, 256}
    and W ∈ {1, 4}. Each launch must equal, bit for bit (ids, dists,
    n_dists, n_hops), both its plain version ``ref.flash_beam`` on the same
    inputs and the loop of ``flash_expand`` launches it replaces, and at
    (64, 4) also with the unpacked mirror; it is timed beside that loop
    (``step_loop_ms``), its plain version on the card and its bound. At
    (64, 1) the first 32 queries, one insert batch of the build
    (``BuildParams``: batch 32, ef 64, W 1), are checked and timed too, and
    so is the same search with the mirror read byte-wise (a copy 4 bytes
    off an 8-byte boundary) beside the word layout.

    The bound counts the bytes the search needs: the tables, n_hops · R
    adjacency entries and packed code rows, the beam in and out, the entries
    and the counts. The visited bitmap the kernel zeroes is its own
    workspace, reported apart as ``workspace_bytes``."""
    import torch

    from repro_torch.core import flash as fl
    from repro_torch.kernels import ops, ref

    q = QUERIES
    codes = ints((n, m), k)
    unpacked = codes[adjacency.long()]  # adjacency has no empty slot here
    packed = fl.pack_codes(unpacked)
    entries = ints((q, 1), n)
    words = -(-n // 32)
    out = {}
    for ef in (64, 256):
        for w in (1, 4):
            adt = ints((q, m, k), 256)
            d_e = fl.adc_lookup(adt, codes[entries.long()]).to(torch.float32)
            args = (adt, *ref.initial_beam(entries, d_e, ef), entries)  # adt, beam (3), entries
            max_iters = -(-(4 * ef + 8) // w)

            def kernel(args=args, mir=packed):
                return ops.flash_beam(args[0], adjacency, mir, *args[1:], width=w, max_iters=max_iters)

            def plain(args=args, mir=packed):
                return ref.flash_beam(args[0], adjacency, mir, *args[1:], width=w, max_iters=max_iters)

            def step_loop(args=args):
                a, bd, bi, be, en = args

                def step(nodes):
                    rows, sums = ops.flash_expand(nodes, adjacency, packed, a)
                    return rows, sums.to(torch.float32)
                return ref.beam_loop(step, bd, bi, be, en, n, width=w, max_iters=max_iters)

            def check(got, args=args, mirrors=(packed,), what=""):
                """Hold ``got`` equal to the step loop and, per mirror, to the
                plain version: the largest |kernel − plain| over finite dists."""
                err = 0.0
                wants = [("the flash_expand step loop", step_loop(args))]
                wants += [(f"its plain version ({mir.dtype} mirror)", plain(args, mir)) for mir in mirrors]
                for against, want in wants:
                    for name, x, y in zip(("dists", "ids", "n_dists", "n_hops"), got, want):
                        if not torch.equal(x, y):
                            raise AssertionError(f"flash_beam ({what}) differs from {against} in {name}")
                    fin = torch.isfinite(got[0]) & torch.isfinite(want[0])
                    if bool(fin.any()):
                        err = max(err, float((got[0][fin] - want[0][fin]).abs().max()))
                return err

            mirrors = (unpacked, packed) if (ef, w) == (64, 4) else (packed,)
            err = 0.0
            for mir in mirrors:
                got = kernel(mir=mir)
                err = max(err, check(got, mirrors=mirrors, what=f"ef={ef}, W={w}, {mir.dtype} mirror"))
            hops = int(got[3].sum())
            nbytes = (adt.numel() * 4 + hops * r * (4 + m // 2)
                      + q * ef * 9 + q * ef * 8 + q * 16 + entries.numel() * 4)
            bnd, by = bound_ms(nbytes, hops * r * m)
            row = out[f"flash_beam_ef{ef}_w{w}"] = dict(
                shape=[q, ef, w, r, m], n=n, layout=ops.mirror_layout(packed), max_abs_err=err, n_hops=hops, n_dists=int(got[2].sum()),
                n_hops_max=int(got[3].max()), workspace_bytes=q * words * 4,
                ms=time_ms(kernel, reps=5, inner=3),
                device_ms=profiler_kernel_ms(kernel, "flash_beam_kernel", reps=3),
                step_loop_ms=path_ms(step_loop, reps=3),
                plain_ms=path_ms(plain, reps=3),
                bound_ms=bnd, bound_by=by, library_ms=None,
            )
            if (ef, w) == (64, 1):
                # the same search with the M = 16 mirror read byte-wise: a copy
                # 4 bytes into its storage (off 8-byte words, on 4-byte ones)
                flat = torch.empty(packed.numel() + 4, dtype=torch.uint8, device=packed.device)
                flat[4:] = packed.reshape(-1)
                skewed = flat[4:].view(packed.shape)
                before = ops.launches["mirror_bytes"]
                got = kernel(mir=skewed)
                if ops.launches["mirror_bytes"] != before + 1:
                    raise AssertionError("flash_beam on a skewed M = 16 mirror did not take the byte-wise layout")
                row["bytes_layout_same_inputs"] = dict(
                    layout=ops.mirror_layout(skewed), max_abs_err=check(got, what="M=16, byte-wise"),
                    ms=time_ms(lambda: kernel(mir=skewed), reps=5, inner=3),
                    device_ms=profiler_kernel_ms(lambda: kernel(mir=skewed), "flash_beam_kernel", reps=3),
                )
                del flat, skewed
                batch = tuple(t[:32].contiguous() for t in args)
                got = kernel(batch)
                row["insert_batch_q32"] = dict(
                    max_abs_err=check(got, batch, what="an insert batch of 32 queries"),
                    n_hops_max=int(got[3].max()), ms=time_ms(lambda: kernel(batch), reps=5, inner=3),
                    device_ms=profiler_kernel_ms(lambda: kernel(batch), "flash_beam_kernel", reps=3),
                    step_loop_ms=path_ms(lambda: step_loop(batch), reps=3),
                )
    return out


def check_any_m(ints, adjacency, n: int, k: int, r: int) -> dict:
    """Phase 2's packed mirrors whose rows are not whole 8-byte words: M ∈
    {5, 6, 7, 8, 12, 24} (⌈M/2⌉ = 3, 3, 4, 4, 6, 12 bytes) over the phase's
    random n-vertex graph, 1,000 queries, ef = 64, W ∈ {1, 4}; an odd M's
    padding nibble is set to 15, which a kernel must never add (M = 5 reads
    bytes, M = 7 4-byte words). Every ``flash_beam``
    launch must take the byte-wise layout and equal its plain version
    ``ref.flash_beam`` bit for bit (ids, dists, n_dists, n_hops), and
    ``flash_expand`` on the first W beam entries ``ref.flash_expand``. The
    M = 8 launch at W = 1 is timed beside phase 2's M = 16 word-layout row
    (``flash_beam_ef64_w1``), with its bound counted the same way."""
    import torch

    from repro_torch.core import flash as fl
    from repro_torch.kernels import ops, ref

    q, ef = QUERIES, 64
    out = {}
    for m in (5, 6, 7, 8, 12, 24):
        codes = ints((n, m), k)
        packed = fl.pack_codes(codes[adjacency.long()])
        if m % 2:
            packed[..., -1] |= 0xF0
        entries = ints((q, 1), n)
        adt = ints((q, m, k), 256)
        d_e = fl.adc_lookup(adt, codes[entries.long()]).to(torch.float32)
        args = (adt, adjacency, packed, *ref.initial_beam(entries, d_e, ef), entries)
        del codes
        rows = {}
        for w in (1, 4):
            max_iters = -(-(4 * ef + 8) // w)
            before = ops.launches["mirror_bytes"]
            got = ops.flash_beam(*args, width=w, max_iters=max_iters)
            if ops.launches["mirror_bytes"] != before + 1:
                raise AssertionError(f"flash_beam at M={m} did not take the byte-wise layout")
            want = ref.flash_beam(*args, width=w, max_iters=max_iters)
            for name, x, y in zip(("dists", "ids", "n_dists", "n_hops"), got, want):
                if not torch.equal(x, y):
                    raise AssertionError(f"flash_beam (M={m}, W={w}, bytes) differs from its plain version in {name}")
            nodes = args[4][:, :w].contiguous()
            e_rows, e_sums = ops.flash_expand(nodes, adjacency, packed, adt)
            p_rows, p_sums = ref.flash_expand(nodes, adjacency, packed, adt)
            if not (torch.equal(e_rows, p_rows) and torch.equal(e_sums, p_sums)):
                raise AssertionError(f"flash_expand (M={m}, W={w}, bytes) differs from its plain version")
            rows[f"w{w}"] = {"n_hops": int(got[3].sum()), "n_dists": int(got[2].sum())}
            if (m, w) == (8, 1):
                hops = int(got[3].sum())
                mp = packed.shape[-1]
                nbytes = (adt.numel() * 4 + hops * r * (4 + mp)
                          + q * ef * 9 + q * ef * 8 + q * 16 + entries.numel() * 4)
                bnd, by = bound_ms(nbytes, hops * r * m)

                def kernel(args=args, max_iters=max_iters):
                    return ops.flash_beam(*args, width=1, max_iters=max_iters)
                out["flash_beam_m8_bytes"] = dict(
                    shape=[q, ef, 1, r, m], n=n, layout=ops.mirror_layout(packed), n_hops=hops,
                    ms=time_ms(kernel, reps=5, inner=3),
                    device_ms=profiler_kernel_ms(kernel, "flash_beam_kernel", reps=3),
                    bound_ms=bnd, bound_by=by,
                )
        out[f"packed_m{m}"] = dict(bytes_per_row=int(packed.shape[-1]), layout=ops.mirror_layout(packed),
                                   bit_equal=True, **rows)
        del packed, args, adt
    return out


def l2_atol(x, y) -> float:
    """The stated l2_batch tolerance: 1e-5 · max(‖x‖² + ‖y‖²)."""
    return 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())


def route_flips(route, plain_d2, atol: float) -> tuple[int, int]:
    """(routes that differ from the plain argmin, how many of those are near
    ties: the route's plain distance within 2·atol of the plain minimum)."""
    from repro_torch.utils import first_argmin

    want = first_argmin(plain_d2, 1)
    diff = route.long() != want
    gap = plain_d2.gather(1, route[:, None].long())[:, 0] - plain_d2.gather(1, want[:, None])[:, 0]
    return int(diff.sum()), int((diff & (gap <= 2 * atol)).sum())


def assignment_cross_check(rows_np, plan, dev) -> dict:
    """The streaming assignment's segments (the kernel's distances, then the
    capacity-capped greedy routing ``graph/sharded._route_balanced``)
    against the same routing, chunk by chunk with the same capacity, on the
    plain version's distances on the card and on the CPU (no kernel runs).
    A full segment keeps the rows closest to it, so a difference in the
    last bits of two rows' distances to it moves a row, and each move
    shifts the capacity left for later rows and chunks: the counts measure
    that sensitivity of the routing. ``near`` counts the moved rows whose
    two segments lie within 2·atol by the plain distances."""
    import torch

    from repro_torch.graph.sharded import _route_balanced
    from repro_torch.kernels import ref

    got = plan.locate()[:, 0]
    cents = torch.from_numpy(plan.centroids)
    cap = -(-plan.n // plan.n_segments)
    routes = {}
    d2_card = []
    for where, c in (("card", cents.to(dev)), ("cpu", cents)):
        remaining = np.full(plan.n_segments, cap, np.int64)
        out = np.empty(plan.n, np.int64)
        for s in range(0, plan.n, plan.chunk_size):
            x = torch.from_numpy(np.ascontiguousarray(rows_np[s:s + plan.chunk_size])).to(c.device)
            d2 = ref.l2_batch(x, c).cpu().numpy()
            out[s:s + x.shape[0]] = _route_balanced(d2, remaining)
            if where == "card":
                d2_card.append((d2, l2_atol(x, c)))
        routes[where] = out
    moved = np.nonzero(got != routes["card"])[0]
    near = 0
    for s, (d2, atol) in zip(range(0, plan.n, plan.chunk_size), d2_card):
        rows = moved[(moved >= s) & (moved < s + d2.shape[0])]
        gap = np.abs(d2[rows - s, got[rows]] - d2[rows - s, routes["card"][rows]])
        near += int((gap <= 2 * atol).sum())
    first = int(moved[0] // plan.chunk_size) if moved.size else None
    return {"rows": plan.n, "kernel_vs_plain_card": int(moved.size), "near": near,
            "first_chunk_that_differs": first,
            "plain_card_vs_plain_cpu": int((routes["card"] != routes["cpu"]).sum())}


def plain_knn(data, queries, k: int, chunk: int = 1 << 17):
    """Chunked exact k-NN in plain torch (a cross-check, not the path):
    (ids (Q, k) int64, squared dists (Q, k))."""
    import torch

    q2 = (queries * queries).sum(1, keepdim=True)
    best_d = torch.full((queries.shape[0], k), float("inf"), device=data.device)
    best_i = torch.zeros((queries.shape[0], k), dtype=torch.int64, device=data.device)
    for s in range(0, data.shape[0], chunk):
        x = data[s:s + chunk]
        d = q2 + (x * x).sum(1)[None] - 2.0 * queries @ x.T
        dd = torch.cat([best_d, d], 1)
        ii = torch.cat([best_i, torch.arange(s, s + x.shape[0], device=data.device).expand(queries.shape[0], -1)], 1)
        best_d, pos = torch.topk(dd, k, dim=1, largest=False)
        best_i = ii.gather(1, pos)
    return best_i, best_d


def knn_cross_check(gt_ids, gt_d, data, queries, k: int = 10) -> dict:
    """The port's exact_knn against the plain loop on ``queries``: id sets
    equal except where the plain k-th and (k+1)-th distances are within the
    l2 tolerance (a near tie), sorted distances allclose. Counts the queries
    whose sets differ and the ground-truth ids outside the plain set."""
    import torch

    ids_p, d_p = plain_knn(data, queries, k + 1)
    atol = l2_atol(queries, data)
    got, want = gt_ids.long().cpu(), ids_p[:, :k].cpu()
    gap = (d_p[:, k] - d_p[:, k - 1]).cpu()
    differ = near = flipped = 0
    for i in range(queries.shape[0]):
        extra = len(set(got[i].tolist()) - set(want[i].tolist()))
        if extra:
            differ += 1
            flipped += extra
            near += int(float(gap[i]) <= 2 * atol)
    if differ > near or not torch.allclose(gt_d, d_p[:, :k], rtol=1e-5, atol=atol):
        raise AssertionError(f"exact_knn vs the plain loop: {differ} id sets differ, {near} at near ties")
    return {"queries": int(queries.shape[0]), "id_sets_differ": differ, "near_ties": near,
            "ids_differ": flipped, "max_abs_dist_err": float((gt_d - d_p[:, :k]).abs().max())}


def time_split(fn, kernel: str) -> dict:
    """One call of ``fn`` under the profiler: its host ms to a synchronized
    end, and its device ms in kernels whose name holds ``kernel`` and in the
    others (with their counts)."""
    prof, wall = profiled(fn)
    if prof is None:
        return {"error": wall}
    ev = device_events(prof)
    mine = [e.time_range.elapsed_us() / 1e3 for e in ev if kernel in e.name]
    rest = [e.time_range.elapsed_us() / 1e3 for e in ev if kernel not in e.name]
    return {"window_ms": wall, f"{kernel}_ms": sum(mine), f"{kernel}_count": len(mine),
            "other_device_ms": sum(rest), "other_device_count": len(rest)}


def scan_gate(what: str, recall: float, scan: float) -> None:
    """The sanity floor every graph search here is held to: at least half
    the recall of a scan of all the codes keeping the same ``c``
    (``repro_torch.testing.scan.code_scan_recall``). (The
    codes, not the graph, bound recall at these sizes: an absolute floor
    would test the coder configuration.)"""
    if recall < 0.5 * scan:
        raise AssertionError(f"{what}: recall@10 {recall} is below half the code scan's {scan}")


def recall_at(ids, gt) -> float:
    import torch

    hit = (ids[:, :, None].long() == gt[:, None, :]).any(2).sum(1)
    return float(hit.to(torch.float64).mean() / gt.shape[1])


def small_input_checks(dev, index, queries, knn) -> dict:
    """Phase 5: the card's path against the plain CPU path on small inputs,
    and the 0.5 recall@10 floor (ef=256) on the small build."""
    import torch

    from repro_torch.graph import backends as bk
    from repro_torch.graph.beam import beam_search
    from repro_torch.graph.engine import BuildParams
    from repro_torch.graph.hnsw import build_hnsw

    out = {}
    # (a) beam search on the built index, same query tables on both devices
    be_gpu = index.backend
    be_cpu = bk.FlashBlockedBackend(
        be_gpu.coder._replace(**{f: getattr(be_gpu.coder, f).cpu() for f in be_gpu.coder._fields}),
        be_gpu.codes.cpu(), be_gpu.nbr_codes.cpu(),
    )
    qs = queries[:64]
    ctx = be_gpu.prepare_query(qs)
    ctx_cpu = type(ctx)(*(t.cpu() for t in ctx))
    entries = torch.full((64, 1), index.graph.entry, dtype=torch.int32, device=dev)
    adj_cpu = index.graph.adj0.cpu()
    want = beam_search(be_cpu, ctx_cpu, adj_cpu, entries.cpu(), ef=64, width=4)
    for fused in (True, False):
        got = beam_search(be_gpu, ctx, index.graph.adj0, entries, ef=64, width=4, fused=fused)
        for f in ("ids", "dists", "n_dists", "n_hops"):
            if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
                raise AssertionError(f"beam search on the card (fused={fused}) differs from the CPU path in {f}")
    out["beam_card_equals_cpu"] = True

    # (b) a whole small build from one coder: card kernels vs CPU plain path
    data = index.data[:5000]  # 20,000, then 10,000, then 5,000 rows (PERF.md §4)
    be = bk.make_backend("flash_blocked", data, seed=0, r_for_blocked=16, device=dev,
                         d_f=64, m_f=16, l_f=4, h=8, kmeans_iters=8)
    state = be.state_dict()
    params = BuildParams(r_upper=8, r_base=16, ef=32, batch=16, max_layers=2)
    g_gpu, s_gpu = build_hnsw(data, be, params=params, seed=0)
    be_c = bk.FlashBlockedBackend.from_state(state, device="cpu")
    g_cpu, s_cpu = build_hnsw(data.cpu(), be_c, params=params, seed=0)
    lv_gpu = be.prepare_query(data).adt_q.cpu()
    lv_cpu = be_c.prepare_query(data.cpu()).adt_q
    mismatch = int((lv_gpu != lv_cpu).sum())
    same = float((g_gpu.adj0.cpu() == g_cpu.adj0).all(1).double().mean())
    out.update(small_build_n=int(data.shape[0]), adt_level_mismatch=mismatch,
               adj0_rows_equal=same, phases_gpu=s_gpu.phases, phases_cpu=s_cpu.phases)
    if mismatch == 0 and same != 1.0:
        raise AssertionError(f"equal query tables, yet only {same} of adjacency rows equal the CPU build")
    if same < 0.99:
        raise AssertionError(f"only {same} of adjacency rows equal the CPU build ({mismatch} level mismatches)")
    from repro_torch.graph.hnsw import search_hnsw
    from repro_torch.graph.rerank import SearchSpec, make_reranker

    res = search_hnsw(g_gpu, queries, spec=SearchSpec(k=10, ef=256, width=4),
                      reranker=make_reranker("exact", raw_vectors=data))
    out["small_build_recall@10_ef256"] = rec = recall_at(res.ids, knn(data, queries, 10)[0])
    if rec < 0.5:
        raise AssertionError(f"small build: recall@10 at ef=256 is {rec}, below 0.5")
    return out


def segmented_check(data_np, q_np, workdir: str, device: str = "cuda") -> dict:
    """Phase 5's scale-out check: an 8k-row collection in 4 segments built on
    the card and restored on the CPU; both sides add 500 rows, delete 100
    ids, compact and search, and must return equal ids."""
    import torch

    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import SegmentedAnnIndex

    params = BuildParams(r_upper=8, r_base=16, ef=32, batch=16, max_layers=2)
    card = SegmentedAnnIndex.build_streaming(
        data_np[:8000], n_segments=4, params=params, workdir=workdir, device=device,
        backend_kwargs=dict(d_f=64, m_f=16, l_f=4, h=8, kmeans_iters=8),
    )
    cpu = SegmentedAnnIndex.restore(*card.export_state(), device="cpu")
    dead = np.random.default_rng(1).choice(8500, 100, replace=False)
    ids = {}
    for name, coll in (("card", card), ("cpu", cpu)):
        coll.add(data_np[8000:8500])
        coll.delete(dead)
        coll.compact()
        ids[name] = coll.search(q_np[:200], k=10, ef=64, width=4).ids.cpu()
        if np.isin(ids[name].numpy(), dead).any():
            raise AssertionError(f"segmented check ({name}): a deleted id came back")
    same_route = bool((card._locate == cpu._locate).all())
    adj_rows = [float((a.graph.adj0.cpu() == b.graph.adj0).all(1).double().mean())
                for a, b in zip(card.segments, cpu.segments)]
    if not torch.equal(ids["card"], ids["cpu"]):
        raise AssertionError(
            f"segmented check: card and CPU ids differ (routes equal: {same_route}, "
            f"adj0 rows equal per segment: {adj_rows})"
        )
    return {"segmented_check_n": card.n, "segmented_card_equals_cpu": True,
            "segmented_routes_equal": same_route, "segmented_adj0_rows_equal": adj_rows}


def incremental_path(dev, base_np, queries, n_inc: int, t_start: float) -> dict:
    """Phase 6: the paper's build, ``AnnIndex.build(strategy="incremental")``
    with ``BuildParams()`` and the main path's coder over the first ``n_inc``
    rows: seconds (bootstrap, insert batches), n_dists by phase, insert
    batches and ``flash_beam`` launches (one per insert batch: its
    base-layer acquisition), recall@10 at ef ∈ {64, 256}, W ∈ {1, 4} against
    ``exact_knn`` over those rows, the share of rows the base layer reaches
    from the entry, and a profiler window over ``PROFILED_BATCHES`` more
    insert batches (``add`` to a copy: the same program) for the card's
    busy share and the time per insert batch on the host and on the card.
    Beside it the bulk build of the same rows, and the card against the CPU
    path on a ``INC_CHECK_ROWS``-row incremental build with an M = 8 coder (4 bytes per
    packed row: the byte-wise layout). Returns the path's launches (ground
    truth, the incremental build, its searches), the bulk build's beside it
    (build and searches), counted apart, and ``l2_batch``'s ground-truth
    launches. The profiler window and the card-against-CPU build are not
    counted."""
    import torch

    from repro_torch.graph import backends as bk
    from repro_torch.graph.engine import PHASE_NAMES, BuildParams, bfs_reachable
    from repro_torch.graph.hnsw import build_hnsw
    from repro_torch.index import AnnIndex, exact_knn
    from repro_torch.kernels import ops
    from repro_torch.utils import sync

    params = BuildParams()
    kw = dict(d_f=64, m_f=16, l_f=4, h=8)
    data = torch.from_numpy(base_np[:n_inc]).to(dev)
    ops.reset_launches()
    gt = exact_knn(queries, data, k=10)[0].long()
    gt_l2 = ops.launches["l2_batch"]

    def build(strategy):
        sync(dev)
        t0 = time.perf_counter()
        idx = AnnIndex.build(data, algo="hnsw", backend="flash_blocked", strategy=strategy, params=params,
                             backend_kwargs=kw, device=dev)
        sync(dev)
        return idx, time.perf_counter() - t0

    def recalls(idx):
        out = []
        for ef in (64, 256):
            for width in (1, 4):
                idx.search(queries[:32], k=10, ef=ef, width=width)  # warm-up
                sync(dev)
                t0 = time.perf_counter()
                res = idx.search(queries, k=10, ef=ef, width=width)
                sync(dev)
                dt = time.perf_counter() - t0
                if not bool(torch.isfinite(res.dists).all()) or tuple(res.ids.shape) != (QUERIES, 10):
                    raise AssertionError(f"{idx.build_strategy} search ef={ef} width={width}: malformed result")
                out.append({"ef": ef, "width": width, "qps": QUERIES / dt, "recall@10": recall_at(res.ids, gt)})
        return out

    before = dict(ops.launches)
    index, wall = build("incremental")
    st = index.last_stats
    inc_launches = {k: v - before[k] for k, v in ops.launches.items()}
    phases = dict(zip(PHASE_NAMES, st.phases))
    batches = -(-n_inc // params.batch) - 1
    for name in ("bootstrap", "beam_upper", "beam_base"):
        if not phases[name] > 0:
            raise AssertionError(f"the incremental build left phase {name} at 0 n_dists")
    if inc_launches["flash_beam"] != batches or inc_launches["mirror_words"] != batches:
        raise AssertionError(f"{batches} insert batches, yet {inc_launches['flash_beam']} flash_beam launches "
                             f"({inc_launches['mirror_words']} on the word layout)")
    inc_results = recalls(index)
    sync(dev)
    launches = dict(ops.launches)
    inc_reach = float(bfs_reachable(index.graph.adj0.cpu().numpy(), index.graph.entry).mean())
    # more insert batches under the profiler (not counted: the path's
    # launches were read above)
    extra = torch.from_numpy(base_np[n_inc:n_inc + PROFILED_BATCHES * params.batch]).to(dev)
    copies = iter([index.clone(), index.clone()])
    t0 = time.perf_counter()
    window = device_window(lambda: next(copies).add(extra), cpu=False)
    window["warmup_window_and_parse_s"] = time.perf_counter() - t0
    if "window_ms" in window:
        window["host_ms_per_insert_batch"] = window["window_ms"] / PROFILED_BATCHES
        window["device_ms_per_insert_batch"] = window["device_ms"] / PROFILED_BATCHES
    del index, copies
    # the bulk build of the same rows beside it, counted apart from the path
    ops.reset_launches()
    bulk, bulk_wall = build("bulk")
    bulk_build_launches = dict(ops.launches)
    bulk_results = recalls(bulk)
    bulk_reach = float(bfs_reachable(bulk.graph.adj0.cpu().numpy(), bulk.graph.entry).mean())
    bst = bulk.last_stats
    del bulk
    sync(dev)
    bulk_launches = dict(ops.launches)

    # the card against the CPU path: an INC_CHECK_ROWS-row incremental build from one
    # M = 8 coder's state (not counted: both counts were read above)
    d4 = data[:INC_CHECK_ROWS]
    be = bk.make_backend("flash_blocked", d4, seed=0, r_for_blocked=params.r_base, device=dev,
                         d_f=64, m_f=8, l_f=4, h=8)
    state = be.state_dict()
    layout = ops.mirror_layout(be.nbr_codes)
    t0 = time.perf_counter()
    g_gpu, s_gpu = build_hnsw(d4, be, params=params, seed=0, strategy="incremental")
    sync(dev)
    card_s = time.perf_counter() - t0
    be_c = bk.FlashBlockedBackend.from_state(state, device="cpu")
    t0 = time.perf_counter()
    g_cpu, s_cpu = build_hnsw(d4.cpu(), be_c, params=params, seed=0, strategy="incremental")
    cpu_s = time.perf_counter() - t0
    mismatch = int((be.prepare_query(d4).adt_q.cpu() != be_c.prepare_query(d4.cpu()).adt_q).sum())
    same = {"adj0": torch.equal(g_gpu.adj0.cpu(), g_cpu.adj0), "adj_up": torch.equal(g_gpu.adj_up.cpu(), g_cpu.adj_up),
            "mirror": torch.equal(g_gpu.backend.nbr_codes.cpu(), g_cpu.backend.nbr_codes),
            "n_dists_by_phase": list(s_gpu.phases) == list(s_cpu.phases)}
    rows_equal = float((g_gpu.adj0.cpu() == g_cpu.adj0).all(1).double().mean())
    if mismatch == 0 and not all(same.values()):
        raise AssertionError(f"equal query tables, yet the card's incremental build differs from the CPU's: {same}")
    if rows_equal < 0.99:
        raise AssertionError(f"only {rows_equal} of adjacency rows equal the CPU build ({mismatch} level mismatches)")
    emit({"phase": "incremental", "n": n_inc, "build_s": wall, "seconds": st.seconds,
          "n_dists": st.n_dists, "n_dists_by_phase": phases, "n_hops": st.n_hops,
          "insert_batches": batches, "flash_beam_launches": inc_launches["flash_beam"],
          "s_per_insert_batch": st.seconds["insert_batches"] / max(1, batches),
          "results": inc_results, "reachable_from_entry": inc_reach,
          "profile_insert_batches": {"batches": PROFILED_BATCHES, **window},
          "bulk": {"build_s": bulk_wall, "seconds": bst.seconds, "n_dists": bst.n_dists,
                   "n_dists_by_phase": dict(zip(PHASE_NAMES, bst.phases)),
                   "repair_unreachable": bst.repair_unreachable, "results": bulk_results,
                   "reachable_from_entry": bulk_reach,
                   "flash_beam_launches": bulk_build_launches["flash_beam"], "launches": bulk_launches},
          "card_vs_cpu_m8": {"n": INC_CHECK_ROWS, "layout": layout, "card_s": card_s, "cpu_s": cpu_s,
                             "adt_level_mismatch": mismatch, "equal": same, "adj0_rows_equal": rows_equal},
          "launches": launches, "elapsed_s": time.perf_counter() - t_start})
    return launches, bulk_launches, gt_l2


def snapshot_path(index, base_np, queries, spill: str, t_start: float):
    """Phase 7: the main index through the port's snapshot files and back on
    the card (the live index's search ids and distances must come back), then
    the sharded builder's spawn pool: ``ShardedBuilder(workers=2,
    snapshot_path=…, attach=True)`` over the first ``POOL_ROWS`` rows in 8 segments
    must attach segments bit-equal (adj0, adj_up, mirror) to the inline build
    of the same plan. Returns the path's launches (this process's; the pool's
    workers count their own)."""
    import torch

    from repro_torch.graph.engine import BuildParams
    from repro_torch.graph.sharded import model_parallel_wall
    from repro_torch.index import ShardConfig, ShardedBuilder
    from repro_torch.kernels import ops
    from repro_torch.serve import snapshot as snap
    from repro_torch.utils import sync

    dev = queries.device
    ops.reset_launches()
    path = os.path.join(spill, "snapshot", "main")
    sync(dev)
    t0 = time.perf_counter()
    snap.save_index(path, index)
    save_s = time.perf_counter() - t0
    nbytes = snap.snapshot_bytes(path)
    t0 = time.perf_counter()
    loaded = snap.load_index(path, device=dev)
    sync(dev)
    load_s = time.perf_counter() - t0
    live = index.search(queries, k=10, ef=64, width=1)
    back = loaded.search(queries, k=10, ef=64, width=1)
    if not (torch.equal(live.ids, back.ids) and torch.equal(live.dists, back.dists)):
        raise AssertionError("the loaded snapshot searches otherwise than the live index (ef=64, W=1)")
    del loaded
    shutil.rmtree(path, ignore_errors=True)

    rows = POOL_ROWS
    cfg = ShardConfig(n_segments=8, chunk_size=65536, balanced=True, algo="hnsw", backend="flash_blocked",
                      strategy="bulk", params=BuildParams(), backend_kwargs=dict(d_f=64, m_f=16, l_f=4, h=8))
    inline_builder = ShardedBuilder(cfg, workdir=os.path.join(spill, "pool_inline"), device=dev)
    plan = inline_builder.assign(base_np[:rows])
    inline = inline_builder.build(plan=plan)
    sync(dev)
    launches = dict(ops.launches)
    pooled = ShardedBuilder(cfg, workers=2, workdir=os.path.join(spill, "pool"), device=dev).build(
        plan=plan, snapshot_path=os.path.join(spill, "snapshot", "pool"), attach=True)
    for s, (a, b) in enumerate(zip(pooled.index.segments, inline.index.segments)):
        for name, x, y in (("adj0", a.graph.adj0, b.graph.adj0), ("adj_up", a.graph.adj_up, b.graph.adj_up),
                           ("mirror", a.backend.nbr_codes, b.backend.nbr_codes)):
            if not torch.equal(x, y):
                raise AssertionError(f"pool segment {s} differs from the inline build in {name}")
    walls = [m["wall_s"] for m in inline.segments]
    emit({"phase": "snapshot", "n": int(index.n), "save_s": save_s, "load_s": load_s, "snapshot_bytes": nbytes,
          "search_equal_live": True, "pool_rows": plan.n, "pool_segments": plan.n_segments,
          "inline_build_s": inline.wall_build_s, "pool_build_s": pooled.wall_build_s, "pool_workers": 2,
          "model_parallel_wall_2": model_parallel_wall(walls, 2), "inline_segment_build_s": walls,
          "pool_segment_build_s": [m["wall_s"] for m in pooled.segments],
          "pool_pids": sorted({m["pid"] for m in pooled.segments}), "pool_equals_inline": True,
          "launches": launches, "elapsed_s": time.perf_counter() - t_start})
    return launches


def segment_scan_recall(coll, queries, gt, c: int = 256, block: int = 50) -> float:
    """recall@10 of an exhaustive scan of every segment's own codes with the
    queries' ADTs under that segment's coder, keeping the best ``c`` per
    segment, reranking the union exactly (a check, not part of the path)."""
    import torch

    cands = []
    for s, seg in enumerate(coll.segments):
        be = seg.backend
        adt = be.prepare_query(queries).adt_q
        q, m, k = adt.shape
        onehot = torch.zeros((be.n, m * k), device=queries.device)
        onehot.scatter_(1, be.codes.long() + torch.arange(m, device=queries.device) * k, 1.0)
        d = adt.reshape(q, m * k).to(torch.float32) @ onehot.T
        top = torch.topk(d, min(c, be.n), dim=1, largest=False).indices
        cands.append(torch.from_numpy(coll.global_ids(s)).to(queries.device)[top])
    cands = torch.cat(cands, 1)
    raw = coll.raw_vectors
    best = []
    for i in range(0, queries.shape[0], block):
        cb = cands[i:i + block]
        d = ((raw[cb] - queries[i:i + block, None, :]) ** 2).sum(-1)
        best.append(cb.gather(1, torch.topk(d, 10, dim=1, largest=False).indices))
    return recall_at(torch.cat(best), gt)


def timed_search(coll, queries, **kw):
    import torch

    from repro_torch.utils import sync

    coll.search(queries[:32], **kw)  # warm-up
    sync(queries.device)
    t0 = time.perf_counter()
    res = coll.search(queries, **kw)
    sync(queries.device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(res.dists).all()) or tuple(res.ids.shape) != (queries.shape[0], 10):
        raise AssertionError(f"segmented search {kw}: malformed result")
    return res, dt


def scale_out_path(base_np, queries, spill: str, t_start: float):
    """Phases 8–10 on the first rows of the main draw (``base_np``): sharded
    streaming build of all but the last ``ADD_ROWS`` rows, segmented fan-out
    search, routed growth of those rows and deletion, scored against the
    ``exact_knn`` of those rows and then that of the live rows. Returns the path's kernel launches,
    its ``l2_batch`` launches by use (assignment, add, ground truth), the
    collection and the live rows' ground truth."""
    import torch

    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import ShardConfig, ShardedBuilder, exact_knn
    from repro_torch.kernels import ops, ref
    from repro_torch.utils import sync

    dev = queries.device
    n = base_np.shape[0]
    ops.reset_launches()
    gt = exact_knn(queries, torch.from_numpy(base_np).to(dev), k=10)[0].long()
    gt_l2 = ops.launches["l2_batch"]

    # ---- 8. sharded streaming build ----------------------------------------
    builder = ShardedBuilder(
        ShardConfig(n_segments=SEGMENTS, chunk_size=65536, balanced=True, algo="hnsw",
                    backend="flash_blocked", strategy="bulk", params=BuildParams(),
                    backend_kwargs=dict(d_f=64, m_f=16, l_f=4, h=8)),
        workdir=os.path.join(spill, "shard"), device=dev,
    )
    before = dict(ops.launches)
    plan = builder.assign(base_np[: n - ADD_ROWS])
    assign_l2 = ops.launches["l2_batch"] - before["l2_batch"]
    if assign_l2 == 0:
        raise AssertionError("the streaming assignment never launched l2_batch")
    assign_check = assignment_cross_check(base_np[: n - ADD_ROWS], plan, dev)
    res = builder.build(plan=plan)
    coll = res.index
    walls = [m["wall_s"] for m in res.segments]
    phase_s = {}
    for m in res.segments:
        for key, v in m["seconds"].items():
            phase_s[key] = phase_s.get(key, 0.0) + v
    unreach = [m["repair_unreachable"] for m in res.segments]
    emit({"phase": "sharded", "n": n - ADD_ROWS, "segments": plan.n_segments,
          "assign_s": builder.assign_seconds, "seg_size_min": min(plan.seg_sizes),
          "seg_size_max": max(plan.seg_sizes), "build_s": res.wall_build_s,
          "segment_build_s_sum": sum(walls), "segment_build_s_max": max(walls),
          "segment_build_s": walls, "phase_s_sum": phase_s, "repair_unreachable": unreach,
          "n_dists": sum(m["n_dists"] for m in res.segments),
          "n_dists_by_phase": {k: sum(m["phases"][k] for m in res.segments) for k in res.segments[0]["phases"]},
          "assign_l2_batch_launches": assign_l2, "assign_cross_check": assign_check,
          "launches": dict(ops.launches),
          "elapsed_s": time.perf_counter() - t_start})
    if sum(plan.seg_sizes) != n - ADD_ROWS:
        raise AssertionError("the segments do not hold every streamed row")

    # ---- 9. segmented fan-out search ---------------------------------------
    # the default fan-out: on one card, the sequential loop over segments
    results, seq_ids = [], None
    for ef in (64, 256):
        before = dict(ops.launches)
        r, dt = timed_search(coll, queries, k=10, ef=ef, width=4)
        results.append({"ef": ef, "width": 4, "qps": QUERIES / dt, "seconds": dt,
                        "recall@10": recall_at(r.ids, gt), "n_scan": r.n_scan, "n_rerank": r.n_rerank,
                        "flash_beam_launches": ops.launches["flash_beam"] - before["flash_beam"]})
        if ef == 64:
            seq_ids = r.ids
    sync(dev)
    t0 = time.perf_counter()
    fan = coll.search(queries, k=10, ef=64, width=4, fanout=True)
    sync(dev)
    fan_s = time.perf_counter() - t0
    if not torch.equal(fan.ids, seq_ids):
        raise AssertionError("fanout=True returned other ids than the sequential loop (ef=64)")
    scan_rec = segment_scan_recall(coll, queries, gt)
    best = results[-1]["recall@10"]
    emit({"phase": "segmented_search", "queries": QUERIES, "k": 10, "results": results,
          "fanout_equals_sequential": True, "threads_ef64_qps": QUERIES / fan_s,
          "segment_scan_256_recall@10": scan_rec,
          "elapsed_s": time.perf_counter() - t_start})
    if best < min(0.5, 0.5 * scan_rec):
        raise AssertionError(f"segmented recall@10 at ef=256 is {best}, below min(0.5, ½·{scan_rec})")

    # ---- 10. maintenance: routed add, delete -------------------------------
    new = torch.from_numpy(base_np[n - ADD_ROWS:]).to(dev)
    before = dict(ops.launches)
    sync(dev)
    t0 = time.perf_counter()
    gids = coll.add(new)
    sync(dev)
    add_s = time.perf_counter() - t0
    add_l2 = ops.launches["l2_batch"] - before["l2_batch"]
    if add_l2 == 0:
        raise AssertionError("add never launched nearest_centroid's l2_batch")
    if not np.array_equal(gids, np.arange(n - ADD_ROWS, n)):
        raise AssertionError("add assigned other global ids than the stream's")
    route = torch.from_numpy(coll._locate[gids, 0].astype(np.int32)).to(dev)
    flips, near = route_flips(route, ref.l2_batch(new, coll.centroids), l2_atol(new, coll.centroids))
    if flips > near:
        raise AssertionError(f"add: {flips} rows left the plain argmin's segment, {near} at near ties")
    r_add, dt_add = timed_search(coll, queries, k=10, ef=256, width=4)
    rng = np.random.default_rng(0)
    dead = rng.choice(n, DELETE_ROWS, replace=False)
    t0 = time.perf_counter()
    n_dead = coll.delete(dead)
    del_s = time.perf_counter() - t0
    r_del, dt_del = timed_search(coll, queries, k=10, ef=256, width=4)
    if np.isin(r_del.ids.cpu().numpy(), dead).any():
        raise AssertionError("a deleted id came back from search")
    live = np.setdiff1d(np.arange(n), dead)
    live_t = torch.from_numpy(live).to(dev)
    before = ops.launches["l2_batch"]
    gt_live = live_t[exact_knn(queries, torch.from_numpy(base_np[live]).to(dev), k=10)[0].long()]
    sync(dev)
    launches = dict(ops.launches)
    l2_uses = {"assignment": assign_l2, "add": add_l2, "ground_truth": launches["l2_batch"] - before + gt_l2}
    emit({"phase": "maintenance", "added": ADD_ROWS, "add_s": add_s, "add_l2_batch_launches": add_l2,
          "route_flips": flips, "near_tie_flips": near, "n_after_add": coll.n,
          "recall@10_after_add_ef256": recall_at(r_add.ids, gt), "qps_after_add": QUERIES / dt_add,
          "deleted": n_dead, "delete_s": del_s, "n_active": coll.n_active,
          "recall@10_after_delete_ef256": recall_at(r_del.ids, gt_live), "qps_after_delete": QUERIES / dt_del,
          "deleted_ids_returned": 0, "launches": launches, "l2_batch_launches_by_use": l2_uses,
          "elapsed_s": time.perf_counter() - t_start})
    for name in ("flash_round", "flash_beam", "l2_batch"):
        if launches[name] == 0:
            raise AssertionError(f"the scale-out path never launched {name}")
    return launches, l2_uses, coll, gt_live


# ---------------------------------------------------------------------------
# The serving path (phase 7d; the router at the end of the scale-out path)
# ---------------------------------------------------------------------------

SERVE_BLOCKS = (1, 3, 8, 17, 32, 45)  # engine block sizes; 45 > the top bucket (chunked)
SERVE_CLIENTS = 8  # closed-loop client threads of the Runtime waves
SERVE_WAVE = 1000  # requests per wave
# rows the second wave adds, then deletes; the durable Runtime's; the
# segmented replay's add (each add cut from 1,000: PERF.md §4)
SERVE_ADD, SERVE_DELETE = 256, 10000
DURABLE_ADD, DURABLE_DELETE = 256, 5000
SEG_ADD = 256
ROUTER_QUERIES = 256
ROUTER_PROBES = (1, 4, 64)


def fresh_rows(m: int, seed: int, d: int = 128, n_clusters: int = 64) -> np.ndarray:
    """``m`` new rows of the main draw's distribution: the centres and scales
    of ``vector_dataset(0, d=128, n_clusters=64)``, the cluster picks and the
    noise from their own stream ``default_rng([0, seed])``."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    scales = np.linspace(1.0, 0.2, d).astype(np.float32)
    own = np.random.default_rng([0, seed])
    x = centers[own.integers(0, n_clusters, m)]
    x += own.normal(size=(m, d)).astype(np.float32) * scales
    return x


def run_wave(rt, q_np, during=None) -> dict:
    """``SERVE_WAVE`` single-query requests from ``SERVE_CLIENTS`` closed-loop
    client threads (query i is ``q_np[i % len]``); with ``during``, the
    clients send requests for as long as ``during()`` runs on this thread
    and ``SERVE_WAVE`` more after it returned. A shed or rejected request
    is the admission policy's decision and is counted; any other
    exception from a future fails the run. Returns the records and the
    runtime's stats."""
    import threading

    from repro_torch import serve

    lock = threading.Lock()
    nxt = [0]
    limit = [SERVE_WAVE if during is None else float("inf")]
    recs, errors = [], []

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
                if i >= limit[0]:
                    return
            t_sub = time.perf_counter()
            try:
                res = rt.submit(q_np[i % len(q_np)]).result(timeout=120)
                recs.append((i, t_sub, res.ids))
            except (serve.DeadlineExceededError, serve.QueueFullError) as exc:
                recs.append((i, t_sub, type(exc).__name__))
            except BaseException as exc:  # noqa: BLE001 — reported, then the run fails
                errors.append(repr(exc))

    rt.reset_stats()
    threads = [threading.Thread(target=client, name=f"client-{c}") for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    info = None
    if during is not None:
        info = during()
        with lock:
            limit[0] = nxt[0] + SERVE_WAVE
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a Runtime client thread is still waiting after 600 s")
    if errors:
        raise AssertionError(f"{len(errors)} Runtime futures raised: {errors[:3]}")
    st = rt.stats()
    if st["thread_restarts"]:
        raise AssertionError(f"the Runtime's supervisor restarted a loop {st['thread_restarts']} times")
    served = [r for r in recs if not isinstance(r[2], str)]
    return {"recs": served, "info": info, "stats": {
        "requests": len(recs), "served": len(served), "seconds": wall, "qps": len(served) / wall,
        "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"], "queue_p99_ms": st["queue_p99_ms"],
        "service_p50_ms": st["service_p50_ms"], "mean_batch": st["mean_batch"], "batches": st["batches"],
        "rejected": st["rejected"], "shed": st["shed"], "missed": st["deadline_misses"],
        "cold_dispatches": st["cold_dispatches"], "generation": st["generation"]}}


def flip_seconds() -> list:
    """Each recorded generation flip's clone / apply / prepare (warm) / log
    seconds, from the ``serve/flip`` spans."""
    from repro_torch import obs

    return [{"gen": sp.attrs.get("gen"), "total_s": sp.dur_s,
             **{c.name.rsplit("/", 1)[-1] + "_s": c.dur_s for c in sp.children}}
            for sp in obs.spans("serve/flip")]


def serving_path(index, base_np, q_np, queries, spill: str, t_start: float) -> dict:
    """Phase 7d, the serving runtime over the main path's live index:
    the engine (block sizes, warm keys, ids against ``index.search``), the
    Runtime's three waves (no mutation; an add and a delete beside the
    traffic; after both), durability (``init_durable`` → ``attach`` →
    Runtime add/delete → ``recover``, bit-equal) and the snapshot phase's
    8-segment pool manifest adopted as a durable root with one WAL ``add``
    replayed (routed by ``l2_batch``), equal to a live add. Returns the
    path's launches."""
    import torch

    from repro_torch import obs, serve
    from repro_torch.kernels import ops
    from repro_torch.serve.recovery import wal_path
    from repro_torch.utils import sync

    dev = queries.device
    out = {}
    ops.reset_launches()
    t_phase = time.perf_counter()

    # ---- the engine ----------------------------------------------------------
    eng = serve.SearchEngine(index, k=10, ef=64, width=1, rerank=True, q_buckets=(1, 8, 32))
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    compiles = eng.n_compiles
    eng.reset_stats()
    lat = {b: [] for b in SERVE_BLOCKS}  # (queries, seconds) per block, by nominal size
    ids, dists = [], []
    beam0, off, j = ops.launches["flash_beam"], 0, 0
    while off < QUERIES:
        b = min(SERVE_BLOCKS[j % len(SERVE_BLOCKS)], QUERIES - off)
        t0 = time.perf_counter()
        res = eng.search(q_np[off:off + b])
        lat[SERVE_BLOCKS[j % len(SERVE_BLOCKS)]].append((b, time.perf_counter() - t0))
        ids.append(res.ids)
        dists.append(res.dists)
        off += b
        j += 1
    beam_launches = ops.launches["flash_beam"] - beam0
    est = eng.stats()
    eng_ids, eng_d = torch.cat(ids), torch.cat(dists)
    direct = index.search(queries, k=10, ef=64, width=1)
    if eng.n_compiles != compiles:
        raise AssertionError(f"the engine met {eng.n_compiles - compiles} cold keys after warmup")
    if not torch.equal(eng_ids, direct.ids):
        raise AssertionError("the engine's ids differ from index.search(queries, ef=64)")
    if not torch.allclose(eng_d, direct.dists, rtol=1e-5, atol=0.0):
        raise AssertionError("the engine's distances are off index.search's by more than rtol 1e-5")
    if beam_launches != est["blocks"]:
        raise AssertionError(f"{beam_launches} flash_beam launches for {est['blocks']} padded dispatches")
    per_block = {}
    for b, v in lat.items():
        qs, secs = np.array([x[0] for x in v]), np.array([x[1] for x in v])
        per_block[str(b)] = {"blocks": len(v), "queries": int(qs.sum()), "qps": float(qs.sum() / secs.sum()),
                             "p50_ms": float(np.percentile(secs, 50) * 1e3),
                             "p99_ms": float(np.percentile(secs, 99) * 1e3)}
    window = device_window(lambda: [eng.search(q_np[i]) for i in range(100)], cpu=False)
    out["engine"] = {"buckets": [1, 8, 32], "warmup_s": warm_s, "compiles_after_warmup": 0,
                     "keys": compiles, "blocks": est["blocks"], "padded_queries": est["padded_queries"],
                     "flash_beam_launches": beam_launches, "qps": est["qps"], "p50_ms": est["p50_ms"],
                     "p99_ms": est["p99_ms"], "per_block_size": per_block,
                     "n_dists_per_query": est["n_dists_per_query"], "ids_equal_index_search": True,
                     "profile_100_single_queries": window}
    eng_np = eng_ids.cpu().numpy()

    # ---- the Runtime: three waves ----------------------------------------------
    new_rows = fresh_rows(SERVE_ADD, 1)
    dead = np.random.default_rng(18).choice(index.n, SERVE_DELETE, replace=False)
    obs.enable()
    obs.clear_spans()
    try:
        with serve.Runtime(index, k=10, ef=64, q_buckets=(1, 8, 32), max_wait_ms=2.0, max_queue=256,
                           default_deadline_ms=50.0) as rt:
            rt.warmup()
            w1 = run_wave(rt, q_np)
            for i, _, got in w1["recs"]:
                if not np.array_equal(got, eng_np[i % QUERIES]):
                    raise AssertionError(f"wave 1: request {i} returned other ids than the engine")

            def mutate():
                stamp = []
                t0 = time.perf_counter()
                rt.add(new_rows).result(timeout=600)
                add_s = time.perf_counter() - t0
                fut = rt.delete(dead)
                fut.add_done_callback(lambda f: stamp.append(time.perf_counter()))
                fut.result(timeout=600)
                return {"add_s": add_s, "delete_s": time.perf_counter() - t0 - add_s, "resolved": stamp[0]}

            w2 = run_wave(rt, q_np, during=mutate)
            resolved = w2["info"].pop("resolved")
            after = [r for r in w2["recs"] if r[1] > resolved]
            if len(after) < SERVE_WAVE // 2:
                raise AssertionError(f"wave 2: only {len(after)} requests followed the delete")
            bad = sum(bool(np.isin(got, dead).any()) for _, _, got in after)
            if bad:
                raise AssertionError(f"wave 2: {bad} requests submitted after the delete resolved returned a deleted id")
            if w2["stats"]["cold_dispatches"]:
                raise AssertionError(f"wave 2: {w2['stats']['cold_dispatches']} cold dispatches")
            flips = flip_seconds()
            w3 = run_wave(rt, q_np)
            now = rt.handle.current.index
            live = now.search(queries, k=10, ef=64, width=1).ids.cpu().numpy()
            for i, _, got in w3["recs"]:
                if not np.array_equal(got, live[i % QUERIES]):
                    raise AssertionError(f"wave 3: request {i} returned other ids than handle.current.index")
            if np.isin(live, dead).any():
                raise AssertionError("a deleted id came back from the current generation")
            health = rt.health()
            del now
    finally:
        obs.disable()
    out["runtime"] = {"clients": SERVE_CLIENTS, "default_deadline_ms": 50.0, "max_wait_ms": 2.0, "max_queue": 256,
                      "wave1": w1["stats"], "wave2": {**w2["stats"], **w2["info"], "added": SERVE_ADD,
                                                       "deleted": SERVE_DELETE,
                                                       "requests_after_delete": len(after)},
                      "wave3": w3["stats"], "flips": flips, "ids_wave1_equal_engine": True,
                      "ids_wave3_equal_current": True, "healthy": health["healthy"]}

    # ---- durability ----------------------------------------------------------------
    root = os.path.join(spill, "durable")
    sync(dev)
    t0 = time.perf_counter()
    serve.init_durable(root, index)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    handle, ckpt, _ = serve.attach(root, fsync="batch", device=dev)
    attach_s = time.perf_counter() - t0
    try:
        obs.enable()
        obs.clear_spans()
        with serve.Runtime(handle, k=10, ef=64, q_buckets=(1, 8, 32)) as rt:
            rt.add(fresh_rows(DURABLE_ADD, 2)).result(timeout=600)
            rt.delete(np.random.default_rng(19).choice(index.n, DURABLE_DELETE, replace=False)).result(timeout=600)
            if rt.stats()["thread_restarts"]:
                raise AssertionError("the durable Runtime's supervisor restarted a loop")
        durable_flips = flip_seconds()
    finally:
        obs.disable()
        ckpt.close()
        wal = handle.wal.stats()
        handle.wal.close()
    live = handle.current.index
    sync(dev)
    t0 = time.perf_counter()
    rec = serve.recover(root, device=dev)
    sync(dev)
    replay_s = time.perf_counter() - t0
    got, want = rec.index.graph, live.graph
    for name in ("adj0", "adj_up", "levels"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"recover: {name} differs from the live handle's index")
    if got.entry != want.entry or not np.array_equal(rec.index.tombstones, live.tombstones):
        raise AssertionError("recover: the entry or the tombstones differ from the live handle's index")
    if not torch.equal(rec.index.search(queries, k=10, ef=64).ids, live.search(queries, k=10, ef=64).ids):
        raise AssertionError("recover: search ids differ from the live handle's index")
    report = serve.verify_root(root, device=dev)
    if not report["ok"] or report["wal"]["replayable"] != 2:
        raise AssertionError(f"verify_root: {report}")
    out["durability"] = {"n": int(live.n), "added": DURABLE_ADD, "deleted": DURABLE_DELETE,
                         "init_s": init_s, "attach_s": attach_s, "wal_bytes": wal["bytes"],
                         "wal_fsyncs": wal["fsyncs"], "wal_appends": wal["appends"], "replayed": rec.replayed,
                         "recover_s": replay_s, "flips": durable_flips, "recovered_bit_equal": True,
                         "verify_root": {k: report[k] for k in ("ok", "checkpoint_lsn", "wal", "snapshot")}}
    del rec, live, handle
    shutil.rmtree(root, ignore_errors=True)

    # ---- the sharded pool's manifest as a durable root -----------------------------
    manifest = os.path.join(spill, "snapshot", "pool")
    root = os.path.join(spill, "durable_seg")
    rows = fresh_rows(SEG_ADD, 3)
    _, adopted = serve.init_from_manifest(root, manifest, device=dev)
    del adopted
    with serve.WalWriter(wal_path(root), fsync="batch") as w:
        w.append("add", {"vectors": rows})
        w.commit()
    l2_0 = ops.launches["l2_batch"]
    t0 = time.perf_counter()
    rec = serve.recover(root, device=dev)
    sync(dev)
    seg_replay_s = time.perf_counter() - t0
    replay_l2 = ops.launches["l2_batch"] - l2_0
    live = serve.load_index(manifest, device=dev)
    live.add(rows)
    for s, (a, b) in enumerate(zip(rec.index.segments, live.segments)):
        if not np.array_equal(rec.index.global_ids(s), live.global_ids(s)):
            raise AssertionError(f"segmented replay: segment {s} routed other rows than a live add")
        for name, x, y in (("adj0", a.graph.adj0, b.graph.adj0), ("adj_up", a.graph.adj_up, b.graph.adj_up),
                           ("mirror", a.backend.nbr_codes, b.backend.nbr_codes)):
            if not torch.equal(x, y):
                raise AssertionError(f"segmented replay: segment {s} differs from a live add in {name}")
    if replay_l2 == 0:
        raise AssertionError("the segmented replay never launched l2_batch")
    out["segmented_recovery"] = {"segments": len(live.segments), "n": int(live.n), "added": SEG_ADD,
                                 "replay_s": seg_replay_s, "replay_l2_batch_launches": replay_l2,
                                 "equals_live_add": True,
                                 "routed": [int(len(rec.index.global_ids(s))) for s in range(len(live.segments))]}
    del rec, live
    shutil.rmtree(root, ignore_errors=True)
    sync(dev)
    launches = dict(ops.launches)
    emit({"phase": "serving", **out, "launches": launches, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})
    return launches


def serving_router(coll, queries, gt, t_start: float) -> dict:
    """The router half of the serving path, over the scale-out path's
    64-segment collection as phase 10 left it: at n_probe = 64 the ids must
    equal ``SegmentedAnnIndex.search`` at the same spec, and the fan-out
    threads the loop; QPS and recall@10 at each n_probe. Returns its
    launches."""
    import torch

    from repro_torch import serve
    from repro_torch.kernels import ops
    from repro_torch.utils import sync

    dev = queries.device
    q = queries[:ROUTER_QUERIES]
    q_np = q.cpu().numpy()
    ops.reset_launches()
    t_phase = time.perf_counter()
    rows = []
    # one router, warmed once; its probe count is set per row
    router = serve.SegmentRouter(coll, n_probe=len(coll.segments), k=10, ef=64, width=4,
                                 q_buckets=(1, 8, 32), fanout=False).warmup()
    for n_probe in ROUTER_PROBES:
        router.n_probe = n_probe
        sync(dev)
        t0 = time.perf_counter()
        res = router.search(q_np)
        sync(dev)
        dt = time.perf_counter() - t0
        rows.append({"n_probe": n_probe, "qps": ROUTER_QUERIES / dt, "seconds": dt,
                     "recall@10": recall_at(res.ids, gt[:ROUTER_QUERIES]), "n_scan": res.n_scan,
                     "n_rerank": res.n_rerank})
        if n_probe == len(coll.segments):
            want = coll.search(q, k=10, ef=64, width=4)
            if not torch.equal(res.ids, want.ids):
                raise AssertionError("the router at the full probe returned other ids than SegmentedAnnIndex.search")
            router.fanout = True
            if not torch.equal(router.search(q_np).ids, res.ids):
                raise AssertionError("the router's fan-out threads returned other ids than its loop")
            router.fanout = False
    sync(dev)
    launches = dict(ops.launches)
    emit({"phase": "serving_router", "queries": ROUTER_QUERIES, "segments": len(coll.segments), "k": 10,
          "ef": 64, "width": 4, "results": rows, "full_probe_equals_segmented_search": True,
          "fanout_equals_loop": True, "launches": launches, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})
    return launches


def path_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn`` to a synchronized end (one warm-up):
    for calls that wait on the card themselves (a top-k's selection)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def retrieval_path(dev, t_start: float) -> dict:
    """Phase 11: BERT4Rec next-item retrieval at the model's full config.
    Returns the path's kernel launches."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import flash as fl
    from repro_torch.data.synthetic import vector_dataset
    from repro_torch.graph.backends import FlashBackend
    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import AnnIndex
    from repro_torch.kernels import ops, ref
    from repro_torch.models.recsys import bert4rec as b4r
    from repro_torch.models.recsys import retrieval as rt
    from repro_torch.utils import sync, topk_first

    cfg = get_arch("bert4rec").make_full()
    n = cfg.n_items
    ops.reset_launches()
    out = {"n_items": n, "embed_dim": cfg.embed_dim, "n_blocks": cfg.n_blocks, "n_heads": cfg.n_heads,
           "seq_len": cfg.seq_len, "requests": REQUESTS}

    # the model, with the repo's stand-in for a trained table in rows [0, n)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = b4r.Bert4Rec(cfg, gen, device=dev)
    table_np = vector_dataset(0, n=n, d=cfg.embed_dim, n_clusters=256)
    table_np /= np.linalg.norm(table_np, axis=1, keepdims=True)
    with torch.no_grad():
        model.item_embed[:n].copy_(torch.from_numpy(table_np))
    table = model.item_embed.detach()[:n]
    sync(dev)
    out["setup_s"] = time.perf_counter() - t0
    out["model_state_gb"] = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9

    # the requests: 64 sessions ending in [MASK], and one (retrieval_cand)
    items, _ = b4r.sample_training_batch(gen, cfg, REQUESTS)
    items[:, -1] = cfg.mask_id
    q = model.serve(items)
    if tuple(q.shape) != (REQUESTS, cfg.embed_dim) or not bool(torch.isfinite(q).all()):
        raise AssertionError("serve: malformed query vectors")
    out["serve_ms"] = {f"B{REQUESTS}": path_ms(lambda: model.serve(items)), "B1": path_ms(lambda: model.serve(items[:1]))}
    noise = torch.randn((REQUESTS, cfg.embed_dim), generator=gen, device=dev)
    near = table[:REQUESTS] + 0.03 * noise

    # the coder
    t0 = time.perf_counter()
    coder = fl.fit_flash(table, d_f=48, m_f=16, kmeans_iters=10, device=dev)
    codes = fl.encode(coder, table)
    sync(dev)
    out["coder_s"] = time.perf_counter() - t0

    # scoring, each way, at B = 64 and B = 1
    def dense(qq):
        return rt.score_dense(qq, table, k=10)

    def flash(qq, k, rerank):
        return rt.score_flash(qq, coder, codes, table, k=k, rerank=rerank)

    scorers = {"dense": dense, "flash_k10_r8": lambda qq: flash(qq, 10, 8),
               "flash_k100_r4": lambda qq: flash(qq, 100, 4)}
    out["score_ms"], per_call = {}, {}
    for name, fn in scorers.items():
        for b in (REQUESTS, 1):
            before = ops.launches["flash_scan"]
            fn(q[:b])
            per_call[f"{name}_B{b}"] = ops.launches["flash_scan"] - before
            out["score_ms"][f"{name}_B{b}"] = path_ms(lambda fn=fn, b=b: fn(q[:b]))
    out["flash_scan_launches_per_call"] = per_call
    # where score_flash's time goes (k = 10, rerank 8): the scan launches,
    # then the selection of the 80 smallest sums; the rest is the query
    # tables and the rerank
    adt_all = fl.query_ctx(coder, q).adt_q
    stages = {}
    for b in (REQUESTS, 1):
        def scan(b=b):
            return torch.stack([ops.flash_scan(codes, a) for a in adt_all[:b]])
        sums = scan()
        stages[f"scan_B{b}"] = path_ms(scan)
        stages[f"select_B{b}"] = path_ms(lambda sums=sums: topk_first(-sums, 80))
    out["flash_k10_r8_stages_ms"] = stages
    recall = {}
    for qname, qq in (("encoder", q), ("near_item", near)):
        exact = dense(qq)
        if tuple(exact.ids.shape) != (REQUESTS, 10) or not bool(torch.isfinite(exact.scores).all()):
            raise AssertionError("score_dense: malformed result")
        for name in ("flash_k10_r8", "flash_k100_r4"):
            res = scorers[name](qq)
            if not bool(torch.isfinite(res.scores).all()) or not bool(((res.ids >= 0) & (res.ids < n)).all()):
                raise AssertionError(f"{name}: malformed result")
            recall[f"{name}_{qname}"] = rt.retrieval_recall(res, exact, 10)
    out["recall@10_vs_dense"] = recall
    emit({"phase": "retrieval", **out, "elapsed_s": time.perf_counter() - t_start})

    # the graph through the AnnIndex facade over the scan's coder and codes
    t0 = time.perf_counter()
    index = AnnIndex.build(table, algo="hnsw", backend=FlashBackend(coder, codes),
                           params=BuildParams(r_upper=8, r_base=16, ef=48, batch=32), device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    st = index.last_stats
    graph = {"rows": index.n, "build_s": build_s, "seconds": st.seconds, "n_dists": st.n_dists,
             "repair_unreachable": st.repair_unreachable, "flash_round_launches": ops.launches["flash_round"]}
    for qname, qq in (("encoder", q), ("near_item", near)):
        exact = dense(qq)
        for ef in GRAPH_EF:
            rt.search_index(qq, index, table, k=10, ef_search=ef)  # warm-up
            sync(dev)
            t0 = time.perf_counter()
            res = rt.search_index(qq, index, table, k=10, ef_search=ef)
            sync(dev)
            graph[f"qps_{qname}_ef{ef}"] = REQUESTS / (time.perf_counter() - t0)
            if tuple(res.ids.shape) != (REQUESTS, 10) or not bool(torch.isfinite(res.scores).all()):
                raise AssertionError(f"search_index ef={ef}: malformed result")
            graph[f"recall@10_{qname}_ef{ef}"] = rt.retrieval_recall(res, exact, 10)
    sync(dev)
    launches = dict(ops.launches)
    for name in ("flash_scan", "flash_round"):
        if launches[name] == 0:
            raise AssertionError(f"the retrieval path never launched {name}")

    # checks against the plain versions and the CPU path (their launches
    # are not the path's: the counts were read above)
    adt = fl.query_ctx(coder, q[:1]).adt_q[0]
    if not torch.equal(ops.flash_scan(codes, adt), ref.flash_scan(codes, adt)):
        raise AssertionError("flash_scan differs from its plain version over the catalog")
    cpu_coder = coder._replace(**{f: getattr(coder, f).cpu() for f in coder._fields})
    q8 = q[:8]
    levels_differ = (fl.query_ctx(coder, q8).adt_q.cpu() != fl.query_ctx(cpu_coder, q8.cpu()).adt_q).flatten(1).any(1)
    card_ids = flash(q8, 10, 8).ids.cpu()
    cpu_ids = rt.score_flash(q8.cpu(), cpu_coder, codes.cpu(), table.cpu(), k=10, rerank=8).ids
    same = (card_ids == cpu_ids).all(1)
    if not bool(same[~levels_differ].all()):
        raise AssertionError("score_flash on the card returned other ids than the CPU path with equal ADTs")
    emit({"phase": "retrieval_graph", **graph, "launches": launches, "flash_scan_card_equals_plain": True,
          "card_equals_cpu_queries": int(same.sum()), "adt_level_mismatch_queries": int(levels_differ.sum()),
          "elapsed_s": time.perf_counter() - t_start})
    # The sanity floor: on the near-item queries, the graph at the widest
    # beam must reach half the recall of score_flash at k = 10, rerank 8.
    # At the example's ef = 96 the graph's share of the scan's recall falls
    # with the catalog's size, in the reference as in the port (0.91 at 20k
    # rows, 0.85 at 50k, 0.26 at 1M: PERF.md, PR 13), and the untrained
    # encoder's queries (norm 8 against unit rows) fall faster; both are
    # reported, not held.
    got = graph[f"recall@10_near_item_ef{GRAPH_EF[-1]}"]
    floor = 0.5 * recall["flash_k10_r8_near_item"]
    if got < floor:
        raise AssertionError(f"graph recall@10 (near-item, ef={GRAPH_EF[-1]}) {got} below ½ of score_flash's ({floor})")
    return launches


# ---------------------------------------------------------------------------
# The training path (phase 12)
# ---------------------------------------------------------------------------

#: the train step's settings: the reference's recsys test's (tests/test_recsys.py:107-108)
TRAIN_OPT = dict(lr=3e-3, warmup_steps=0, schedule="constant")
TRAIN_STEPS = 30
TRAIN_SESSIONS = 64  # sessions per step on one card: train_batch's 65,536 is a pod's global batch (PERF.md §4)
TRAIN_MICROBATCHES = 8
TRAIN_SEED = 0


def noise_count(got, want, *, lr: float, steps: int, what: str) -> int:
    """Elements of ``got`` beyond atol/rtol 1e-4 of ``want``; every element
    must lie within 2·steps·lr of it (AdamW moves a parameter whose
    gradient is float noise by ±lr a step, whichever sign the noise has).
    Returns the count, which the caller holds to 1 in 10,000."""
    got = got.double()
    want = want.double().to(got.device)
    diff = (got - want).abs()
    if not bool((diff <= 2 * steps * lr + 1e-4).all()):
        raise AssertionError(f"{what}: {float(diff.max())} apart, beyond 2·steps·lr")
    return int((diff > 1e-4 + 1e-4 * want.abs()).sum())


def train_card_vs_cpu(dev) -> dict:
    """Phase 12 (a): ``make_train_step`` at the reduced config on the card
    and on the CPU from one set of numpy parameters and the same 3 batches,
    2 microbatches, once per compression. Loss and lr must agree at rtol
    1e-5 and grad_norm at rtol 1e-4; every parameter, moment and residual
    within atol/rtol 1e-4 except at most 1 in 10,000 elements, each within
    2·steps·lr (float32 sums in another order; ``noise_count``)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.recsys import bert4rec as b4r
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    from repro_torch.utils import tree_map, tree_paths, tree_size

    cfg = get_arch("bert4rec").make_reduced()
    gen = torch.Generator()
    gen.manual_seed(TRAIN_SEED)
    params_np = b4r.params_to_jax(b4r.Bert4Rec(cfg, gen, device="cpu"))
    rng = np.random.default_rng([TRAIN_SEED, 1])
    batches = []
    for _ in range(3):
        items = rng.integers(0, cfg.n_items, (8, cfg.seq_len)).astype(np.int32)
        mask = rng.random((8, cfg.seq_len)) < cfg.mask_prob
        mask[:, -1] = True
        batches.append({"items": items.reshape(2, 4, -1), "mask_positions": mask.reshape(2, 4, -1)})

    def loss_fn(p, batch):
        return b4r.bert4rec_loss(p, cfg, batch["items"], batch["mask_positions"]), {}

    out = {}
    for compression in ("none", "bf16", "int8_ef"):
        tc = tl.TrainConfig(opt=opt.AdamWConfig(**TRAIN_OPT), microbatches=2, compression=compression)
        step = tl.make_train_step(loss_fn, tc)
        trees, metrics = {}, {}
        for device in (str(dev), "cpu"):
            tree = tl.init_train_state(tree_map(lambda a, d=device: torch.from_numpy(a).to(d), params_np), tc).tree()
            ms = []
            for b in batches:
                tree, m = step(tree, {k: torch.from_numpy(v).to(device) for k, v in b.items()})
                ms.append({k: float(v) for k, v in m.items()})
            trees[device], metrics[device] = tree, ms
        for mc, mp in zip(metrics[str(dev)], metrics["cpu"]):
            for k in mp:
                rtol = 1e-4 if k == "grad_norm" else 1e-5
                if not np.isclose(mc[k], mp[k], rtol=rtol, atol=0.0):
                    raise AssertionError(f"train step {compression}: {k} {mc[k]} on the card, {mp[k]} on the CPU")
        noise, worst = 0, 0.0
        for (path, a), b in zip(tree_paths(trees[str(dev)]), [leaf for _, leaf in tree_paths(trees["cpu"])]):
            noise += noise_count(a.float(), b.float(), lr=TRAIN_OPT["lr"], steps=len(batches), what=path)
            worst = max(worst, float((a.float().cpu() - b.float()).abs().max()))
        size = tree_size(trees["cpu"])
        if noise > size // 10_000:
            raise AssertionError(f"train step {compression}: {noise} of {size} elements differ card vs CPU")
        out[compression] = {"loss": [m["loss"] for m in metrics[str(dev)]],
                            "cpu_loss": [m["loss"] for m in metrics["cpu"]],
                            "elements_beyond_1e-4": noise, "elements": size, "max_abs_diff": worst}
    return out


def training_path(dev, t_start: float) -> dict:
    """Phase 12: BERT4Rec training on the card. (a) the train step card
    against CPU at the reduced config (``train_card_vs_cpu``); (b) ``train``
    at the full config for 30 steps of 64 sessions (8 microbatches of 8),
    checkpoints every 10, keep 2; (c) the step-20 checkpoint resumed to step
    30; (d) the step-30 checkpoint served through ``score_flash``. Returns
    the path's kernel launches ((b)–(d))."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import flash as fl
    from repro_torch.data.pipeline import microbatch_reshape, sharded_batches
    from repro_torch.kernels import ops
    from repro_torch.models.recsys import bert4rec as b4r
    from repro_torch.models.recsys import retrieval as rt
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    from repro_torch.utils import sync, tree_bytes, tree_leaves, tree_paths

    t_phase = time.perf_counter()
    out = {"card_vs_cpu_reduced": train_card_vs_cpu(dev)}
    out["card_vs_cpu_s"] = time.perf_counter() - t_phase

    cfg = get_arch("bert4rec").make_full()
    n = cfg.n_items
    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_train")
    shutil.rmtree(ckdir, ignore_errors=True)
    tc = tl.TrainConfig(opt=opt.AdamWConfig(**TRAIN_OPT), microbatches=TRAIN_MICROBATCHES,
                        checkpoint_every=10, keep_checkpoints=2, log_every=1)
    masked = {}

    def make_batch(step: int, shard: int) -> dict:
        """The step's 64 sessions, drawn on the card from a generator seeded
        by (seed, step): a resumed run replays the same data."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(TRAIN_SEED * 1_000_003 + step * 101 + shard)
        items, mask = b4r.sample_training_batch(gen, cfg, TRAIN_SESSIONS)
        masked[step] = int(mask.sum())
        return microbatch_reshape({"items": items, "mask_positions": mask}, TRAIN_MICROBATCHES)

    def loss_fn(p, batch):
        return b4r.bert4rec_loss(p, cfg, batch["items"], batch["mask_positions"]), {}

    def fresh_params():
        gen = torch.Generator(device=dev)
        gen.manual_seed(TRAIN_SEED)
        return b4r.params_tree(b4r.Bert4Rec(cfg, gen, device=dev))

    try:
        # (b) train at full width
        params = fresh_params()
        out["params_gb"] = tree_bytes(params) / 1e9
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        sync(dev)
        t0 = time.perf_counter()
        state, hist = tl.train(loss_fn, params, sharded_batches(make_batch, shard_id=0), tc=tc,
                               n_steps=TRAIN_STEPS, ckpt_dir=ckdir, log_fn=lambda _: None)
        sync(dev)
        wall = time.perf_counter() - t0
        step_s = [1.0 / h["steps_per_s"] for h in hist]
        med = float(np.median(step_s[5:]))
        per_step_masked = float(np.mean([masked[s] for s in range(TRAIN_STEPS)]))
        losses = [h["loss"] for h in hist]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"training: the loss did not fall ({losses[0]} at step 1, {losses[-1]} at 30)")
        out["train"] = {
            "steps": TRAIN_STEPS, "sessions_per_step": TRAIN_SESSIONS, "microbatches": TRAIN_MICROBATCHES,
            "wall_s": wall, "s_per_step_median_6_30": med, "s_per_step": step_s,
            "sessions_per_s": TRAIN_SESSIONS / med, "masked_per_s": per_step_masked / med,
            "masked_per_step": per_step_masked, "loss_step1": losses[0], "loss_step30": losses[-1],
            "grad_norm_step30": hist[-1]["grad_norm"], "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "checkpoints": ck.list_checkpoints(ckdir)}
        if ck.list_checkpoints(ckdir) != [20, 30]:
            raise AssertionError(f"training kept checkpoints {ck.list_checkpoints(ckdir)}, not [20, 30]")
        final = state.tree()
        # checkpoint cost: one more save of the final state, and its restore
        ckbench = os.path.join(ckdir, "bench")
        sync(dev)
        t0 = time.perf_counter()
        path = ck.save_checkpoint(ckbench, TRAIN_STEPS, final)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t0 = time.perf_counter()
        back, _ = ck.restore_checkpoint(ckbench, final)
        sync(dev)
        restore_s = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(final))):
            raise AssertionError("training: a restored checkpoint differs from the state it saved")
        del back
        shutil.rmtree(ckbench)
        out["checkpoint"] = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s}

        # (c) resume the step-20 checkpoint into a fresh state, to step 30
        t0 = time.perf_counter()
        rdir = os.path.join(ckdir, "resume")
        shutil.copytree(os.path.join(ckdir, f"step_{20:010d}"), os.path.join(rdir, f"step_{20:010d}"))
        logs = []
        resumed, rhist = tl.train(loss_fn, fresh_params(), sharded_batches(make_batch, shard_id=0, start_step=20),
                                  tc=tc, n_steps=TRAIN_STEPS, ckpt_dir=rdir, log_fn=logs.append)
        if logs[:1] != ["[train] resumed from step 20"] or [h["step"] for h in rhist] != list(range(21, 31)):
            raise AssertionError(f"resume: {logs[:1]}, steps {[h['step'] for h in rhist]}")
        noise, equal, worst = 0, 0, 0.0
        for (path_, a), b in zip(tree_paths(resumed.tree()), tree_leaves(final)):
            noise += noise_count(a.float(), b.float(), lr=TRAIN_OPT["lr"], steps=10, what=path_)
            equal += int(torch.equal(a, b))
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        size = sum(t.numel() for t in tree_leaves(final))
        if noise > size // 10_000:
            raise AssertionError(f"resume: {noise} of {size} elements differ from the uninterrupted run")
        out["resume"] = {"from_step": 20, "loss_step30": rhist[-1]["loss"],
                         "loss_step30_uninterrupted": losses[-1], "leaves_bit_equal": equal,
                         "leaves": len(tree_leaves(final)), "elements_beyond_1e-4": noise,
                         "max_abs_diff": worst, "resume_s": time.perf_counter() - t0}
        shutil.rmtree(rdir)
        del resumed

        # the card's busy share over two train steps (not the path: the
        # launch counts were read in (d); these steps' results are dropped)
        step_fn = tl.make_train_step(loss_fn, tc)
        wb = [make_batch(TRAIN_STEPS + i, 0) for i in range(2)]
        t0 = time.perf_counter()
        out["profile_2_steps"] = device_window(lambda: [step_fn(final, b) for b in wb], cpu=False)
        out["profile_2_steps"]["profile_s"] = time.perf_counter() - t0
        del state, final, params

        # (d) serve from the step-30 checkpoint
        t0 = time.perf_counter()
        like = {"params": fresh_params()}
        restored, step = ck.restore_checkpoint(ckdir, like)
        model = b4r.params_from_jax(restored["params"], cfg, device=dev)
        del like, restored
        gen = torch.Generator(device=dev)
        gen.manual_seed(TRAIN_SEED + 1)
        items, _ = b4r.sample_training_batch(gen, cfg, REQUESTS)
        items[:, -1] = cfg.mask_id
        q = model.serve(items)
        table = model.item_embed.detach()[:n]
        coder = fl.fit_flash(table, d_f=48, m_f=16, kmeans_iters=10, device=dev)
        codes = fl.encode(coder, table)
        sync(dev)
        before = ops.launches["flash_scan"]
        res = rt.score_flash(q, coder, codes, table, k=10, rerank=8)
        sync(dev)
        per_query = (ops.launches["flash_scan"] - before) / REQUESTS
        launches = dict(ops.launches)
        exact = rt.score_dense(q, table, k=10)
        if (step != TRAIN_STEPS or tuple(res.ids.shape) != (REQUESTS, 10) or not bool(torch.isfinite(res.scores).all())
                or not bool(((res.ids >= 0) & (res.ids < n)).all())):
            raise AssertionError("serving the trained checkpoint: malformed result")
        if per_query != 1:
            raise AssertionError(f"score_flash launched flash_scan {per_query} times a query, not once")
        # the CPU path from the same coder and codes on 8 queries
        cpu_coder = coder._replace(**{f: getattr(coder, f).cpu() for f in coder._fields})
        q8 = q[:8]
        levels_differ = (fl.query_ctx(coder, q8).adt_q.cpu() != fl.query_ctx(cpu_coder, q8.cpu()).adt_q).flatten(1).any(1)
        cpu_ids = rt.score_flash(q8.cpu(), cpu_coder, codes.cpu(), table.cpu(), k=10, rerank=8).ids
        same = (res.ids[:8].cpu() == cpu_ids).all(1)
        if not bool(same[~levels_differ].all()):
            raise AssertionError("serving the trained checkpoint: the card's ids differ from the CPU path's")
        out["serve"] = {"restored_step": step, "requests": REQUESTS, "serve_and_coder_s": time.perf_counter() - t0,
                        "flash_scan_per_query": per_query, "recall@10_vs_dense": rt.retrieval_recall(res, exact, 10),
                        "card_equals_cpu_queries": int(same.sum()), "adt_level_mismatch_queries": int(levels_differ.sum()),
                        "query_norm_mean": float(q.norm(dim=1).mean())}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    emit({"phase": "training", **out, "launches": launches, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})
    return launches


# ---------------------------------------------------------------------------
# The LM serving path (phase 13)
# ---------------------------------------------------------------------------

LM_SEED = 0
BF16_TENSOR_OPS_PER_S = 989e12  # dense bf16 on the tensor cores, NVIDIA data sheet
#: the cells (PERF.md §4 gives the cuts): (arch, depth or None for the full
#: depth, batch, prompt length, greedy decode tokens, cache length S_max)
LM_CELLS = (
    ("llama3.2-3b", None, 2, 32256, 64, 32768),
    ("deepseek-v3-671b", 4, 2, 4096, 32, 4224),
    ("qwen1.5-0.5b", None, 2, 4096, 32, 4224),
)
LM_WINDOW_STEPS = 2  # decode steps under the profiler (4 cut, PERF.md §4)
LM_MOE_CHECK_PROMPT = 64  # the MoE config's decode-equals-prefill prompt
LM_WARMUP_PROMPT = 512  # the warm-up prefill's prompt: one query block of each config
LM_ARCHS = ("qwen2-72b", "qwen1.5-0.5b", "llama3.2-3b", "deepseek-v3-671b", "moonshot-v1-16b-a3b")
#: decode against prefill, bf16 at full width: the largest |Δ| of the logits
#: allowed, eight bfloat16 steps at |logit| ≈ 4 (0.062–0.087 measured on the
#: H100; PERF.md §6)
LM_DECODE_ATOL = 0.25
#: card against CPU in float32, TF32 off: the reduced configs, and llama's
#: full width at depth 2 (sums of 3,072 and 8,192 terms). Measured on the
#: H100 (PERF.md §6): 3.3e-6–7.7e-6; the control, the card with TF32 on,
#: 3.4e-3–7.8e-3, which must stay above the bound
LM_CARD_ATOL = 1e-4


def lm_card_vs_cpu(dev, make_cfg, label: str, prompt: int, atol: float) -> dict:
    """Check (b): one set of float32 weights on the card and the CPU; the
    prefill logits and caches and 4 decode steps (fixed tokens) allclose.
    The control: the card's side again with TF32 on, whose reading the
    bound must lie below."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.utils import tree_map

    cfg = make_cfg()
    gen = torch.Generator()
    gen.manual_seed(LM_SEED)
    cpu = tfm.init_lm(gen, cfg, device="cpu")
    card = tree_map(lambda t: t.to(dev), cpu)
    rng = np.random.default_rng([LM_SEED, prompt])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, prompt + 4)))

    def run(params, d) -> dict:
        logits, caches = tfm.lm_prefill(params, cfg, toks[:, :prompt].to(d), s_max=prompt + 4)
        out = {"prefill_logits": logits.cpu(), "caches": {k: v.cpu().clone() for k, v in caches.items()}}
        for i in range(4):
            pos = torch.tensor(prompt + i, device=d) if d.type == "cuda" else prompt + i
            logits, _ = tfm.lm_decode_step(params, cfg, caches, toks[:, prompt + i].to(d), pos)
            out[f"decode_logits_{i}"] = logits.cpu()
        out["caches_after_decode"] = {k: v.cpu() for k, v in caches.items()}
        return out

    def worst(got: dict, want: dict) -> dict:
        def diff(a, b) -> float:
            if isinstance(b, dict):
                return max(diff(a[k], b[k]) for k in b)
            return float((a.double() - b.double()).abs().max())

        w = {k: diff(got[k], want[k]) for k in want}
        return {"prefill_logits": w["prefill_logits"], "caches": max(w["caches"], w["caches_after_decode"]),
                "decode_logits": max(v for k, v in w.items() if k.startswith("decode"))}

    want = run(cpu, torch.device("cpu"))
    sound = worst(run(card, dev), want)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = worst(run(card, dev), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if not all(np.isfinite(v) and v <= atol for v in sound.values()):
        raise AssertionError(f"lm card vs CPU ({label}): {sound} beyond atol {atol}")
    if not max(control.values()) > atol:
        raise AssertionError(f"lm card vs CPU ({label}): atol {atol} does not tell TF32 ({control}) from float32")
    return {"max_abs_diff": sound, "atol": atol, "tf32_control_max_abs_diff": control}


def lm_cell(dev, arch: str, depth, batch: int, prompt: int, n_decode: int, s_max: int) -> dict:
    """One config at full width: prefill, check (a), greedy decode, a
    profiler window. Returns the cell's numbers."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import lm_decode_flops, lm_prefill_flops
    from repro_torch.models import transformer as tfm
    from repro_torch.utils import sync, tree_bytes, tree_map

    cfg = get_arch(arch).make_full()
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    out = {"arch": arch, "n_layers": cfg.n_layers, "batch": batch, "prompt": prompt, "s_max": s_max,
           "decode_tokens": n_decode, "params_b": cfg.param_count() / 1e9,
           "active_params_b": cfg.active_param_count() / 1e9}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    params = tfm.serving_params(tfm.init_lm(gen, cfg, device=dev), cfg)
    sync(dev)
    out["init_s"] = time.perf_counter() - t0
    out["serving_params_gb"] = tree_bytes(params) / 1e9
    toks = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen, device=dev)

    # a warm-up prefill of one query block, so that the timed one pays no
    # first call's costs
    warm = toks[:, :LM_WARMUP_PROMPT]
    sync(dev)
    t0 = time.perf_counter()
    tfm.lm_prefill(params, cfg, warm)
    sync(dev)
    out["prefill_warmup"] = {"prompt": int(warm.shape[1]), "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    logits, caches = tfm.lm_prefill(params, cfg, toks, s_max=s_max)
    sync(dev)
    prefill_s = time.perf_counter() - t0
    if tuple(logits.shape) != (batch, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: prefill logits malformed")
    flops = lm_prefill_flops(cfg, batch, prompt)
    out["prefill"] = {"s": prefill_s, "tokens_per_s": batch * prompt / prefill_s,
                      "model_tflops_per_s": flops / prefill_s / 1e12,
                      "share_of_bf16_peak": flops / prefill_s / BF16_TENSOR_OPS_PER_S}
    out["cache_gb"] = tree_bytes(caches) / 1e9

    # (a) decode the last prompt token at S − 1 against the prefill's caches
    if cfg.moe is None:
        dec, _ = tfm.lm_decode_step(params, cfg, caches, toks[:, -1], torch.tensor(prompt - 1, device=dev))
        want, check_prompt = logits, prompt
    else:
        # the MoE config at a short prompt and a capacity factor at which no
        # step drops a token (capacity = n for prefill and decode alike)
        check_prompt = LM_MOE_CHECK_PROMPT
        ccfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.n_experts
                                                                                              / cfg.moe.top_k)))
        want, short = tfm.lm_prefill(params, ccfg, toks[:, :check_prompt])
        dec, _ = tfm.lm_decode_step(params, ccfg, short, toks[:, check_prompt - 1],
                                    torch.tensor(check_prompt - 1, device=dev))
        del short
    delta = float((dec - want).abs().max())
    same = dec.argmax(-1) == want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    out["decode_equals_prefill"] = {"prompt": check_prompt, "argmax_equal_rows": int(same.sum()),
                                    "max_abs_diff": delta, "atol": LM_DECODE_ATOL,
                                    "prefill_top2_margin": (top2[:, 0] - top2[:, 1]).tolist()}
    if not bool(same.all()) or not delta <= LM_DECODE_ATOL:
        raise AssertionError(f"{arch}: decode at S − 1 against prefill: {out['decode_equals_prefill']}")

    # greedy decode from the prefill's last logits
    tok = logits.argmax(-1)
    step_s, generated = [], []
    for i in range(n_decode):
        t0 = time.perf_counter()
        step_logits, _ = tfm.lm_decode_step(params, cfg, caches, tok, torch.tensor(prompt + i, device=dev))
        tok = step_logits.argmax(-1)
        sync(dev)
        step_s.append(time.perf_counter() - t0)
        generated.append(tok)
    if not bool(torch.isfinite(step_logits).all()):
        raise AssertionError(f"{arch}: decode logits not finite")
    med = float(np.median(step_s))
    dflops = lm_decode_flops(cfg, batch, s_max)
    out["decode"] = {"ms_per_step_median": med * 1e3, "ms_per_step_first": step_s[0] * 1e3,
                     "tokens_per_s": batch / med, "model_tflops_per_s": dflops / med / 1e12,
                     "share_of_bf16_peak": dflops / med / BF16_TENSOR_OPS_PER_S,
                     "tokens_row0": torch.stack(generated)[:8, 0].tolist()}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # where a decode step's time goes: a profiler window over 4 steps
    pos = [prompt + n_decode]

    def steps():
        for _ in range(LM_WINDOW_STEPS):
            tfm.lm_decode_step(params, cfg, caches, tok, torch.tensor(pos[0], device=dev))
            pos[0] += 1

    out["profile_4_decode_steps"] = device_window(steps)
    del caches

    # where a prefill's time goes: a profiler window over the prompt at its
    # full length through the model cut to one layer of each kind
    one = dataclasses.replace(cfg, n_layers=1 if cfg.moe is None else 2, moe_first_dense=int(cfg.moe is not None))
    cut = dict(params)
    for key in ("blocks_dense", "blocks_moe"):
        if cut.get(key) is not None:
            cut[key] = tree_map(lambda t: t[:1], cut[key])
    window = device_window(lambda: tfm.lm_prefill(cut, one, toks), cpu=False)
    out["profile_prefill_one_layer_each"] = {"n_layers": one.n_layers, **window}
    del params, cut
    torch.cuda.empty_cache()
    return out


def lm_serving_path(dev, t_start: float) -> None:
    """Phase 13: the LM family serving prefill and decode (``LM_CELLS``),
    then check (b), the card against the CPU in float32."""
    import torch

    from repro_torch.configs.registry import get_arch

    t_phase = time.perf_counter()
    out = {"cells": [lm_cell(dev, *cell) for cell in LM_CELLS]}
    t0 = time.perf_counter()
    card_cpu = {}
    for arch in LM_ARCHS:
        card_cpu[arch] = lm_card_vs_cpu(dev, get_arch(arch).make_reduced, arch, 12, LM_CARD_ATOL)
    llama2 = lambda: dataclasses.replace(get_arch("llama3.2-3b").make_full(), n_layers=2, dtype=torch.float32)
    card_cpu["llama3.2-3b@2"] = lm_card_vs_cpu(dev, llama2, "llama3.2-3b@2", 16, LM_CARD_ATOL)
    out["card_vs_cpu"] = card_cpu
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    emit({"phase": "lm_serving", **out, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})


# ---------------------------------------------------------------------------
# The LM training path (phase 14)
# ---------------------------------------------------------------------------

#: the cells (PERF.md §4 gives the cuts): (arch, depth or None for the full
#: depth, rows per microbatch, microbatches)
LM_TRAIN_CELLS = (
    ("llama3.2-3b", None, 1, 1),
    ("qwen1.5-0.5b", None, 1, 2),
    ("moonshot-v1-16b-a3b", 5, 1, 1),
    ("deepseek-v3-671b", 3, 1, 1),
)
LM_TRAIN_SEQ = 4096  # train_4k's seq_len (src/repro/configs/registry.py:31)
LM_TRAIN_STEPS = 8  # 12 cut to 10, then 8, to keep the whole smoke inside its limit (PERF.md §4)
LM_TRAIN_PROFILED = 1  # steps under the profiler, after the timed ones (2 cut to 1, PERF.md §4)
#: card against CPU, float32 storage and compute, TF32 off, one train step:
#: every compared tensor (the loss, each metric, grad_norm, and every
#: parameter and moment leaf after the step) within this share of its
#: largest magnitude; a parameter also within 2·lr, as a first AdamW step
#: moves an element whose gradient is float noise by up to lr either way
#: (qwen's zero-initialised biases after one step are that step alone)
LM_TRAIN_CARD_RTOL = 1e-4


def lm_train_opt(cfg):
    """The phase's AdamW: ``lm_opt_cfg``'s moments, lr 3e-4 held constant
    after 2 warm-up steps."""
    from repro_torch.launch.steps import lm_opt_cfg

    return dataclasses.replace(lm_opt_cfg(cfg), lr=3e-4, warmup_steps=2, schedule="constant")


def lm_train_card_vs_cpu(dev, make_cfg, label: str, batch: int, seq: int) -> dict:
    """Check (b): one train step (``lm_train_step``, functional) in float32,
    parameters stored in float32 too, from one set of weights and one
    ``lm_batch`` on the card and the CPU. Each compared tensor's largest
    difference over its bound (``LM_TRAIN_CARD_RTOL`` of its largest
    magnitude, plus 2·lr for a parameter) must stay within 1; the card's
    step again with TF32 on (the control) must exceed it somewhere."""
    import torch

    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.train.train_loop import TrainConfig, init_train_state
    from repro_torch.utils import tree_leaves, tree_map

    t_check = time.perf_counter()
    cfg = dataclasses.replace(make_cfg(), dtype=torch.float32, param_dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    cpu = tree_map(lambda t: t.cpu(), tfm.init_lm(gen, cfg, device=dev))  # drawn on the card: faster
    data = lm_batch(LM_SEED, 0, 0, batch=batch, seq=seq, vocab=cfg.vocab, device="cpu")
    tc = TrainConfig(opt=lm_train_opt(cfg))
    step = lm_train_step(cfg, tc)

    def run(d) -> dict:
        params = cpu if d.type == "cpu" else tree_map(lambda t: t.to(d), cpu)
        tree, metrics = step(init_train_state(params, tc).tree(), {k: v.to(d) for k, v in data.items()})
        opt = tree["opt_state"]
        return {"metrics": metrics, "params": tree_leaves(tree["params"]),
                "moments": tree_leaves(opt.mu) + tree_leaves(opt.nu)}

    def ratios(got: dict, want: dict) -> dict:
        """Each group's largest difference over its bound."""
        lr = float(want["metrics"]["lr"])

        def ratio(a, b, atol: float = 0.0) -> float:
            a, b = a.to(torch.float64), b.to(torch.float64)
            return float((a - b).abs().max()) / (LM_TRAIN_CARD_RTOL * float(b.abs().max()) + atol or 1e-30)

        out = {k: ratio(got["metrics"][k], v) for k, v in want["metrics"].items()}
        out["params"] = max(ratio(a, b, 2 * lr) for a, b in zip(got["params"], want["params"]))
        out["moments"] = max(ratio(a, b) for a, b in zip(got["moments"], want["moments"]))
        return out

    t0 = time.perf_counter()
    want = run(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    want = {k: tree_map(lambda t: t.to(dev), v) for k, v in want.items()}  # compared on the card
    sound = ratios(run(dev), want)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = ratios(run(dev), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if not all(np.isfinite(v) and v <= 1.0 for v in sound.values()):
        raise AssertionError(f"lm train step card vs CPU ({label}): difference over bound {sound}")
    if not max(control.values()) > 1.0:
        raise AssertionError(f"lm train step card vs CPU ({label}): the bound does not tell TF32 ({control}) "
                             "from float32")
    return {"difference_over_bound": sound, "rtol": LM_TRAIN_CARD_RTOL,
            "tf32_control_difference_over_bound": control, "loss": float(want["metrics"]["loss"]),
            "cpu_step_s": cpu_s, "s": time.perf_counter() - t_check}


def lm_train_cell(dev, arch: str, depth, rows: int, microbatches: int) -> dict:
    """One config at full width trained by ``train`` (the donated step) for
    ``LM_TRAIN_STEPS`` steps of ``lm_batch`` data at S = 4,096, then a
    profiler window over ``LM_TRAIN_PROFILED`` more. Returns the cell's
    numbers; the loss must fall and stay finite."""
    t_cell = time.perf_counter()
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import microbatch_reshape, prefetch, sharded_batches
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.steps import lm_loss_fn, lm_train_flops, lm_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.train.train_loop import TrainConfig, train
    from repro_torch.utils import sync, tree_bytes

    cfg = get_arch(arch).make_full()
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    tc = TrainConfig(opt=lm_train_opt(cfg), microbatches=microbatches, log_every=1,
                     checkpoint_every=LM_TRAIN_STEPS + 1)
    batch = rows * microbatches
    out = {"arch": arch, "n_layers": cfg.n_layers, "n_moe_layers": cfg.n_moe_layers, "remat": cfg.remat,
           "batch": batch, "microbatches": microbatches, "seq": LM_TRAIN_SEQ,
           "params_b": cfg.param_count() / 1e9, "active_params_b": cfg.active_param_count() / 1e9,
           "param_dtype": str(cfg.param_dtype), "moments": tc.opt.state_dtype}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    params = tfm.init_lm(gen, cfg, device=dev)
    sync(dev)
    out["init_s"] = time.perf_counter() - t0
    out["params_gb"] = tree_bytes(params) / 1e9

    def make_batch(step: int, shard: int) -> dict:
        b = lm_batch(LM_SEED, step, shard, batch=batch, seq=LM_TRAIN_SEQ, vocab=cfg.vocab, device=dev)
        return microbatch_reshape(b, microbatches) if microbatches > 1 else b

    data = prefetch(itertools.islice(sharded_batches(make_batch, shard_id=0), LM_TRAIN_STEPS + LM_TRAIN_PROFILED))
    state, history = train(lm_loss_fn(cfg), params, data, tc=tc, n_steps=LM_TRAIN_STEPS, log_fn=lambda _: None)
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    if len(losses) != LM_TRAIN_STEPS or not all(np.isfinite(losses + norms)):
        raise AssertionError(f"{arch}: a loss or grad_norm is not finite: {losses} {norms}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall: {losses}")
    step_s = float(np.median([1.0 / h["steps_per_s"] for h in history[2:]]))
    flops = lm_train_flops(cfg, batch, LM_TRAIN_SEQ)
    out.update({"loss": losses, "grad_norm_first_last": [norms[0], norms[-1]],
                "s_per_step_median_from_3": step_s, "s_per_step_first": 1.0 / history[0]["steps_per_s"],
                "tokens_per_s": batch * LM_TRAIN_SEQ / step_s, "model_tflops_per_s": flops / step_s / 1e12,
                "share_of_bf16_peak": flops / step_s / BF16_TENSOR_OPS_PER_S,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    if state.params is not params:
        raise AssertionError(f"{arch}: train(donate=True) did not train the caller's parameters")

    # where a step's time goes: a profiler window over 2 more donated steps
    step = lm_train_step(cfg, tc, donate=True)
    tree = [state.tree()]

    def one_step():
        tree[0], _ = step(tree[0], next(data))
        sync(dev)

    t0 = time.perf_counter()
    out["profile_steps"] = device_window(one_step, cpu=False, reps=LM_TRAIN_PROFILED, warm=False)
    out["profile_s"] = time.perf_counter() - t0
    del params, state, tree, data
    gc.collect()
    torch.cuda.empty_cache()
    out["cell_s"] = time.perf_counter() - t_cell
    return out


def lm_training_path(dev, t_start: float) -> None:
    """Phase 14: the LM family trained at full width (``LM_TRAIN_CELLS``),
    then check (b), the train step on the card against the CPU in float32."""
    import torch

    from repro_torch.configs.registry import get_arch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"allocated_gb_at_start": torch.cuda.memory_allocated() / 1e9, "steps": LM_TRAIN_STEPS, "cells": {}}
    for cell in LM_TRAIN_CELLS:
        row = lm_train_cell(dev, *cell)
        emit({"phase": "lm_training_cell", **row})
        out["cells"][row["arch"]] = {k: row[k] for k in ("s_per_step_median_from_3", "tokens_per_s",
                                                         "share_of_bf16_peak", "peak_memory_gb")}
    t0 = time.perf_counter()
    card_cpu = {}
    for arch in LM_ARCHS:
        card_cpu[arch] = lm_train_card_vs_cpu(dev, get_arch(arch).make_reduced, arch, 2, 16)

    def dropping():
        cfg = get_arch("moonshot-v1-16b-a3b").make_reduced()
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))

    card_cpu["moonshot-v1-16b-a3b@cf1"] = lm_train_card_vs_cpu(dev, dropping, "moonshot@cf1", 2, 16)
    llama2 = lambda: dataclasses.replace(get_arch("llama3.2-3b").make_full(), n_layers=2, dtype=torch.float32)
    card_cpu["llama3.2-3b@2"] = lm_train_card_vs_cpu(dev, llama2, "llama3.2-3b@2", 1, 64)
    out["card_vs_cpu"] = card_cpu
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    emit({"phase": "lm_training", **out, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})


# ---------------------------------------------------------------------------
# The GNN training path (phase 15)
# ---------------------------------------------------------------------------

GNN_SEED = 0
GNN_ARCHS = ("gatedgcn", "egnn", "nequip", "equiformer-v2")
GNN_CELLS = ("full_graph_sm", "molecule", "minibatch_lg")
GNN_STEPS = 6  # steps per cell, 8 cut to keep the smoke inside its limit (PERF.md §4)
GNN_PROFILED = 1  # steps under the profiler, after the timed ones (2 cut, PERF.md §4)
#: minibatch_lg's seeds per step where 1,024 does not fit one card (PERF.md §4)
GNN_SEEDS = {"equiformer-v2": 128}
GNN_FANOUTS = [15, 10]  # minibatch_lg's fanout (src/repro/configs/registry.py:43-46)
GNN_GRAPH_NODES = 232_965  # Reddit's node count; the reference names no source graph
GNN_AVG_DEGREE = 50  # cut from Reddit's ~492 (PERF.md §4)
#: EGNN's positions in its cells, as a share of the others' (PERF.md §4):
#: its coordinate update has no cutoff and reads the squared edge length
#: raw, and at ``random_graph_batch``'s N(0, 2²) the reference's EGNN at
#: full depth diverges (float32 grad norm inf; ``egnn_reference_geometry``
#: records it each run). At N(0, 0.1²) a typical squared edge length is 0.06.
GNN_EGNN_POSITION_SCALE = 0.05
#: card against CPU, float32, TF32 off, one ``gnn_train_step`` with
#: ``AdamWConfig()``: the loss, grad_norm and every parameter and moment
#: leaf within this share of the tensor's largest magnitude (a parameter
#: within 2·lr more: a first AdamW step moves an element whose gradient is
#: float noise by lr either way). Not 1e-4: GatedGCN's ReLUs take the other
#: branch where float32 noise flips a pre-activation's sign, and the CPU's
#: own float32 step on the full-width GatedGCN reads up to 1.8e-4 off a
#: float64 step in 8 draws (3e-7–1e-6 where none flips; PERF.md §6)
GNN_TRAIN_CARD_RTOL = 1e-3
#: leaves whose gradient is float noise, held against the largest magnitude
#: of their tree instead of their own: Equiformer's last attention bias adds
#: a constant to every score of a head, which the softmax cancels
GNN_NOISE_LEAVES = ("['layers']/['attn']/['b1']",)


def gnn_train_opt():
    """The cells' AdamW: ``AdamWConfig()``, the reference bundle's own (lr
    3e-4 reached over 100 warm-up steps). At lr 3e-4 after 2 warm-up steps
    (phase 14's) NequIP's one-target ``full_graph_sm`` regression
    overshoots and its loss did not fall in 8 steps (PERF.md §6)."""
    from repro_torch.train.optimizer import AdamWConfig

    return AdamWConfig()


def gnn_minibatches(dev, batch_nodes: int, n: int) -> dict:
    """``n`` successive ``minibatch_stream`` batches of ``batch_nodes`` seeds
    (fanout 15-10) over ``random_csr_graph(0, 232,965 nodes, avg degree
    50)``, with seeded float32 features of width 602 on the card, node
    classes (as many as the full GatedGCN's) and positions: the sampled
    subgraphs (their features gathered from the card's table as each is
    used, so one batch's are alive at a time) and what drawing them
    took."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.sampler import minibatch_stream
    from repro_torch.data.synthetic import random_csr_graph

    t0 = time.perf_counter()
    indptr, indices = random_csr_graph(GNN_SEED, n_nodes=GNN_GRAPH_NODES, avg_degree=GNN_AVG_DEGREE)
    rng = np.random.default_rng(GNN_SEED)
    labels = rng.integers(0, get_arch("gatedgcn").make_full().n_classes, GNN_GRAPH_NODES)
    positions = (rng.normal(size=(GNN_GRAPH_NODES, 3)) * 2.0).astype(np.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(GNN_SEED)
    features = torch.randn((GNN_GRAPH_NODES, 602), generator=gen, device=dev)
    graph_s = time.perf_counter() - t0
    stream = minibatch_stream(indptr, indices, np.arange(GNN_GRAPH_NODES), labels, batch_nodes=batch_nodes,
                              fanouts=GNN_FANOUTS, seed=GNN_SEED)  # "features": the node ids, gathered at use
    t0 = time.perf_counter()
    subs = [next(stream) for _ in range(n)]
    return {"subs": subs, "features": features, "labels": labels, "positions": positions, "graph_s": graph_s,
            "sample_s_per_batch": (time.perf_counter() - t0) / n,
            "sampled_edges": [int(s["edge_mask"].sum()) for s in subs]}


def gnn_cell(dev, arch: str, shape_name: str, sampled: dict | None) -> dict:
    """One arch at its full config trained by ``train`` (the donated step)
    for ``GNN_STEPS`` steps on one cell, then a profiler window over
    ``GNN_PROFILED`` more. The synthetic cells train on one batch drawn
    from a seeded generator and padded as the bundle pads; minibatch_lg on
    successive sampled subgraphs (``sampled``). The loss must fall and stay
    finite."""
    t_cell = time.perf_counter()
    import torch

    from repro_torch.configs.registry import GNN_SHAPES, get_arch
    from repro_torch.launch import steps as st
    from repro_torch.train.train_loop import TrainConfig, train
    from repro_torch.utils import sync, tree_bytes

    shape = next(s for s in GNN_SHAPES if s.name == shape_name)
    cfg = st.gnn_adapt_config(get_arch(arch).make_full(), shape)
    tc = TrainConfig(opt=gnn_train_opt(), log_every=1, checkpoint_every=GNN_STEPS + 1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(GNN_SEED)
    t0 = time.perf_counter()
    scale = GNN_EGNN_POSITION_SCALE if arch == "egnn" else 1.0
    if sampled is None:
        one = st.gnn_batch(cfg, shape, gen, device=dev)
        if one["graph"].positions is not None:
            one["graph"] = one["graph"]._replace(positions=one["graph"].positions * scale)
        batches = [one] * (GNN_STEPS + GNN_PROFILED)
        n_edges = shape.dims["n_edges"]
    else:
        table, pos = sampled["features"], sampled["positions"] * scale
        batches = (st.gnn_minibatch(cfg, {**s, "features": table.index_select(0, torch.from_numpy(s["features"]).to(dev))},
                                    node_labels=sampled["labels"], positions=pos, device=dev) for s in sampled["subs"])
        n_edges = len(sampled["subs"][0]["senders"])  # seeds · (15 + 150), the sampler's E_max
    params = st.gnn_init(cfg, gen, device=dev)
    sync(dev)
    out = {"arch": arch, "cell": shape_name, "config": dataclasses.asdict(cfg), "position_scale": scale,
           "edges": n_edges, "setup_s": time.perf_counter() - t0, "params_mb": tree_bytes(params) / 1e6}
    seen = []

    def record(batches):  # the padded sizes and the valid edges of each batch the cell trains on
        for b in batches:
            seen.append((int(b["graph"].nodes.shape[0]), int(b["graph"].senders.shape[0]),
                         int(b["graph"].edge_mask.sum())))
            yield b

    data = record(batches)
    state, history = train(st.gnn_loss_fn(cfg), params, data, tc=tc, n_steps=GNN_STEPS, log_fn=lambda _: None)
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    if len(losses) != GNN_STEPS or not all(np.isfinite(losses + norms)):
        raise AssertionError(f"{arch} at {shape_name}: a loss or grad_norm is not finite: {losses} {norms}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"{arch} at {shape_name}: the loss did not fall: {losses}")
    step_s = float(np.median([1.0 / h["steps_per_s"] for h in history[2:]]))
    flops = st.gnn_train_flops(cfg, n_edges)
    out.update({"nodes_padded": seen[0][0], "edges_padded": seen[0][1], "valid_edges": [v for *_, v in seen],
                "loss": losses, "grad_norm_first_last": [norms[0], norms[-1]],
                "s_per_step_median_from_3": step_s, "s_per_step_first": 1.0 / history[0]["steps_per_s"],
                "edges_per_s": n_edges / step_s, "model_tflops_per_s": flops / step_s / 1e12,
                "share_of_fp32_peak": flops / step_s / CUDA_CORE_OPS_PER_S,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    step = st.gnn_train_step(cfg, tc, donate=True)
    tree = [state.tree()]

    def one_step():
        tree[0], _ = step(tree[0], next(data))
        sync(dev)

    window = device_window(one_step, cpu=False, reps=GNN_PROFILED, warm=False)
    if "device_ops" in window:
        window["launches_per_step"] = window["device_ops"] / GNN_PROFILED
    out["profile_2_steps"] = window
    del params, state, tree, data, batches
    gc.collect()
    torch.cuda.empty_cache()
    out["cell_s"] = time.perf_counter() - t_cell
    return out


def egnn_reference_geometry(dev) -> dict:
    """EGNN at its full config on the ``molecule`` batch at
    ``random_graph_batch``'s own positions, N(0, 2²): the energy, the
    positions after the last layer, the loss and grad_norm of one
    ``value_and_grad`` (float32; the reference gives the same divergence,
    PERF.md §4). Recorded, not checked."""
    import torch

    from repro_torch.configs.registry import GNN_SHAPES, get_arch
    from repro_torch.launch import steps as st
    from repro_torch.models.gnn.egnn import egnn_forward
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.utils import tree_global_norm

    shape = next(s for s in GNN_SHAPES if s.name == "molecule")
    cfg = st.gnn_adapt_config(get_arch("egnn").make_full(), shape)
    gen = torch.Generator(device=dev)
    gen.manual_seed(GNN_SEED)
    batch = st.gnn_batch(cfg, shape, gen, device=dev)
    params = st.gnn_init(cfg, gen, device=dev)
    with torch.no_grad():
        energy, pos = egnn_forward(params, batch["graph"], cfg)
    loss, _, grads = value_and_grad(st.gnn_loss_fn(cfg), params, batch)
    return {"energy_abs_max": float(energy.abs().max()), "positions_abs_max": float(pos.abs().max()),
            "loss": float(loss), "grad_norm": float(tree_global_norm(grads))}


def gnn_train_card_vs_cpu(dev, arch: str, *, full: bool = False, depth=None) -> dict:
    """Check (b): one float32 ``gnn_train_step`` (``AdamWConfig()``, the
    functional step) from one set of weights and one ``molecule`` batch on
    the card and the CPU. Each compared tensor's largest difference over
    its bound (``GNN_TRAIN_CARD_RTOL`` of its largest magnitude, plus 2·lr
    for a parameter; ``GNN_NOISE_LEAVES`` of their tree's largest) must
    stay within 1. The card's step again with TF32 on is printed beside it
    as the control."""
    import torch

    from repro_torch.configs.registry import GNN_SHAPES, get_arch
    from repro_torch.launch import steps as st
    from repro_torch.train.train_loop import init_train_state
    from repro_torch.utils import tree_map, tree_paths

    t_check = time.perf_counter()
    shape = next(s for s in GNN_SHAPES if s.name == "molecule")
    a = get_arch(arch)
    cfg = st.gnn_adapt_config(a.make_full() if full else a.make_reduced(), shape)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    gen = torch.Generator()
    gen.manual_seed(GNN_SEED)
    batch = st.gnn_batch(cfg, shape, gen, device="cpu")
    params = st.gnn_init(cfg, gen, device="cpu")
    step = st.gnn_train_step(cfg)

    def run(d) -> dict:
        p = params if d.type == "cpu" else tree_map(lambda t: t.to(d), params)
        b = {"graph": batch["graph"].to(d), "labels": batch["labels"].to(d)}
        tree, metrics = step(init_train_state(p, st.TrainConfig()).tree(), b)
        opt = tree["opt_state"]
        return {"metrics": {k: float(v) for k, v in metrics.items()}, **{k: dict(tree_paths(t)) for k, t in (
            ("params", tree["params"]), ("mu", opt.mu), ("nu", opt.nu))}}

    def ratios(got: dict, want: dict) -> dict:
        return gnn_state_ratios(got, want, steps=1)

    t0 = time.perf_counter()
    want = run(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    sound = ratios(run(dev), want)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = ratios(run(dev), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    label = f"{arch}{'' if not full else ' full width'}{'' if depth is None else f' depth {depth}'}"
    if not all(np.isfinite(v) and v <= 1.0 for v in sound.values()):
        raise AssertionError(f"gnn train step card vs CPU ({label}): difference over bound {sound}")
    return {"config": dataclasses.asdict(cfg), "difference_over_bound": sound, "rtol": GNN_TRAIN_CARD_RTOL,
            "tf32_control_difference_over_bound": control,
            "tf32_control_exceeds_bound": max(control.values()) > 1.0, "loss": want["metrics"]["loss"],
            "cpu_step_s": cpu_s, "s": time.perf_counter() - t_check}


def gnn_example_path(dev) -> tuple[dict, dict]:
    """Check (c): ``examples/torch_gnn_graph_build.py``'s path on the card
    (4,000 atoms, 48-d descriptors, k 8: the HNSW-Flash build and search,
    exact kNN, EGNN on the kNN graph) with its own launch counts. Edge
    agreement with exact kNN must reach half a scan of the same codes
    (``code_scan_recall`` keeping ef = 64), and EGNN's energy must be
    finite and equal the CPU path's on the same graph and weights within
    ``GNN_TRAIN_CARD_RTOL``. Returns (the check's numbers, its launches)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.testing.scan import code_scan_recall
    from repro_torch.utils import tree_map

    example = load_example("torch_gnn_graph_build")
    t0 = time.perf_counter()
    ops.reset_launches()
    res = example.knn_graph_energy(4000, device=dev)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    path_s = time.perf_counter() - t0
    for name in ("flash_round", "l2_batch"):
        if launches[name] == 0:
            raise AssertionError(f"the GNN example path never launched {name}")
    index, desc = res["index"], res["desc"]
    scan = code_scan_recall(index.backend, index.data, desc, res["exact_ids"], 64)
    scan_gate("the GNN example's kNN graph (edge agreement)", res["overlap"], scan)
    energy = res["energy"]
    with torch.no_grad():
        cpu_energy, _ = example.egnn_forward(tree_map(lambda t: t.cpu(), res["params"]), res["graph"].to("cpu"),
                                             example.EGNN_CFG)
    diff = float((energy.cpu().double() - cpu_energy.double()).abs().max())
    bound = GNN_TRAIN_CARD_RTOL * float(cpu_energy.abs().max())
    if not bool(torch.isfinite(energy).all()) or tuple(energy.shape) != (1, 1) or not diff <= bound:
        raise AssertionError(f"the GNN example's energy {energy.tolist()} against the CPU's {cpu_energy.tolist()}")
    return ({"atoms": 4000, "k": 8, "path_s": path_s, "ann_s": res["ann_s"], "edge_agreement": res["overlap"],
             "code_scan_64_recall": scan, "energy": float(energy[0, 0]), "energy_cpu": float(cpu_energy[0, 0]),
             "energy_diff": diff, "energy_bound": bound, "launches": launches}, launches)


def gnn_training_path(dev, t_start: float) -> dict:
    """Phase 15: the GNN family trained at full width on the three cells
    that fit one card, (b) the train step card against CPU in float32 and
    (c) the example's kNN graph feeding EGNN. Returns (c)'s launches."""
    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"allocated_gb_at_start": torch.cuda.memory_allocated() / 1e9, "steps": GNN_STEPS, "cells": {}}
    from repro_torch.configs.registry import GNN_SHAPES

    full_seeds = next(s for s in GNN_SHAPES if s.name == "minibatch_lg").dims["batch_nodes"]
    seeds = {arch: GNN_SEEDS.get(arch, full_seeds) for arch in GNN_ARCHS}
    sampled = {b: gnn_minibatches(dev, b, GNN_STEPS + GNN_PROFILED) for b in sorted(set(seeds.values()))}
    out["sampling"] = {b: {k: v for k, v in s.items() if k in ("graph_s", "sample_s_per_batch", "sampled_edges")}
                       for b, s in sampled.items()}
    for arch in GNN_ARCHS:
        for cell in GNN_CELLS:
            row = gnn_cell(dev, arch, cell, sampled[seeds[arch]] if cell == "minibatch_lg" else None)
            if cell == "minibatch_lg":
                row["seeds"] = seeds[arch]
            emit({"phase": "gnn_training_cell", **row})
            out["cells"][f"{arch}@{cell}"] = {k: row[k] for k in ("s_per_step_median_from_3", "edges_per_s",
                                                                   "share_of_fp32_peak", "peak_memory_gb")}
    del sampled
    t0 = time.perf_counter()
    card_cpu = {arch: gnn_train_card_vs_cpu(dev, arch) for arch in GNN_ARCHS}
    card_cpu["gatedgcn@full"] = gnn_train_card_vs_cpu(dev, "gatedgcn", full=True)
    card_cpu["equiformer-v2@full,depth2"] = gnn_train_card_vs_cpu(dev, "equiformer-v2", full=True, depth=2)
    out["card_vs_cpu"] = card_cpu
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    out["egnn_at_reference_geometry"] = egnn_reference_geometry(dev)
    out["example"], launches = gnn_example_path(dev)
    emit({"phase": "gnn_training", **out, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})
    return launches


def check_repaired_limits(dev, g) -> dict:
    """Phase 2's shapes that raised before the limits were repaired, each
    held bit for bit against its plain version: an (M, K) = (64, 256) int32
    table (64 KiB, above the 48 KB a kernel gets without the shared-memory
    opt-in) through the four table kernels, and ``flash_beam`` at W = 16,
    R = 96 (W·R = 1,536 slots on 1,024 threads) against its plain version
    and the loop of ``flash_expand`` launches."""
    import torch

    from repro_torch.kernels import ops, ref

    def ints(shape, hi, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device=dev, dtype=dtype)

    def same(name, got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"{name}: differs from its plain version at a repaired limit")

    m, k, b = 64, 256, 1024
    adts = ints((b, m, k), 256)
    codes = ints((b, 128, m), k)
    same("flash_round (64 KiB table)", ops.flash_round(codes, adts), ref.flash_round(codes, adts))
    flat = codes.reshape(-1, m)
    same("flash_scan (64 KiB table)", ops.flash_scan(flat, adts[0]), ref.flash_scan(flat, adts[0]))
    blocks = codes.reshape(b, 4, 32, m).transpose(-1, -2).contiguous()
    same("flash_scan_blocked (64 KiB table)", ops.flash_scan_blocked(blocks, adts),
         ref.flash_scan_blocked(blocks, adts))
    n, r = 20000, 32
    mirror = ints((n, r, m), k)
    adj = ints((n, r), n)
    nodes = ints((b, 4), n)
    rows, sums = ops.flash_expand(nodes, adj, mirror, adts)
    rows_p, sums_p = ref.flash_expand(nodes, adj, mirror, adts)
    same("flash_expand rows (64 KiB table)", rows, rows_p)
    same("flash_expand (64 KiB table)", sums, sums_p)
    bnd, by = bound_ms(codes.numel() * 4 + adts.numel() * 4 + b * 128 * 4, b * 128 * m)
    idx = (codes.long() + torch.arange(m, device=dev) * k
           + (torch.arange(b, device=dev) * m * k)[:, None, None]).reshape(b * 128, m)
    lib = embedding_bag_ms(idx, adts, ops.flash_round(codes, adts))
    del idx
    out = {"table_64k": {"shape_mk": [m, k], "shape": [b, 128, m], "table_bytes": m * k * 4, "bit_equal": True,
                         **lib,
                         "flash_round_ms": time_ms(lambda: ops.flash_round(codes, adts)),
                         "flash_round_device_ms": profiler_kernel_ms(lambda: ops.flash_round(codes, adts),
                                                                     "flash_round_kernel"),
                         "flash_round_plain_ms": time_ms(lambda: ref.flash_round(codes, adts), reps=3, inner=2),
                         "bound_ms": bnd, "bound_by": by}}
    del codes, flat, blocks, mirror

    # flash_beam, W = 16 rows of R = 96 slots, over a random 200k-vertex graph
    out["flash_beam_w16_r96"] = beam_bit_equal(ints, n=200_000, r=96, w=16, q=1000, efs=(64, 256))
    return out


def beam_bit_equal(ints, *, n: int, r: int, w: int, q: int, efs, empty: float = 0.0) -> dict:
    """``flash_beam`` over a random n-vertex graph of degree ``r`` (a share
    ``empty`` of its slots −1, as a flat graph's rows hold) with an M = 16,
    4-bit code per vertex, ``q`` queries from one random entry each, beam
    width ``w``: at each ef of ``efs`` held bit for bit (dists, ids, n_dists,
    n_hops) against its plain version and the loop of ``flash_expand``
    launches, and timed."""
    import torch

    from repro_torch.core import flash as fl
    from repro_torch.kernels import ops, ref

    m, k = 16, 16
    codes = ints((n, m), k)
    adj = ints((n, r), n)
    if empty:
        adj[ints((n, r), 1 << 20) < int(empty * (1 << 20))] = -1
    mirror = fl.pack_codes(codes[adj.clamp_min(0).long()])
    out = {}
    for ef in efs:
        adt = ints((q, m, k), 256)
        entries = ints((q, 1), n)
        d_e = fl.adc_lookup(adt, codes[entries.long()]).to(torch.float32)
        beam = ref.initial_beam(entries, d_e, ef)
        max_iters = -(-(4 * ef + 8) // w)
        args = (adt, adj, mirror, *beam, entries)
        got = ops.flash_beam(*args, width=w, max_iters=max_iters)

        def step(nodes, adt=adt):
            rows, sums = ops.flash_expand(nodes, adj, mirror, adt)
            return rows, sums.to(torch.float32)

        loop = ref.beam_loop(step, *beam, entries, n, width=w, max_iters=max_iters)
        plain = ref.flash_beam(*args, width=w, max_iters=max_iters)
        for against, want in (("the flash_expand step loop", loop), ("its plain version", plain)):
            for x, y, name in zip(got, want, ("dists", "ids", "n_dists", "n_hops")):
                if not torch.equal(x.cpu(), y.cpu()):
                    raise AssertionError(f"flash_beam W={w} R={r} ef={ef} Q={q}: {name} differs from {against}")
        hops = int(got[3].sum())
        # the bytes the search needs, as check_flash_beam counts them
        nbytes = adt.numel() * 4 + hops * r * (4 + m // 2) + q * ef * 17 + q * 16 + entries.numel() * 4
        bnd, by = bound_ms(nbytes, hops * r * m)
        out[f"ef{ef}"] = {
            "queries": q, "n": n, "empty_slots": empty, "bit_equal": True, "n_dists": int(got[2].sum()),
            "n_hops": hops,
            "ms": time_ms(lambda: ops.flash_beam(*args, width=w, max_iters=max_iters), reps=3, inner=1),
            "device_ms": profiler_kernel_ms(lambda: ops.flash_beam(*args, width=w, max_iters=max_iters),
                                            "flash_beam_kernel", reps=3),
            "bound_ms": bnd, "bound_by": by}
    torch.cuda.synchronize()
    return out


def check_flat_shapes(dev, g) -> dict:
    """Phase 2's flat-graph shapes (the ``generality`` phase's parameters:
    r_base = 24, W = 4, ef 64 to build, 128 to search), held bit for bit
    against the plain versions: ``flash_round`` at every C a flat bulk
    round scores (S = 32 random, P = 2R = 48 pool, P + E² = 112 refine)
    over a full 16,384-row block and a remainder of 8,616 rows (25,000 rows
    in blocks), and ``flash_beam`` at W = 4, R = 24 over a random
    ``N_BASE``-vertex graph with a quarter of its slots empty: 1,000 queries
    at ef 128 (the search) and 32 at ef 64 (an insert batch)."""
    import torch

    from repro_torch.graph import engine
    from repro_torch.kernels import ops, ref

    def ints(shape, hi, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device=dev, dtype=dtype)

    m, k = 16, 16
    out = {"flash_round": {}}
    for b in (engine._BULK_CHUNK, N_BASE % engine._BULK_CHUNK):
        for c in (32, 48, 48 + engine._BULK_EXPAND ** 2):
            codes, adts = ints((b, c, m), k), ints((b, m, k), 256)
            if not torch.equal(ops.flash_round(codes, adts), ref.flash_round(codes, adts)):
                raise AssertionError(f"flash_round at a flat round's (B, C) = ({b}, {c}): differs from plain")
            out["flash_round"][f"b{b}_c{c}"] = "bit_equal"
    del codes, adts
    out["flash_beam_w4_r24_search"] = beam_bit_equal(ints, n=N_BASE, r=24, w=4, q=1000, efs=(128,), empty=0.25)
    out["flash_beam_w4_r24_insert_batch"] = beam_bit_equal(ints, n=N_BASE, r=24, w=4, q=32, efs=(64,), empty=0.25)
    return out


# Builds over integer data with hand-made coders (repro_torch.testing.exact):
# every distance an exact float32 integer, so equal on the card and the CPU.
# 2,000 rows cut to 1,000 when the mesh phase came, then to 500 to keep the
# whole smoke near half its limit (PERF.md §4).
EXACT_N, EXACT_D = 500, 32


EXACT_CASES = [(kind, algo, strategy) for kind in ("fp32", "pq", "sq", "pca")
               for algo in ("hnsw", "vamana", "nsg") for strategy in ("bulk", "incremental")]


def exact_builds(device: str, src: str) -> dict:
    """Every case of :data:`EXACT_CASES` built on ``device`` over the
    integer rows: {case: (export_state arrays, n_dists, seconds)}. Module
    level with ``src`` passed in: the CPU side runs in a spawned process."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import AnnIndex
    from repro_torch.testing.exact import exact_backends

    if device == "cpu":  # half the cores: the card's side runs beside it
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    x = torch.from_numpy(np.random.default_rng(5).integers(-8, 9, (EXACT_N, EXACT_D)).astype(np.float32))
    backends = exact_backends(x, device)
    out = {}
    for kind, algo, strategy in EXACT_CASES:
        # batch 128: 16 insert batches a pass (the smoke's time limit)
        params = BuildParams(r_upper=8, r_base=16, ef=32, batch=128, max_layers=2,
                             alpha=1.2 if algo == "vamana" else 1.0)
        t0 = time.perf_counter()
        idx = AnnIndex.build(x, algo=algo, backend=backends[kind], params=params, strategy=strategy,
                             device=device)
        out[f"{kind}/{algo}/{strategy}"] = (idx.export_state()[1], idx.last_stats.n_dists,
                                            time.perf_counter() - t0)
    return out


#: the flat Flash builds phase 5 holds card against CPU: (algo, strategy,
#: rows, algorithm options), at the ``generality`` phase's parameters
FLAT_FLASH_CASES = (("vamana", "bulk", 5000, {}), ("nsg", "bulk", 5000, dict(knn_k=24)),
                    ("vamana", "incremental", 1000, {}), ("nsg", "incremental", 1000, dict(knn_k=24)))
FLAT_PARAMS = dict(r_upper=8, r_base=24, ef=64, batch=32, max_layers=3, width=4, alpha=1.2)


def flat_flash_builds(device: str, src: str, rows, queries, states: dict, knns: dict) -> dict:
    """Every case of :data:`FLAT_FLASH_CASES` built on ``device`` over the
    case's first n rows of ``rows`` (numpy) from the coder ``states[n]`` (a
    ``flash_blocked`` state dict), and searched with ``queries`` at ef 128,
    W = 4: {case: (export_state arrays, n_dists, [(ids, Flash distances)
    without rerank, (ids, distances) with the exact rerank], query-table
    levels, seconds)}. The incremental NSG starts from the k-NN graph
    ``knns[n]``, the same on both devices. Module level with ``src``
    passed in: the CPU side runs in a spawned process."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    from repro_torch.graph.backends import FlashBlockedBackend
    from repro_torch.graph.engine import BuildParams
    from repro_torch.graph.nsg import build_nsg_stats
    from repro_torch.index import AnnIndex

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    params = BuildParams(**FLAT_PARAMS)
    q = torch.from_numpy(queries).to(device)
    out = {}
    for algo, strategy, n, kw in FLAT_FLASH_CASES:
        x = torch.from_numpy(rows[:n]).to(device)
        be = FlashBlockedBackend.from_state(states[n], device=device)
        t0 = time.perf_counter()
        if (algo, strategy) == ("nsg", "incremental"):
            graph, _, st = build_nsg_stats(x, be, params=params, strategy=strategy,
                                           knn_adj=torch.from_numpy(knns[n]), **kw)
            idx = AnnIndex.from_graph(graph, x, algo=algo, params=params, backend_kind="flash_blocked", stats=st,
                                      strategy=strategy, device=device)
        else:
            idx = AnnIndex.build(x, algo=algo, backend=be, params=params, strategy=strategy, device=device, **kw)
        res = [idx.search(q, k=10, ef=128, width=4, rerank=rr) for rr in (False, True)]
        out[f"{algo}/{strategy}/{n}"] = (idx.export_state()[1], idx.last_stats.n_dists,
                                         [(r.ids.cpu().numpy(), r.dists.cpu().numpy()) for r in res],
                                         be.prepare_query(x).adt_q.cpu().numpy(), time.perf_counter() - t0)
    return out


def card_against_cpu_builds(dev, data) -> dict:
    """Phase 5's build checks, each built on the card and, at the same
    time in a spawned process, on the CPU:

    * every algorithm (HNSW, Vamana, NSG), bulk and incremental, over every
      baseline backend with hand-made coders on 500 integer rows in
      [−8, 8] at D = 32: the graphs, their distances, the entry and n_dists
      must be equal;
    * flat Vamana and NSG over ``flash_blocked`` (:data:`FLAT_FLASH_CASES`,
      the generality phase's r_base = 24 and W = 4) on the first rows of
      ``data``, from one coder fitted on the card (the incremental NSG
      from one k-NN graph, the CPU's; the card's own is held to it up to
      near ties): Flash distances are
      integer sums, so where the two devices' query tables agree the
      graphs, n_dists and a 200-query search at ef 128 must be equal (ids
      and Flash distances); with the exact rerank the float32 distances
      sum in another order, so they must be allclose at rtol 1e-5 and the
      ids, which may swap at a near tie, are reported. Where the tables
      disagree, 99% of the adjacency rows must be equal, as in the HNSW
      check above."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.graph import backends as bk
    from repro_torch.index import exact_knn

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    rows = data[:max(c[2] for c in FLAT_FLASH_CASES)].cpu().numpy()
    queries = (data[-200:].cpu().numpy() + 0.5).astype(np.float32)
    states = {}
    for n in sorted({c[2] for c in FLAT_FLASH_CASES}):
        be = bk.make_backend("flash_blocked", data[:n], seed=0, r_for_blocked=FLAT_PARAMS["r_base"], device=dev,
                             d_f=64, m_f=16, l_f=4, h=8, kmeans_iters=8)
        states[n] = {key: v.cpu() if hasattr(v, "cpu") else v for key, v in be.state_dict().items()}
    # The incremental NSG's k-NN graph: l2_batch on the card may order a
    # near tie otherwise than the CPU's plain product, and one swapped
    # neighbour changes the graph. Both builds start from the CPU's; the
    # card's is held to it up to near ties (knn_cross_check).
    knns, knn_check = {}, {}
    for _, strategy, n, kw in FLAT_FLASH_CASES:
        if "knn_k" in kw and strategy == "incremental":
            k = kw["knn_k"] + 1
            cpu_ids = exact_knn(data[:n].cpu(), data[:n].cpu(), k=k)[0]
            card_ids, card_d = exact_knn(data[:n], data[:n], k=k)
            knns[n] = cpu_ids[:, 1:].numpy()
            knn_check[n] = dict(knn_cross_check(card_ids, card_d, data[:n], data[:n], k=k),
                                rows_differ_from_cpu=int((card_ids.cpu() != cpu_ids).any(1).sum()))
    with ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn")) as ex:
        cpu_exact = ex.submit(exact_builds, "cpu", src)
        cpu_flat = ex.submit(flat_flash_builds, "cpu", src, rows, queries, states, knns)
        card = exact_builds(str(dev), src)
        card_flat = flat_flash_builds(str(dev), src, rows, queries, states, knns)
        cpu = cpu_exact.result()
        cpu_flat = cpu_flat.result()
    out = {}
    for case, (arrays, nd, secs) in card.items():
        cpu_arrays, cpu_nd, cpu_secs = cpu[case]
        for key, arr in cpu_arrays.items():
            if not np.array_equal(arrays[key], arr):
                raise AssertionError(f"{case}: the card's {key} differs from the CPU's")
        if nd != cpu_nd:
            raise AssertionError(f"{case}: n_dists {nd} on the card, {cpu_nd} on the CPU")
        out[case] = {"n_dists": nd, "card_s": secs, "cpu_s": cpu_secs}
    flat = {}
    for case, (arrays, nd, res, levels, secs) in card_flat.items():
        c_arrays, c_nd, c_res, c_levels, c_secs = cpu_flat[case]
        mismatch = int((levels != c_levels).sum())
        rows_equal = float((arrays["adj"] == c_arrays["adj"]).all(1).mean())
        (ids, d), (rr_ids, rr_d) = res
        (c_ids, c_d), (c_rr_ids, c_rr_d) = c_res
        same = {"graph": all(np.array_equal(arrays[key], arr) for key, arr in c_arrays.items()),
                "n_dists": nd == c_nd, "search_ids": np.array_equal(ids, c_ids),
                "search_flash_dists": np.array_equal(d, c_d),
                "rerank_dists_rtol_1e-5": bool(np.allclose(rr_d, c_rr_d, rtol=1e-5, atol=0.0))}
        flat[case] = {"adt_level_mismatch": mismatch, "adj_rows_equal": rows_equal, "equal": same,
                      "rerank_ids_equal": float((rr_ids == c_rr_ids).mean()),
                      "n_dists": nd, "card_s": secs, "cpu_s": c_secs}
        if mismatch == 0 and not all(same.values()):
            raise AssertionError(f"flat flash_blocked {case}: equal query tables, yet the card differs from the "
                                 f"CPU: {same} ({rows_equal} of adjacency rows equal)")
        if rows_equal < 0.99:
            raise AssertionError(f"flat flash_blocked {case}: only {rows_equal} of adjacency rows equal the CPU's "
                                 f"({mismatch} level mismatches)")
    return {"exact_builds_n": EXACT_N, "exact_builds_card_equals_cpu": out,
            "flat_flash_blocked_card_equals_cpu": flat, "flat_nsg_knn_card_vs_cpu": knn_check}


def index_bytes(index) -> int:
    """Adjacency plus the per-node payload the backend stores, the paper's
    index size, counted as ``benchmarks/bench_indexing.py:38-56`` counts it
    (SQ levels and PQ codes at one byte each)."""
    g, be, kind = index.graph, index.backend, index.backend_kind
    adj = (g.adj0.numel() + g.adj_up.numel()) * 4 if index.layered else g.adj.numel() * 4
    n = index.n
    if kind == "fp32":
        payload = n * index.data.shape[1] * 4
    elif kind == "pca":
        payload = be.z.numel() * 4
    elif kind == "sq":
        payload = be.codes.numel()
    elif kind == "pq":
        payload = be.codes.shape[0] * be.coder.m
    else:
        payload = int(be.codes.shape[0] * be.coder.m_f * np.log2(be.coder.k) / 8)
        if hasattr(be, "nbr_codes"):
            payload += be.nbr_codes.numel() * be.nbr_codes.element_size()
    return int(adj + payload)


def timed_build(data, dev, **kw):
    """``AnnIndex.build`` on the card: (index, wall seconds)."""
    import torch

    from repro_torch.index import AnnIndex

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = AnnIndex.build(data, device=dev, **kw)
    torch.cuda.synchronize()
    return idx, time.perf_counter() - t0


def timed_searches(idx, queries, gt, settings) -> list:
    """QPS and recall@10 of ``idx.search`` for each (ef, width, rerank)."""
    import torch

    rows = []
    for ef, width, rerank in settings:
        idx.search(queries[:32], k=10, ef=ef, width=width, rerank=rerank)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = idx.search(queries, k=10, ef=ef, width=width, rerank=rerank)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(res.dists).all()) or tuple(res.ids.shape) != (queries.shape[0], 10):
            raise AssertionError(f"{idx.algo}/{idx.backend_kind} search ef={ef}: malformed result")
        rows.append({"ef": ef, "width": width, "rerank": rerank, "qps": queries.shape[0] / dt,
                     "seconds": dt, "recall@10": recall_at(res.ids, gt), "n_scan": res.n_scan,
                     "n_rerank": res.n_rerank})
    return rows


#: the baseline backends and their settings (benchmarks/bench_indexing.py:212-215),
#: beside the main path's blocked Flash coder
BASELINES = (("fp32", {}), ("pq", dict(m=16, l_pq=8, kmeans_iters=10)), ("sq", dict(bits=8)),
             ("pca", dict(alpha=0.9)), ("flash_blocked", dict(d_f=64, m_f=16, l_f=4, h=8)))


def baselines_path(dev, base_np, queries, n_rows: int, t_start: float) -> tuple[dict, dict]:
    """Phase ``baselines``: the paper's build-speed comparison. The first
    ``n_rows`` rows, bulk HNSW with ``BuildParams()`` over every backend:
    coder fit and build seconds by phase, n_dists, index bytes, recall@10
    and QPS at ef ∈ {64, 256}, W = 1 with exact rerank (and reconstruct
    rerank at ef = 256 for the coded backends), each build's seconds over
    fp32's. Each coded backend's recall at ef = 256 must reach half that
    of a scan of all its codes keeping 256 (``scan_gate``). The four
    baseline builds must launch no Flash kernel; the Flash build must
    launch ``flash_round`` and ``flash_beam``. Returns the
    path's launches (every build and search) and the ground truth's
    ``l2_batch`` launches."""
    import torch

    from repro_torch.graph.engine import PHASE_NAMES, BuildParams
    from repro_torch.index import exact_knn
    from repro_torch.kernels import ops
    from repro_torch.testing.scan import code_scan_recall

    data = torch.from_numpy(base_np[:n_rows]).to(dev)
    gt_l2 = ops.launches["l2_batch"]
    gt = exact_knn(queries, data, k=10)[0].long()
    gt_l2 = ops.launches["l2_batch"] - gt_l2
    rows = {}
    for kind, kw in BASELINES:
        before = dict(ops.launches)
        idx, wall = timed_build(data, dev, algo="hnsw", backend=kind, strategy="bulk", params=BuildParams(),
                                backend_kwargs=kw)
        built = {key: ops.launches[key] - before[key] for key in ("flash_round", "flash_beam")}
        settings = [(64, 1, True), (256, 1, True)] + ([(256, 1, "reconstruct")] if kind != "fp32" else [])
        st = idx.last_stats
        rows[kind] = {"settings": kw, "build_s": wall, "seconds": st.seconds, "n_dists": st.n_dists,
                      "n_dists_by_phase": dict(zip(PHASE_NAMES, st.phases)),
                      "repair_unreachable": st.repair_unreachable, "index_bytes": index_bytes(idx),
                      "build_launches": built, "search": timed_searches(idx, queries, gt, settings)}
        if kind != "fp32":  # fp32's scan is the ground truth itself
            scan = code_scan_recall(idx.backend, idx.data, queries, gt, 256)
            rows[kind]["code_scan_256_recall@10"] = scan
            best = max(r["recall@10"] for r in rows[kind]["search"] if r["ef"] == 256 and r["rerank"] is True)
            scan_gate(f"baselines {kind} at ef=256", best, scan)
        flash = kind.startswith("flash")
        if flash and not (built["flash_round"] and built["flash_beam"]):
            raise AssertionError(f"the {kind} build launched flash_round {built['flash_round']} and "
                                 f"flash_beam {built['flash_beam']} times")
        if not flash and any(built.values()):
            raise AssertionError(f"the {kind} build launched a Flash kernel: {built}")
        del idx
    for row in rows.values():
        row["build_s_over_fp32"] = row["build_s"] / rows["fp32"]["build_s"]
    launches = dict(ops.launches)
    emit({"phase": "baselines", "n": n_rows, "queries": int(queries.shape[0]), "k": 10, "backends": rows,
          "ground_truth_l2_batch_launches": gt_l2, "launches": launches,
          "elapsed_s": time.perf_counter() - t_start})
    return launches, gt_l2


def generality_path(dev, base_np, queries, n_rows: int, t_start: float) -> dict:
    """Phase ``generality`` (``benchmarks/bench_generality.py:24-26`` over
    ``benchmarks/common.py:36-38``): Vamana and NSG (``knn_k`` = 24), bulk,
    over fp32 and ``flash_blocked`` on the first ``n_rows`` rows: build
    seconds, n_dists, recall@10 and QPS at ef = 128, W = 4, exact rerank,
    held to half the recall of a scan of the codes keeping 128
    (``scan_gate``). Every ``flash_blocked`` build and search must launch ``flash_beam``,
    every flat bulk Flash build ``flash_round``. Returns the path's
    launches."""
    import torch

    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import exact_knn
    from repro_torch.kernels import ops
    from repro_torch.testing.scan import code_scan_recall

    data = torch.from_numpy(base_np[:n_rows]).to(dev)
    gt = exact_knn(queries, data, k=10)[0].long()
    params = BuildParams(r_upper=8, r_base=24, ef=64, batch=32, max_layers=3, width=4, alpha=1.2)
    rows = {}
    for algo, akw in (("vamana", {}), ("nsg", dict(knn_k=24))):
        for kind, kw in (("fp32", {}), ("flash_blocked", dict(d_f=64, m_f=16, l_f=4, h=8))):
            before = dict(ops.launches)
            idx, wall = timed_build(data, dev, algo=algo, backend=kind, strategy="bulk", params=params,
                                    backend_kwargs=kw, **akw)
            built = {key: ops.launches[key] - before[key] for key in ("flash_round", "flash_beam")}
            mid = dict(ops.launches)
            search = timed_searches(idx, queries, gt, [(128, 4, True)])
            searched = ops.launches["flash_beam"] - mid["flash_beam"]
            st = idx.last_stats
            rows[f"{algo}/{kind}"] = {"build_s": wall, "seconds": st.seconds, "n_dists": st.n_dists,
                                      "repair_unreachable": st.repair_unreachable,
                                      "index_bytes": index_bytes(idx), "build_launches": built,
                                      "search_flash_beam_launches": searched, "search": search}
            if kind != "fp32":
                scan = code_scan_recall(idx.backend, idx.data, queries, gt, 128)
                rows[f"{algo}/{kind}"]["code_scan_128_recall@10"] = scan
                scan_gate(f"generality {algo}/{kind} at ef=128", search[0]["recall@10"], scan)
            if kind == "flash_blocked" and not (built["flash_round"] and built["flash_beam"] and searched):
                raise AssertionError(f"{algo}/{kind}: build launches {built}, search flash_beam {searched}")
            if kind == "fp32" and (any(built.values()) or searched):
                raise AssertionError(f"{algo}/fp32 launched a Flash kernel")
            del idx
        rows[f"{algo}/build_s_fp32_over_flash_blocked"] = (
            rows[f"{algo}/fp32"]["build_s"] / rows[f"{algo}/flash_blocked"]["build_s"])
    launches = dict(ops.launches)
    emit({"phase": "generality", "n": n_rows, "params": dataclasses.asdict(params), "knn_k": 24,
          "results": rows, "launches": launches, "elapsed_s": time.perf_counter() - t_start})
    return launches


# ---------------------------------------------------------------------------
# The paper's own workload (flash-ann), the recsys cells and the examples
# ---------------------------------------------------------------------------

ANN_SEGMENTS = 2  # the flash-ann cells' segments on one card
ANN_PARAMS = dict(r_upper=16, r_base=32, ef=128, batch=64, max_layers=3)  # src/repro/launch/dryrun.py:142
ANN_EF = (96, 256)  # examples/distributed_build.py:60, and the wider beam of every Flash path
ANN_ROWS = 20_000  # rows a segment of part (b): the registry's 100,000 cut (PERF.md §4)
ANN_INC = 512  # rows a segment of part (a)'s incremental build (PERF.md §4 gives the cut from 100,000)
ANN_CHECK_ROWS = 512  # part (a)'s card-against-CPU prefix


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are not a package;
    their directory goes on the path, so that the ranks an example spawns
    import it by name too)."""
    import importlib

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
    if folder not in sys.path:
        sys.path.insert(0, folder)
    return importlib.import_module(name)


def check_l2_batch_d768(dev, g) -> dict:
    """Phase 2's ``l2_batch`` row at the flash-ann width: 1,024 queries x
    100,000 rows at D = 768 (24 K-slices a tile, 6x the K loop of D = 128),
    held against ``ref.l2_batch`` (rtol 1e-5, ``l2_atol``), timed by events
    and the profiler beside its 3xTF32 bound. Each query's 10 nearest ids by
    the kernel against those by the plain version: rows that differ are
    counted with the plain margin between the two sets' farthest members
    (a near tie lies within 2·atol). The plan at C = 2 and 64 (routing at
    this width) must take the wide shape: the narrow one's resident y
    cannot hold 24 K-slices."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.utils import topk_first

    nq, nc, d = 1024, 100_000, 768  # flash_ann's ground-truth tile at 2 x 50,000 rows, fixed across its row cuts
    x = torch.randn((nq, d), generator=g, device=dev)
    y = torch.randn((nc, d), generator=g, device=dev)
    plan = ops._l2_plan(nq, nc, d, x.data_ptr(), y.data_ptr(), ops._sm_count(dev))
    narrow = {c: ops._l2_plan(65536, c, d, x.data_ptr(), y.data_ptr(), ops._sm_count(dev)).narrow for c in (2, 64)}
    if any(narrow.values()):
        raise AssertionError(f"l2_batch at D = 768 planned the narrow shape: {narrow}")
    got, want = ops.l2_batch(x, y), ref.l2_batch(x, y)
    atol = l2_atol(x, y)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=atol):
        raise AssertionError(f"l2_batch {nq}x{nc}x{d}: off by {err} (atol {atol})")
    ids_k, ids_p = topk_first(-got, 10)[1], topk_first(-want, 10)[1]
    rows = (ids_k.sort(1).values != ids_p.sort(1).values).any(1)
    margin = (want.gather(1, ids_k).amax(1) - want.gather(1, ids_p).amax(1))[rows]
    del got, want
    near = int((margin <= 2 * atol).sum())
    if int(rows.sum()) > near:
        raise AssertionError(f"l2_batch at D = 768: {int(rows.sum())} top-10 id sets differ, {near} at near ties")
    nbytes = 4 * (nq * d + nc * d + nq * nc)
    bnd, by = bound_ms(nbytes, 3 * 2 * nq * nc * d, TF32_TENSOR_OPS_PER_S)
    bnd_fma, _ = bound_ms(nbytes, 2 * nq * nc * d)
    return dict(shape=[nq, nc, d], max_abs_err=err, atol=atol, plan=plan._asdict(),
                narrow_at_c={str(c): v for c, v in narrow.items()}, top10_rows_differ=int(rows.sum()),
                top10_near_ties=near, top10_max_margin=float(margin.max()) if margin.numel() else 0.0,
                ms=time_ms(lambda: ops.l2_batch(x, y), reps=5, inner=3),
                device_ms=profiler_kernel_ms(lambda: ops.l2_batch(x, y), "l2_batch_kernel", reps=3),
                plain_ms=time_ms(lambda: ref.l2_batch(x, y), reps=3, inner=2),
                bound_ms=bnd, bound_by=by, bound_fp32_fma_ms=bnd_fma,
                library_ms=time_ms(lambda: torch.cdist(x, y, compute_mode="use_mm_for_euclid_dist"), reps=3, inner=2))


def ann_card_vs_cpu(dev, rows, coder, params) -> dict:
    """Part (a)'s check: ``build_segment`` over the first rows of segment 0
    on the card and on the CPU from one coder: codes, adjacency (both
    layers), levels and entry equal wherever the two devices' codes and
    query tables agree, else at least 99% of adjacency rows."""
    import torch

    from repro_torch.core import flash as fl
    from repro_torch.graph import segmented as seg
    from repro_torch.graph.engine import BuildParams, prefix_entries, sample_levels

    n = rows.shape[0]
    levels = sample_levels(0, n, r_upper=params.r_upper, max_layers=params.max_layers)
    entries = prefix_entries(levels, params.batch)
    coder_cpu = fl.FlashCoder(*(t.cpu() for t in coder))
    t0 = time.perf_counter()
    g_card = seg.build_segment(rows, coder, levels, entries, params=BuildParams(**ANN_PARAMS))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_cpu = seg.build_segment(rows.cpu(), coder_cpu, levels, entries, params=BuildParams(**ANN_PARAMS))
    cpu_s = time.perf_counter() - t0
    code_mismatch = int((g_card.backend.codes.cpu() != g_cpu.backend.codes).sum())
    adt_mismatch = int((fl.query_ctx(coder, rows).adt_q.cpu() != fl.query_ctx(coder_cpu, rows.cpu()).adt_q).sum())
    same = {f: torch.equal(getattr(g_card, f).cpu(), getattr(g_cpu, f)) for f in ("adj0", "adj_up", "levels")}
    same["entry"] = g_card.entry == g_cpu.entry
    rows_equal = float((g_card.adj0.cpu() == g_cpu.adj0).all(1).double().mean())
    if code_mismatch == 0 and adt_mismatch == 0 and not all(same.values()):
        raise AssertionError(f"equal codes and query tables, yet the card's segment build differs: {same}")
    if rows_equal < 0.99:
        raise AssertionError(f"only {rows_equal} of adjacency rows equal the CPU's ({code_mismatch} codes, "
                             f"{adt_mismatch} table levels differ)")
    return {"n": n, "card_s": card_s, "cpu_s": cpu_s, "code_mismatch": code_mismatch,
            "adt_level_mismatch": adt_mismatch, "equal": same, "adj0_rows_equal": rows_equal}


def flash_ann_path(dev, ann_inc: int, t_start: float, handover: str) -> tuple[dict, dict]:
    """Phase 16: the registry's ``flash-ann`` workload (D 768; coder d_f 256,
    M 16, 4-bit, H 8; ``segment_build``: 100,000 rows a segment, cut to
    ``ANN_ROWS``;
    ``fanout_search``: 1,024 queries, k 10) on ``vector_dataset(seed=0,
    n=2·ANN_ROWS + 1,024, d=768, n_clusters=64)``, one shared coder from
    ``fit_shared_coder`` over the rows.

    (a) The reference's own single-device programs: ``build_segments_vmapped``
    (the incremental build over the unblocked ``FlashBackend``) over the
    first ``ann_inc`` rows of each of the 2 segments with
    ``ANN_PARAMS``, then ``search_segments_local`` with the segments'
    vectors at ef ∈ {96, 256}: s per insert batch, n_dists by phase,
    recall@10 against ``exact_knn`` over those rows, QPS. Beside it the card
    against the CPU on an ``ANN_CHECK_ROWS``-row prefix (``ann_card_vs_cpu``).
    (b) The cells at full size on the port's main path:
    ``SegmentedAnnIndex.build`` over the two ``ANN_ROWS``-row segments
    (``flash_blocked``, bulk, ``ANN_PARAMS``, each segment's own coder at the
    flash-ann settings), then the fan-out search at ef ∈ {96, 256}, W ∈ {1,
    4}, exact rerank: coder fit and build s by phase, n_dists, index bytes,
    QPS, recall@10 against ``exact_knn`` over the 2·``ANN_ROWS`` rows (``l2_batch``
    at D = 768, cross-checked against a plain loop), a scan of each
    segment's codes keeping 256, the busy share over one search. At ef =
    256 the best recall must reach ½ of the scan's. (a)'s inputs, stacked
    build, search results and QPS go to ``handover/a.pt`` for the mesh
    phase. Returns the launches of (a) and of (b), each read just after its
    path."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import vector_dataset
    from repro_torch.graph import segmented as seg
    from repro_torch.graph.engine import PHASE_NAMES, BuildParams, prefix_entries, sample_levels
    from repro_torch.index import SegmentedAnnIndex, exact_knn
    from repro_torch.kernels import ops
    from repro_torch.utils import sync

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    arch = get_arch("flash-ann")
    cfg = arch.make_full()
    cells = {s.name: s.dims for s in arch.shapes}
    seg_rows, d = min(ANN_ROWS, cells["segment_build"]["segment_size"]), cfg["dim"]
    nq, k = cells["fanout_search"]["n_queries"], cells["fanout_search"]["k"]
    coder_kw = {key: cfg[key] for key in ("d_f", "m_f", "l_f", "h")}
    params = BuildParams(**ANN_PARAMS)
    t0 = time.perf_counter()
    x = vector_dataset(0, n=ANN_SEGMENTS * seg_rows + nq, d=d, n_clusters=64)
    base = torch.from_numpy(x[:ANN_SEGMENTS * seg_rows]).to(dev)
    queries = torch.from_numpy(x[ANN_SEGMENTS * seg_rows:]).to(dev)
    del x
    data_s = time.perf_counter() - t0
    out = {"segments": ANN_SEGMENTS, "segment_rows": seg_rows, "dim": d, "queries": nq, "k": k,
           "coder": coder_kw, "params": ANN_PARAMS, "data_gen_s": data_s}

    # ---- (a) the reference's programs ---------------------------------------
    t0 = time.perf_counter()
    coder = seg.fit_shared_coder(0, base, device=dev, **coder_kw)
    sync(dev)
    out["a_shared_coder_fit_s"] = time.perf_counter() - t0
    out["a_card_vs_cpu"] = ann_card_vs_cpu(dev, base[:ANN_CHECK_ROWS], coder, params)
    segs = base.reshape(ANN_SEGMENTS, seg_rows, d)[:, :ann_inc]
    levels = np.stack([sample_levels(s, ann_inc, r_upper=params.r_upper, max_layers=params.max_layers)
                       for s in range(ANN_SEGMENTS)])
    entries = np.stack([prefix_entries(levels[s], params.batch) for s in range(ANN_SEGMENTS)])
    ops.reset_launches()
    stats = []
    sync(dev)
    t0 = time.perf_counter()
    built = seg.build_segments_vmapped(segs, coder, levels, entries, params=params, stats=stats)
    sync(dev)
    a_build = time.perf_counter() - t0
    batches = ANN_SEGMENTS * (-(-ann_inc // params.batch) - 1)
    insert_s = sum(st.seconds["insert_batches"] for st in stats)
    gt_a = exact_knn(queries, segs.reshape(-1, d), k=k)[0].long()
    a_results = []
    found = {}
    for ef in ANN_EF:
        kw = dict(k=k, ef_search=ef, seg_vectors=segs)
        seg.search_segments_local(built, queries[:32], np.full(ANN_SEGMENTS, ann_inc), **kw)  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        ids, dists = seg.search_segments_local(built, queries, np.full(ANN_SEGMENTS, ann_inc), **kw)
        sync(dev)
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(dists).all()) or tuple(ids.shape) != (nq, k):
            raise AssertionError(f"search_segments_local ef={ef}: malformed result")
        a_results.append({"ef": ef, "qps": nq / dt, "seconds": dt, "recall@10": recall_at(ids, gt_a)})
        found[ef] = (ids.cpu(), dists.cpu())
    sync(dev)
    launches_a = dict(ops.launches)
    ix = built.index
    torch.save({"segs": segs.cpu(), "queries": queries.cpu(), "coder": [t.cpu() for t in coder],
                "levels": levels, "entries": entries, "k": k, "found": found,
                "qps": {r["ef"]: r["qps"] for r in a_results}, "build_s": a_build,
                "built": {f: getattr(ix, f).cpu() for f in ("adj0", "adj0_d", "adj_up", "adj_up_d", "levels", "entry")}
                | {"codes": ix.backend.codes.cpu()}}, os.path.join(handover, "a.pt"))
    out["a"] = {"rows_per_segment": ann_inc, "build_s": a_build, "insert_batches": batches,
                "s_per_insert_batch": insert_s / max(1, batches),
                "bootstrap_s": sum(st.seconds["bootstrap"] for st in stats),
                "n_dists": sum(st.n_dists for st in stats),
                "n_dists_by_phase": {p: sum(st.phases[i] for st in stats) for i, p in enumerate(PHASE_NAMES)},
                "results": a_results, "launches": launches_a}
    del built, segs, stats
    emit({"phase": "flash_ann_reference", **out["a"], "card_vs_cpu": out["a_card_vs_cpu"],
          "shared_coder_fit_s": out["a_shared_coder_fit_s"], "elapsed_s": time.perf_counter() - t_start})

    # ---- (b) the cells at full size on the main path -------------------------
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sync(dev)
    t0 = time.perf_counter()
    coll = SegmentedAnnIndex.build([base[s * seg_rows:(s + 1) * seg_rows] for s in range(ANN_SEGMENTS)],
                                   algo="hnsw", backend="flash_blocked", strategy="bulk", params=params,
                                   backend_kwargs=coder_kw, device=dev)
    sync(dev)
    b_build = time.perf_counter() - t0
    seconds = {}
    for s_ in coll.segments:
        for key, v in s_.last_stats.seconds.items():
            seconds[key] = seconds.get(key, 0.0) + v
    build_launches = dict(ops.launches)
    t0 = time.perf_counter()
    gt_i32, gt_d = exact_knn(queries, base, k=k)
    sync(dev)
    gt_s = time.perf_counter() - t0
    gt = gt_i32.long()
    b_results = []
    for ef in ANN_EF:
        for width in (1, 4):
            before = ops.launches["flash_beam"]
            res, dt = timed_search(coll, queries, k=k, ef=ef, width=width)
            b_results.append({"ef": ef, "width": width, "qps": nq / dt, "seconds": dt,
                              "recall@10": recall_at(res.ids, gt), "n_scan": res.n_scan,
                              "n_rerank": res.n_rerank, "flash_beam_launches": ops.launches["flash_beam"] - before})
    sync(dev)
    launches_b = dict(ops.launches)
    for name in ("flash_round", "flash_beam", "l2_batch"):
        if launches_b[name] == 0:
            raise AssertionError(f"the flash-ann path never launched {name}")
    gt_check = knn_cross_check(gt, gt_d, base, queries)
    window = device_window(lambda: coll.search(queries, k=k, ef=ANN_EF[0], width=1))
    scan = segment_scan_recall(coll, queries, gt, 256)
    best = max(r["recall@10"] for r in b_results if r["ef"] == 256)
    out["b"] = {"build_s": b_build, "seconds": seconds,
                "n_dists": sum(s_.last_stats.n_dists for s_ in coll.segments),
                "n_dists_by_phase": {p: sum(s_.last_stats.phases[i] for s_ in coll.segments)
                                     for i, p in enumerate(PHASE_NAMES)},
                "repair_unreachable": [s_.last_stats.repair_unreachable for s_ in coll.segments],
                "index_bytes": sum(index_bytes(s_) for s_ in coll.segments),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "ground_truth_s": gt_s,
                "ground_truth_cross_check": gt_check, "results": b_results,
                "code_scan_256_recall@10": scan, "profile_ef96_w1": window,
                "build_launches": build_launches, "launches": launches_b}
    del coll, base, queries
    emit({"phase": "flash_ann", **out["b"], "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})
    scan_gate("the flash-ann fan-out search at ef=256", best, scan)
    return launches_a, launches_b


MESH_RANKS = 2  # the mesh phase's ranks: both on the one card (gloo), or one a card (nccl)
MESH_ROWS = 1024  # rows a segment of the mesh phase's part (b), cut from 2,048 (PERF.md §4)
MESH_FIELDS = ("adj0", "adj0_d", "adj_up", "adj_up_d", "levels", "entry", "codes")


def graph_differs(got, want: dict) -> list:
    """The fields of an ``HNSWIndex`` (or a stack of them) whose values differ
    from ``want``'s."""
    have = {f: getattr(got, f) for f in MESH_FIELDS[:-1]} | {"codes": got.backend.codes}
    host = lambda x: np.asarray(x.cpu() if hasattr(x, "cpu") else x)  # noqa: E731
    return [f for f in MESH_FIELDS if not np.array_equal(host(have[f]), host(want[f]))]


def mesh_rank(mesh, handover: str) -> list:
    """Phase 16b on one rank (module level: ``run_ranks`` pickles it). (a)
    ``make_segmented_build_fn`` over ``handover/a.pt``'s segments, coder and
    plans must equal flash_ann (a)'s ``build_segments_vmapped`` tensor for
    tensor; ``make_segmented_search_fn`` over its 1,024 queries at ef ∈ {96,
    256} must equal ``search_segments_local``'s ids and dists. (b)
    ``ShardedBuilder(mesh=make_segment_mesh(2))`` over ``handover/b.pt``'s
    rows (balanced, hnsw, ``BuildParams()``, the default coder) must run in
    mode "mesh"; each rank rebuilds its own segment with
    ``build_segments_vmapped`` on the same plan and the coder the mesh build
    fitted, which must equal it; the first rank measures recall@10 at ef 96
    against ``exact_knn``. Launches are counted from the start of (a) to the
    end of (b). Returns every rank's readings."""
    import torch

    from repro_torch.core import flash as fl
    from repro_torch.graph import segmented as seg
    from repro_torch.graph.engine import BuildParams, prefix_entries, sample_levels
    from repro_torch.graph.sharded import ShardConfig, ShardedBuilder
    from repro_torch.index import exact_knn
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lm
    from repro_torch.utils import sync

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, me = mesh.device, mesh.index
    a = torch.load(os.path.join(handover, "a.pt"), weights_only=False)
    out = {"rank": me, "device": str(dev), "backend": str(torch.distributed.get_backend()), **mesh.launch}
    ops.reset_launches()

    # ---- (a) flash-ann's two cells across the ranks ---------------------------
    params = BuildParams(**ANN_PARAMS)
    segs, queries = a["segs"].to(dev), a["queries"].to(dev)
    coder = fl.FlashCoder(*(t.to(dev) for t in a["coder"]))
    lm.reset_comm()
    mesh.barrier()
    t0 = time.perf_counter()
    built = seg.make_segmented_build_fn(mesh, params=params)(segs, coder, a["levels"], a["entries"])
    sync(dev)
    out["a_build_s"] = time.perf_counter() - t0
    out["a_build_gather"] = dict(lm.COMM)
    differ = graph_differs(built.index, a["built"])
    if differ:
        raise AssertionError(f"rank {me}: the mesh build differs from flash_ann (a)'s in {differ}")
    offsets = np.arange(segs.shape[0]) * segs.shape[1]
    out["a_search"] = []
    for ef in ANN_EF:
        fn = seg.make_segmented_search_fn(mesh, k=a["k"], ef_search=ef)
        fn(built, queries[:32], offsets, segs)  # warm-up
        lm.reset_comm()
        mesh.barrier()
        sync(dev)
        t0 = time.perf_counter()
        ids, dists = fn(built, queries, offsets, segs)
        sync(dev)
        dt = time.perf_counter() - t0
        want_ids, want_d = a["found"][ef]
        if not (ids.cpu().equal(want_ids) and dists.cpu().equal(want_d)):
            raise AssertionError(f"rank {me}: the mesh search at ef={ef} differs from search_segments_local: "
                                 f"{int((ids.cpu() != want_ids).sum())} ids, "
                                 f"max |Δd| {float((dists.cpu() - want_d).abs().max())}")
        out["a_search"].append({"ef": ef, "qps": queries.shape[0] / dt, "seconds": dt,
                                "one_card_qps": a["qps"][ef], "gather": dict(lm.COMM)})
    del built, segs, queries

    # ---- (b) ShardedBuilder's mesh mode ---------------------------------------
    b = torch.load(os.path.join(handover, "b.pt"), weights_only=False)
    pb = BuildParams()
    cfg = ShardConfig(n_segments=mesh.size, algo="hnsw", params=pb, seed=0)
    lm.reset_comm()
    mesh.barrier()
    t0 = time.perf_counter()
    res = ShardedBuilder(cfg, mesh=lm.make_segment_mesh(mesh.size), workdir=os.path.join(handover, "b"),
                         device=dev).build(b["rows"])
    sync(dev)
    out["b_s"] = time.perf_counter() - t0
    if res.mode != "mesh" or res.n_workers != mesh.size:
        raise AssertionError(f"rank {me}: ShardedBuilder ran in mode {res.mode!r} on {res.n_workers} workers")
    out["b"] = {"mode": res.mode, "seg_sizes": list(res.plan.seg_sizes), "assign_s": res.wall_assign_s,
                "build_s": res.wall_build_s, "gather": dict(lm.COMM)}
    vecs = torch.from_numpy(res.plan.load_segment(me)[0]).to(dev)
    lv = sample_levels(cfg.seed + me, vecs.shape[0], r_upper=pb.r_upper, max_layers=pb.max_layers)
    mine = res.index.segments[me]
    t0 = time.perf_counter()
    want = seg.build_segments_vmapped(vecs[None], mine.backend.coder, lv[None], prefix_entries(lv, pb.batch)[None],
                                      params=pb).index
    sync(dev)
    out["b"]["vmapped_check_s"] = time.perf_counter() - t0
    differ = graph_differs(mine.graph, {f: getattr(want, f)[0] for f in MESH_FIELDS[:-1]}
                           | {"codes": want.backend.codes[0]})
    if differ:
        raise AssertionError(f"rank {me}: the mesh build's segment {me} differs from build_segments_vmapped "
                             f"in {differ}")
    if me == 0:
        qb = torch.from_numpy(b["queries"]).to(dev)
        gt = exact_knn(qb, torch.from_numpy(b["rows"]).to(dev), k=10)[0].long()
        out["b"]["recall@10_ef96"] = recall_at(res.index.search(qb, k=10, ef=96).ids, gt)
    sync(dev)
    every = [None] * mesh.size
    torch.distributed.all_gather_object(every, {**out, "launches": dict(ops.launches)})
    return every


def mesh_path(dev, handover: str, rows, queries, t_start: float) -> dict:
    """Phase 16b: flash_ann (a)'s programs and ``ShardedBuilder``'s mesh mode
    over ``MESH_RANKS`` ranks (``launch.mesh.run_ranks``: both on the card
    over ``gloo`` on a one-card host, a card each over ``nccl`` with more);
    ``rows`` / ``queries`` are part (b)'s. Prints the ranks, the backend,
    ranks a card, each rank's start-up, group rendezvous, build and gather
    seconds and bytes (and the bytes staged through the host), the search
    program's QPS beside (a)'s one-card QPS, (b)'s assignment and build
    seconds and recall. Returns the launches summed over the ranks."""
    import torch

    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    torch.save({"rows": rows, "queries": queries}, os.path.join(handover, "b.pt"))
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_ranks(mesh_rank, MESH_RANKS, handover, device=dev, timeout=300)
    wall = time.perf_counter() - t_phase
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    if launches["l2_batch"] == 0:
        raise AssertionError("the mesh path never launched l2_batch")
    cards = torch.cuda.device_count()
    emit({"phase": "mesh", "ranks": MESH_RANKS, "backend": ranks[0]["backend"], "cards": cards,
          "ranks_per_card": -(-MESH_RANKS // min(MESH_RANKS, cards)), "b_rows": list(rows.shape),
          "per_rank": [{k: v for k, v in r.items() if k != "launches"} for r in ranks],
          "launches": launches, "phase_s": wall, "elapsed_s": time.perf_counter() - t_start})
    return launches


RECSYS_SEED = 0
RECSYS_BULK_CHECK = 256  # serve_bulk sessions held against the CPU


def recsys_cells_path(dev, t_start: float) -> dict:
    """Phase 17: BERT4Rec's serving cells through ``launch/steps.build_bundle``
    at the full config with seeded weights, sessions from ``recsys_batch``
    ending in [MASK]: ``serve_p99`` at B 512 (ms a batch), ``serve_bulk`` at
    B 262,144 in blocks of ``steps.BULK_BLOCK`` (s for all of them),
    ``retrieval_cand`` at B 1 over 1,000,000 candidates coded by a Flash
    coder (d_f 48, M 16) fitted on those rows (ms; one ``flash_scan`` a
    call); each with its model FLOPs/s over the float32 peak. The card's
    ``serve_bulk`` top-100 ids on 256 sessions equal ``score_all`` and
    ``topk_first`` on the CPU, except at near ties (the CPU's scores of the
    differing ids within 1e-5 of the 100th's), counted. Returns the
    launches."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import flash as fl
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.recsys import bert4rec as b4r
    from repro_torch.utils import topk_first, tree_map

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    arch = get_arch("bert4rec")
    cfg = arch.make_full()
    dims = {s.name: s.dims for s in arch.shapes}
    gen = torch.Generator(device=dev).manual_seed(RECSYS_SEED)
    params = b4r.params_tree(b4r.Bert4Rec(cfg, gen, device=dev))

    def sessions(batch: int, step: int):
        items = recsys_batch(RECSYS_SEED, step, 0, batch=batch, seq=cfg.seq_len, n_items=cfg.n_items,
                             device=dev)["items"]
        items[:, -1] = cfg.mask_id
        return items

    out = {}
    ops.reset_launches()
    b = steps.build_bundle("bert4rec", "serve_p99", device=dev)
    items = sessions(dims["serve_p99"]["global_batch"], 1)
    logits = b.fn(params, items)
    if tuple(logits.shape) != (items.shape[0], cfg.n_items + 1) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("serve_p99: malformed logits")
    del logits
    ms = path_ms(lambda: b.fn(params, items))
    out["serve_p99"] = {"batch": items.shape[0], "ms": ms, "model_flops": b.model_flops,
                        "share_of_fp32_peak": b.model_flops / (ms / 1e3) / CUDA_CORE_OPS_PER_S}

    b = steps.build_bundle("bert4rec", "serve_bulk", device=dev)
    items = sessions(dims["serve_bulk"]["global_batch"], 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, scores = b.fn(params, items)
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    if tuple(ids.shape) != (items.shape[0], steps.BULK_K) or bool((ids < 0).any()) or \
            not bool(torch.isfinite(scores).all()):
        raise AssertionError("serve_bulk: malformed result")
    # the card against the CPU on the first sessions
    cpu_params = tree_map(lambda t: t.cpu(), params)
    nc = RECSYS_BULK_CHECK
    with torch.no_grad():
        logits_cpu = b4r.bert4rec_score_all(cpu_params, cfg, items[:nc].cpu())
    want_s, want_i = topk_first(logits_cpu, steps.BULK_K)
    got_i = ids[:nc].cpu().long()
    differ = (got_i.sort(1).values != want_i.sort(1).values).any(1)
    kth = want_s[:, -1:]
    near_rows = 0
    for r in torch.nonzero(differ)[:, 0].tolist():
        extra = got_i[r][~torch.isin(got_i[r], want_i[r])]
        near_rows += int(bool(((logits_cpu[r, extra] - kth[r]).abs() <= 1e-5 * max(1.0, float(kth[r].abs()))).all()))
    if int(differ.sum()) > near_rows:
        raise AssertionError(f"serve_bulk: {int(differ.sum())} of {nc} sessions' top-100 differ from the CPU's, "
                             f"{near_rows} at near ties")
    del logits_cpu, cpu_params
    out["serve_bulk"] = {"batch": items.shape[0], "block": steps.BULK_BLOCK, "seconds": bulk_s,
                         "sessions_per_s": items.shape[0] / bulk_s, "model_flops": b.model_flops,
                         "share_of_fp32_peak": b.model_flops / bulk_s / CUDA_CORE_OPS_PER_S,
                         "card_vs_cpu": {"sessions": nc, "rows_differ": int(differ.sum()), "near_ties": near_rows}}
    del ids, scores, items

    b = steps.build_bundle("bert4rec", "retrieval_cand", device=dev)
    n_cand = dims["retrieval_cand"]["n_candidates"]
    t0 = time.perf_counter()
    table = params["item_embed"][:n_cand]
    coder = fl.fit_flash(table, d_f=48, m_f=16, kmeans_iters=10, device=dev)
    codes = fl.encode(coder, table)
    fit_s = time.perf_counter() - t0
    items = sessions(dims["retrieval_cand"]["global_batch"], 3)
    adt = fl.query_ctx(coder, b4r.bert4rec_serve(params, cfg, items)).adt_q[0]
    before = ops.launches["flash_scan"]
    res = b.fn(params, items, codes, adt)
    if [tuple(t.shape) for t in res] != [(1, 100), (1, 100), (100,), (100,)]:
        raise AssertionError("retrieval_cand: malformed result")
    if ops.launches["flash_scan"] - before != 1:
        raise AssertionError("retrieval_cand did not launch flash_scan once")
    ms = path_ms(lambda: b.fn(params, items, codes, adt))
    overlap = float(torch.isin(res[2], res[0][0]).double().mean())
    out["retrieval_cand"] = {"candidates": n_cand, "coder_fit_and_encode_s": fit_s, "ms": ms,
                             "model_flops": b.model_flops,
                             "share_of_fp32_peak": b.model_flops / (ms / 1e3) / CUDA_CORE_OPS_PER_S,
                             "flash_top100_in_dense_top100": overlap}
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    if launches["flash_scan"] == 0:
        raise AssertionError("the recsys cells never launched flash_scan")
    del params, table, codes
    emit({"phase": "recsys_cells", **out, "launches": launches, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})
    return launches


MESH_STEPS_RANKS = 2  # the mesh_steps phase's ranks, sharing the one card over gloo: a (data 1, model 2) mesh
MESH_TRAIN_STEPS = 3
MESH_TRAIN_SESSIONS = 64  # sessions a step: the training phase's cut (PERF.md §4)
MESH_TRAIN_MICROBATCHES = 8
MESH_P99_CHECK = 32  # serve_p99 sessions whose logits are held against one process
MESH_BULK_SESSIONS = 8_192  # serve_bulk's sessions (one block), cut from 262,144 (PERF.md §4)
MESH_GNN_STEPS = 3
#: the GNN cells across ranks: (arch, cell, depth; None is the full depth).
#: Equiformer's 12 layers cut to 4: its node aggregates go through the host
#: (2.6 GB a step at 12, ~0.5 GB/s over gloo) and the phase's budget is 60 s
#: (PERF.md §4)
MESH_GNN_CELLS = (("gatedgcn", "full_graph_sm", None), ("equiformer-v2", "molecule", 4))
MESH_SCORE_ATOL = 2e-5  # scores and logits against one process (tests/test_torch_launch.py's bound)


def ids_near_ties(got_i, got_s, want_i, want_s, what: str) -> dict:
    """Top-k ids (rows of k) of a run against another's: equal as sets but
    where the differing ids score within 1e-5 of the other's k-th (a near
    tie, counted); scores within ``MESH_SCORE_ATOL``."""
    import torch

    got_i, want_i, got_s, want_s = (t.cpu().reshape(-1, t.shape[-1]) for t in (got_i, want_i, got_s, want_s))
    differ = (got_i.long().sort(1).values != want_i.long().sort(1).values).any(1)
    near = 0
    for r in torch.nonzero(differ)[:, 0].tolist():
        kth = float(want_s[r, -1])
        extra = got_s[r][~torch.isin(got_i[r], want_i[r])]
        near += int(bool(((extra - kth).abs() <= 1e-5 * max(1.0, abs(kth))).all()))
    err = float((got_s.double() - want_s.double()).abs().max()) if not bool(differ.any()) else None
    if int(differ.sum()) > near or (err is not None and err > MESH_SCORE_ATOL):
        raise AssertionError(f"{what}: {int(differ.sum())} rows' ids differ from one process ({near} at near "
                             f"ties), max |Δscore| {err}")
    return {"rows": int(got_i.shape[0]), "rows_differ": int(differ.sum()), "near_ties": near, "max_abs_err": err}


def gnn_state_ratios(got: dict, want: dict, steps: int) -> dict:
    """Each group's largest difference over its bound (``GNN_TRAIN_CARD_RTOL``
    of the tensor's largest magnitude, plus 2·steps·lr for a parameter;
    ``GNN_NOISE_LEAVES`` of their tree's largest) after ``steps`` steps:
    trees of (path → tensor) and the last step's metrics as floats."""
    lr = float(want["metrics"]["lr"])
    out = {k: abs(got["metrics"][k] - want["metrics"][k]) / (GNN_TRAIN_CARD_RTOL * abs(want["metrics"][k]))
           for k in ("loss", "grad_norm")}
    for key, atol in (("params", 2 * steps * lr), ("mu", 0.0), ("nu", 0.0)):
        largest = max(float(y.abs().max()) for y in want[key].values())
        worst = 0.0
        for path, y in want[key].items():
            scale = largest if path in GNN_NOISE_LEAVES else float(y.abs().max())
            diff = float((got[key][path].double().cpu() - y.double().cpu()).abs().max())
            worst = max(worst, diff / (GNN_TRAIN_CARD_RTOL * scale + atol or 1e-30))
        out[key] = worst
    return out


def mesh_steps_rank(world, handover: str) -> list:
    """Phase 17b on one rank (module level: ``run_ranks`` pickles it): the
    cells of ``launch/steps.build_bundle(..., mesh=...)`` on a (data 1,
    model ``MESH_STEPS_RANKS``) mesh over the ranks, each held against the
    same cell in one process, which the first rank runs first from the same
    weights and inputs (every rank draws them from the same seeded card
    generators; the candidate codes the first rank fits go to the others
    through ``handover``): BERT4Rec at its full config trained 3 steps of
    64 sessions (8 microbatches), ``serve_p99`` at B 512, ``serve_bulk``
    over ``MESH_BULK_SESSIONS`` sessions, ``retrieval_cand`` at B 1 over
    1,000,000 rows (a d_f 48, M 16 coder; ``flash_scan`` over this rank's
    500,000 code rows), and ``MESH_GNN_CELLS``, 3 steps each. Outputs are
    put back together by ``gather_from_mesh`` (``serve_p99``'s vocabulary
    block is held against its columns). Each cell's seconds a step or
    call, in one process and across the ranks, the bytes ``COMM`` counted
    and each section's wall seconds. Launches are counted over the cells
    across the ranks; then each rank in turn times its ``flash_scan``
    alone. Returns every rank's readings."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import flash as fl
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import steps
    from repro_torch.models.recsys import bert4rec as b4r
    from repro_torch.train.elastic import gather_from_mesh, reshard_for_mesh
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.utils import sync, tree_map, tree_paths, tree_size

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_rank = time.perf_counter()
    dev = world.device
    mesh = lm.Mesh({"data": 1, "model": world.size}, range(world.size), dev)
    me = mesh.index
    first = me == 0
    out = {"rank": me, "coords": mesh.coords, "backend": str(torch.distributed.get_backend()), **world.launch}
    sections: dict = {}
    one: dict = {}
    batch_spec = (("data",), None)

    def timed(fn, barrier: bool = True):
        """fn() to a synchronized end (after a barrier across the ranks):
        (result, seconds, COMM bytes)."""
        lm.reset_comm()
        if barrier:
            mesh.barrier()
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        return res, time.perf_counter() - t0, dict(lm.COMM)

    def section(name: str, t0: float) -> float:
        sections[name] = time.perf_counter() - t0
        return time.perf_counter()

    # ---- the inputs: every rank draws them from the same seeds ----------------------
    cfg = get_arch("bert4rec").make_full()
    params = b4r.params_tree(b4r.Bert4Rec(cfg, torch.Generator(device=dev).manual_seed(RECSYS_SEED), device=dev))

    def sessions(batch: int, step: int):
        items = recsys_batch(RECSYS_SEED, step, 0, batch=batch, seq=cfg.seq_len, n_items=cfg.n_items,
                             device=dev)["items"]
        items[:, -1] = cfg.mask_id
        return items

    batches = []
    for step in range(MESH_TRAIN_STEPS):
        bt = recsys_batch(RECSYS_SEED, 100 + step, 0, batch=MESH_TRAIN_SESSIONS, seq=cfg.seq_len,
                          n_items=cfg.n_items, device=dev)
        batches.append((bt["items"], bt["mask_positions"]))
    p99_items = sessions(next(s for s in get_arch("bert4rec").shapes if s.name == "serve_p99").dims["global_batch"], 1)
    bulk_items, cand_items = sessions(MESH_BULK_SESSIONS, 2), sessions(1, 3)
    gnn = {}
    for arch, cell, depth in MESH_GNN_CELLS:
        override = {} if depth is None else {"n_layers": depth}
        shape = next(s for s in get_arch(arch).shapes if s.name == cell)
        gcfg = steps.gnn_adapt_config(dataclasses.replace(get_arch(arch).make_full(), **override), shape)
        gen = torch.Generator(device=dev).manual_seed(GNN_SEED)
        batch = steps.gnn_batch(gcfg, shape, gen, device=dev)
        gnn[arch] = (cell, override, gcfg.n_layers, batch, steps.gnn_init(gcfg, gen, device=dev))
    codes_path = os.path.join(handover, "codes.pt")
    # every bundle, on every rank at once: the first one's meta tensors load
    # torch's reference ops (seconds in a fresh process)
    names = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
    one_b = {name: steps.build_bundle("bert4rec", name, device=dev, microbatches=MESH_TRAIN_MICROBATCHES)
             for name in names}
    mesh_b = {name: steps.build_bundle("bert4rec", name, device=dev, mesh=mesh, microbatches=MESH_TRAIN_MICROBATCHES)
              for name in names}
    for arch, (cell, override, *_) in gnn.items():
        one_b[arch] = steps.build_bundle(arch, cell, device=dev, cfg_override=override)
        mesh_b[arch] = steps.build_bundle(arch, cell, device=dev, mesh=mesh, cfg_override=override)
    t0 = section("inputs", t_rank)

    # ---- one process, on the first rank: every cell, kept for the checks ------------
    if first:
        b = one_b["train_batch"]
        p, o = tree_map(torch.clone, params), adamw_init(params)
        rows = []
        for items, mask in batches:
            (p, o, m), dt, _ = timed(lambda: b.fn(p, o, items, mask), barrier=False)
            rows.append({"s": dt, **{k: float(v) for k, v in m.items()}})
        one["train"] = {"s_per_step": [r["s"] for r in rows], "loss": [r["loss"] for r in rows]}
        want_train = {"metrics": rows, "params": p, "mu": o.mu, "nu": o.nu}
        del p, o
        b = one_b["serve_p99"]
        want_p99 = b.fn(params, p99_items)[:MESH_P99_CHECK].clone()
        one["serve_p99"] = {"batch": p99_items.shape[0], "ms": path_ms(lambda: b.fn(params, p99_items))}
        b = one_b["serve_bulk"]
        (want_ids, want_scores), dt, _ = timed(lambda: b.fn(params, bulk_items), barrier=False)
        one["serve_bulk"] = {"sessions": bulk_items.shape[0], "s": dt}
        b = one_b["retrieval_cand"]
        n_cand = b.args[2].shape[0]
        t1 = time.perf_counter()
        table = params["item_embed"][:n_cand]
        coder = fl.fit_flash(table, d_f=48, m_f=16, kmeans_iters=10, device=dev)
        codes = fl.encode(coder, table)
        adt = fl.query_ctx(coder, b4r.bert4rec_serve(params, cfg, cand_items)).adt_q[0]
        fit_s = time.perf_counter() - t1
        want_cand = b.fn(params, cand_items, codes, adt)
        one["retrieval_cand"] = {"candidates": n_cand, "coder_fit_and_encode_s": fit_s,
                                 "ms": path_ms(lambda: b.fn(params, cand_items, codes, adt))}
        torch.save({"codes": codes.cpu(), "adt": adt.cpu()}, codes_path)
        del table, coder, codes
        want_gnn = {}
        for arch, (cell, override, layers, batch, p0) in gnn.items():
            b = one_b[arch]
            p, o = tree_map(torch.clone, p0), adamw_init(p0)
            torch.cuda.reset_peak_memory_stats()
            step_s = []
            for _ in range(MESH_GNN_STEPS):
                (p, o, m), dt, _ = timed(lambda: b.fn(p, o, batch["graph"], batch["labels"]), barrier=False)
                step_s.append(dt)
            want_gnn[arch] = {"metrics": {k: float(v) for k, v in m.items()}, "params": dict(tree_paths(p)),
                              "mu": dict(tree_paths(o.mu)), "nu": dict(tree_paths(o.nu))}
            one[f"{arch}@{cell}"] = {"layers": layers, "s_per_step": step_s,
                                     "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            del p, o
        torch.cuda.empty_cache()
    mesh.barrier()
    t0 = section("one_process", t0)

    # ---- across the ranks ----------------------------------------------------------
    ops.reset_launches()
    b = mesh_b["train_batch"]
    pspecs = b.in_specs[0]
    p = reshard_for_mesh(params, pspecs, mesh)
    o = adamw_init(p)
    rows = []
    for items, mask in batches:
        (p, o, m), dt, comm = timed(lambda: b.fn(p, o, reshard_for_mesh(items, batch_spec, mesh),
                                                 reshard_for_mesh(mask, batch_spec, mesh)))
        rows.append({"s": dt, "comm": comm, **{k: float(v) for k, v in m.items()}})
    out["train"] = {"steps": rows}
    t0 = section("train", t0)
    whole = {"params": gather_from_mesh(p, pspecs, mesh), "mu": gather_from_mesh(o.mu, pspecs, mesh),
             "nu": gather_from_mesh(o.nu, pspecs, mesh)}
    del p, o
    t0 = section("train_gather", t0)
    if first:
        for got, want in zip(rows, want_train["metrics"]):
            for k in ("loss", "grad_norm"):
                if not np.isclose(got[k], want[k], rtol=1e-4 if k == "grad_norm" else 1e-5, atol=0.0):
                    raise AssertionError(f"BERT4Rec train across ranks: {k} {got[k]} against one process's {want[k]}")
        lr = max(m["lr"] for m in want_train["metrics"])
        noise = 0
        for key in ("params", "mu", "nu"):
            want = dict(tree_paths(want_train[key]))
            for path, got in tree_paths(whole[key]):
                noise += noise_count(got, want[path], lr=lr, steps=MESH_TRAIN_STEPS, what=f"BERT4Rec {key} {path}")
        size = 3 * tree_size(whole["params"])
        if noise > size // 10_000:
            raise AssertionError(f"BERT4Rec train across ranks: {noise} of {size} elements differ from one process")
        out["train"]["against_one_process"] = {"elements_beyond_1e-4": noise, "elements": size}
        del want_train
    del whole, batches
    t0 = section("train_check", t0)

    shared = torch.load(codes_path, weights_only=True, mmap=True)
    adt = shared["adt"].to(dev)
    params = reshard_for_mesh(params, pspecs, mesh)
    b = mesh_b["serve_p99"]
    items = reshard_for_mesh(p99_items, batch_spec, mesh)
    block, dt, comm = timed(lambda: b.fn(params, items))
    if first:  # the first rank's vocabulary block: the first columns
        err = float((block[:MESH_P99_CHECK].double() - want_p99[:, :block.shape[1]].double()).abs().max())
        if not bool(torch.isfinite(block).all()) or err > MESH_SCORE_ATOL:
            raise AssertionError(f"serve_p99 across ranks: the first block's logits {err} from one process's")
        del want_p99
    del block
    _, dt_warm, _ = timed(lambda: b.fn(params, items))
    out["serve_p99"] = {"s_first": dt, "s": dt_warm, "comm": comm}
    b = mesh_b["serve_bulk"]
    (ids, scores), dt, comm = timed(lambda: b.fn(params, reshard_for_mesh(bulk_items, batch_spec, mesh)))
    ids, scores = (gather_from_mesh(t, spec, mesh) for t, spec in zip((ids, scores), b.out_specs))
    out["serve_bulk"] = {"sessions": ids.shape[0], "s": dt, "comm": comm}
    if first:
        out["serve_bulk"]["against_one_process"] = ids_near_ties(ids, scores, want_ids, want_scores,
                                                                 "serve_bulk across ranks")
        del want_ids, want_scores
    del ids, scores
    b = mesh_b["retrieval_cand"]
    codes = reshard_for_mesh(shared["codes"], b.in_specs[2], mesh)
    before = ops.launches["flash_scan"]
    res, dt, comm = timed(lambda: b.fn(params, cand_items, codes, adt))
    if ops.launches["flash_scan"] - before != 1:
        raise AssertionError(f"retrieval_cand across ranks: rank {me} did not launch flash_scan once")
    out["retrieval_cand"] = {"code_rows": codes.shape[0], "s_first": dt, "comm": comm,
                             "ms": path_ms(lambda: b.fn(params, cand_items, codes, adt))}
    if first:
        out["retrieval_cand"].update(
            dense=ids_near_ties(res[0], res[1], want_cand[0], want_cand[1], "retrieval_cand dense"),
            flash=ids_near_ties(res[2][None], res[3][None], want_cand[2][None], want_cand[3][None],
                                "retrieval_cand flash"))
    del params, shared
    t0 = section("serve", t0)

    for arch, (cell, override, layers, batch, p0) in gnn.items():
        b = mesh_b[arch]
        p, o = p0, adamw_init(p0)
        graph = steps.shard_graph(batch["graph"], mesh)
        rows = []
        for _ in range(MESH_GNN_STEPS):
            (p, o, m), dt, comm = timed(lambda: b.fn(p, o, graph, batch["labels"]))
            rows.append({"s": dt, "comm": comm, **{k: float(v) for k, v in m.items()}})
        out[f"{arch}@{cell}"] = {"layers": layers, "steps": rows, "edges_this_rank": int(graph.senders.shape[0])}
        if first:
            got = {"metrics": rows[-1], "params": dict(tree_paths(p)), "mu": dict(tree_paths(o.mu)),
                   "nu": dict(tree_paths(o.nu))}
            ratios = gnn_state_ratios(got, want_gnn.pop(arch), MESH_GNN_STEPS)
            if not all(np.isfinite(v) and v <= 1.0 for v in ratios.values()):
                raise AssertionError(f"{arch} across ranks: difference over bound {ratios}")
            out[f"{arch}@{cell}"]["difference_over_bound"] = ratios
        del p, o, p0, graph, batch
        t0 = section(arch, t0)
    sync(dev)
    out["launches"] = dict(ops.launches)
    out["one_process"] = one
    # flash_scan alone over this rank's rows, one rank at a time (after the counts)
    for r in range(mesh.size):
        if r == me:
            out["flash_scan_ms"] = time_ms(lambda: ops.flash_scan(codes, adt))
        mesh.barrier()
    section("flash_scan_timing", t0)
    out["sections_s"] = sections
    every = [None] * mesh.size
    torch.distributed.all_gather_object(every, out)
    return every


def mesh_steps_path(dev, smi: str, t_start: float) -> dict:
    """Phase 17b: the recsys and GNN step bundles across ``MESH_STEPS_RANKS``
    ranks sharing the card over ``gloo`` (``run_ranks``; a (data 1, model
    2) mesh, so BERT4Rec's tensor-parallel split runs), each cell held on
    the card against the port's own one-process step from the same weights
    and inputs (``mesh_steps_rank``). Prints each cell's one-process time
    beside every rank's, the ranks' start-up and rendezvous, the bytes
    ``COMM`` counted, ``flash_scan``'s launches and ms a rank, beside the
    card's name and power limit. Returns the launches summed over the
    ranks."""
    import torch

    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    handover = tempfile.mkdtemp(prefix="chip-smoke-mesh-steps-")
    try:
        ranks = run_ranks(mesh_steps_rank, MESH_STEPS_RANKS, handover, device=dev, timeout=300)
    finally:
        shutil.rmtree(handover, ignore_errors=True)
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    if any(r["launches"]["flash_scan"] == 0 for r in ranks):
        raise AssertionError("a rank of the mesh_steps phase never launched flash_scan")
    emit({"phase": "mesh_steps", "card": smi, "ranks": MESH_STEPS_RANKS, "mesh": {"data": 1, "model": MESH_STEPS_RANKS},
          "backend": ranks[0]["backend"], "one_process": ranks[0]["one_process"],
          "per_rank": [{k: v for k, v in r.items() if k not in ("launches", "one_process")} for r in ranks],
          "flash_scan_per_rank": [{"launches": r["launches"]["flash_scan"], "ms": r["flash_scan_ms"],
                                   "code_rows": r["retrieval_cand"]["code_rows"]} for r in ranks],
          "launches": launches, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})
    return launches


# ---------------------------------------------------------------------------
# LM serving and training across ranks (phase 17c)
# ---------------------------------------------------------------------------

#: moonshot-v1-16b-a3b at full width on a (data 1, model MESH_LM_RANKS) mesh
#: of ranks sharing the card over gloo, depth 4 of 48 (the dense first layer
#: and 3 MoE layers), bf16 (PERF.md §4)
MESH_LM_RANKS = 2
MESH_LM_ARCH = "moonshot-v1-16b-a3b"
MESH_LM_DEPTH = 4
MESH_LM_SEED = 0
MESH_LM_PREFILL = (2, 2048)  # B × S: 4,096 tokens, 2,048 a rank through the ep branch
MESH_LM_DECODE = (8, 512, 4)  # a prefill of B × S, then decode steps: 4 tokens a rank through the ep branch
MESH_LM_LONG = 4  # long-context decode steps at B 1 (the scatter branch), from that prefill's first row
MESH_LM_WARMUP = 64  # tokens a row of the untimed warm-up prefill before each side's timed cells
#: the float32 copy held within tests/test_torch_mesh_lm.py's bounds: full
#: width, depth 2 (the dense layer and one MoE layer), smaller cells
MESH_LM_F32 = {"depth": 2, "prefill": (2, 256), "decode": (8, 64, 2), "long": 2}
MESH_LM_REL = 1e-4  # logits within 1e-4 of the largest |logit|
MESH_LM_F32_TIE = 1e-4  # a float32 near tie: a top-2 margin below this
MESH_LM_TIE = LM_DECODE_ATOL  # a bf16 near tie: a top-2 margin below the bf16 decode bound
#: LM training across the same ranks (PR 28): MESH_LM_ARCH at full width,
#: depth 3 of 48 (the dense first layer and 2 MoE layers), float32 masters,
#: bf16 compute, remat as the full config sets it, impl "ep"; train_4k's
#: sequence at B 1 (4,096 tokens, 2,048 a rank through the ep branch), 3
#: steps of launch/steps' train bundle (PERF.md §4)
MESH_LM_TRAIN = {"depth": 3, "batch": (1, 4096), "steps": 3}
MESH_LM_TRAIN_LOSS_REL = 0.01  # bf16: every step's loss within 1% of one process's
#: the float32 copy, TF32 off: losses and grad_norm within 1e-5 relative,
#: each parameter and moment within 1e-4 of its tensor's largest magnitude
#: (parameters 2·steps·lr more), tests/test_torch_mesh_lm_train.py's bounds
MESH_LM_TRAIN_F32 = {"depth": 2, "batch": (2, 512), "steps": 2}
MESH_LM_TRAIN_F32_REL = 1e-5
MESH_LM_TRAIN_STATE_REL = 1e-4


def moe_on_chunks(n_dev: int, ep: int):
    """``moe_forward`` as a mesh of ``n_dev`` ranks (``ep`` of them on the
    expert axis) computes it, in one process: where the reference's ep
    branch runs (tokens that divide over the ranks, no fewer than them),
    each rank's chunk of the tokens is routed and scattered on its own at
    the per-device capacity (the exchange moves those buffers and changes
    nothing), and the aux losses are over every chunk's tokens (as the
    ranks sum their ingredients); elsewhere the global capacity-scatter.
    The one-process side of phase 17c's checks."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.layers import mlp_forward

    def forward(p, x, cfg, *, mesh=None, token_axes=(), global_aux=False):
        b, s, d = x.shape
        flat = x.reshape(b * s, d)
        n = flat.shape[0]
        if cfg.impl != "ep" or n % n_dev or n < n_dev:
            return moe.moe_forward(p, x, cfg)
        n_loc = n // n_dev
        c = max(int(np.ceil(n_loc * cfg.top_k / cfg.n_experts * cfg.capacity_factor)), 1)
        c = -(-c // ep) * ep
        outs = []
        for i in range(n_dev):
            chunk = flat[i * n_loc:(i + 1) * n_loc]
            w, idx, _ = moe._route(p, chunk, cfg)
            outs.append(moe._dispatch_scatter(chunk, w, idx, p, cfg, c))
        out = torch.cat(outs)
        if cfg.n_shared:
            out = out + mlp_forward(p["shared"], flat)
        return out.reshape(b, s, d), moe._route(p, flat, cfg)[2]

    return forward


def mesh_lm_train_exchange_bytes(cfg, batch: tuple, ranks: int) -> dict:
    """The ``all_to_all`` bytes a rank sends in one train step of ``cfg`` on
    a (data 1, model ``ranks``) mesh at B × S = ``batch``, reckoned from the
    shapes: the ep branch's exchange moves (E, c_loc, D) in the compute
    dtype, c_loc = ⌈(B·S / ranks)·k / E·cf⌉ rounded up to a multiple of
    ``ranks``; a MoE layer makes a pair in the forward, a pair again when
    remat recomputes it, and a pair in the backward (the reverse
    exchanges of the gradients, of the same size)."""
    import torch

    m = cfg.moe
    n_loc = batch[0] * batch[1] // ranks
    c = max(int(np.ceil(n_loc * m.top_k / m.n_experts * m.capacity_factor)), 1)
    c = -(-c // ranks) * ranks
    one = m.n_experts * c * cfg.d_model * torch.tensor([], dtype=cfg.dtype).element_size()
    grad = 2 * cfg.n_moe_layers * one
    return {"exchange_bytes": one, "c_loc": c, "grad": grad, "forward": grad * (2 if cfg.remat else 1)}


def argmax_check(got, want, tie: float, what: str) -> dict:
    """Rows whose argmax differs, each with the one-process top-2 margin;
    one that differs where the margin is not below ``tie`` fails."""
    top2 = want.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    differ = (got.argmax(-1) != want.argmax(-1)).nonzero().flatten().tolist()
    out = {"rows": int(want.shape[0]), "argmax_differs": [{"row": r, "margin": margins[r]} for r in differ],
           "max_abs_diff": float((got - want).abs().max()), "min_margin": min(margins)}
    if any(margins[r] >= tie for r in differ) or not bool(got.isfinite().all()):
        raise AssertionError(f"{what}: argmax differs beyond a near tie, or logits not finite: {out}")
    return out


def mesh_lm_train_cell(mesh, spec: dict, dtype, cfg=None) -> dict:
    """Phase 17c's training part on one rank of ``mesh`` (a (data 1, model
    m) mesh): ``spec["steps"]`` steps of the train bundle at ``spec["depth"]``
    and B × S = ``spec["batch"]`` in one process on the first rank
    (its MoE as the mesh computes it), then on the mesh from the same
    weights and batches (every rank draws them from one seeded card
    generator; the one process's state is freed before the mesh's is
    made). Every step's loss and grad_norm must be finite; the bf16
    cell's losses within ``MESH_LM_TRAIN_LOSS_REL`` of one process's;
    the float32 cell's losses and grad_norms within
    ``MESH_LM_TRAIN_F32_REL`` and every parameter and moment within
    ``MESH_LM_TRAIN_STATE_REL`` of its tensor's largest magnitude
    (parameters 2·steps·lr more). For that check every rank runs the
    one-process steps (at once, sharing the card) and keeps its own
    shards of the final state, so each rank holds its shards without a
    gather; the tensor's largest magnitude is the maximum over the ranks'
    shards. Each rank's ``all_to_all`` bytes a
    step must equal ``mesh_lm_train_exchange_bytes``, the backward's
    above 0. ``cfg``: another config than ``MESH_LM_ARCH``'s full one (a
    CPU run at a small width). Returns this rank's readings."""
    from unittest import mock

    import torch

    from repro_torch.configs.registry import ShapeSpec, get_arch
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train.elastic import reshard_for_mesh
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.utils import sync, tree_bytes, tree_paths

    dev, first = mesh.device, mesh.index == 0
    on_card = dev.type == "cuda"

    def timed(fn, barrier: bool):
        """fn() to a synchronized end: (result, seconds, COMM)."""
        lm.reset_comm()
        if barrier:
            mesh.barrier()
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        return res, time.perf_counter() - t0, dict(lm.COMM)

    def peak_gb():
        return torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg or get_arch(MESH_LM_ARCH).make_full(), n_layers=spec["depth"], dtype=dtype)
    b, s = spec["batch"]
    shape = ShapeSpec("train_4k", "train", {"global_batch": b, "seq_len": s})
    gen = torch.Generator(device=dev)
    gen.manual_seed(MESH_LM_SEED)
    params = tfm.init_lm(gen, cfg, device=dev)
    batches = [tuple(torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev, dtype=torch.int32)
                     for _ in range(2)) for _ in range(spec["steps"])]
    bundle = steps.lm_train_bundle(cfg, shape, mesh)
    local = reshard_for_mesh(params, bundle.in_specs[0], mesh)
    state_dtype = steps.lm_opt_cfg(cfg).state_dtype
    res = {"depth": spec["depth"], "batch": list(spec["batch"]), "steps_n": spec["steps"],
           "dtype": str(dtype), "state_gb_whole": 4 * tree_bytes(params) / 1e9,
           "state_gb_rank": 4 * tree_bytes(local) / 1e9}
    check_state = dtype == torch.float32
    if not (first or check_state):
        del params
    sync(dev)
    res["init_s"] = time.perf_counter() - t0
    mesh.barrier()
    one, want = None, None
    if first or check_state:
        reset_peak()
        plain = steps.lm_train_bundle(cfg, shape)
        opt = adamw_init(params, state_dtype=state_dtype)
        one = []
        with mock.patch.object(tfm, "moe_forward", moe_on_chunks(mesh.size, mesh.shape["model"])):
            for tokens, labels in batches:
                (params, opt, m), secs, _ = timed(lambda: plain.fn(params, opt, tokens, labels), False)
                one.append({"s": secs, **{k: float(v) for k, v in m.items()}})
        res["one_process_peak_gb"] = peak_gb()
        if check_state:  # this rank's shards of the final state
            want = {key: reshard_for_mesh(tree, bundle.in_specs[0], mesh)
                    for key, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu))}
        del params, opt
    res["one_process"] = one
    res["one_process_on"] = "every rank at once" if check_state else "the first rank"
    mesh.barrier()
    reset_peak()
    opt = adamw_init(local, state_dtype=state_dtype)
    expect = mesh_lm_train_exchange_bytes(cfg, spec["batch"], mesh.size)
    rows = []
    for tokens, labels in batches:
        placed = [reshard_for_mesh(t, sp, mesh) for t, sp in zip((tokens, labels), bundle.in_specs[2:])]
        (local, opt, m), secs, comm = timed(lambda: bundle.fn(local, opt, *placed), True)
        row = {"s": secs, **{k: float(v) for k, v in m.items()}, "comm": comm,
               "all_to_all_forward_bytes": comm["all_to_all_bytes"] - comm["all_to_all_grad_bytes"]}
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            raise AssertionError(f"{dtype} train step on rank {mesh.index}: loss or grad_norm not finite: {row}")
        if (comm["all_to_all_grad_bytes"] != expect["grad"] or row["all_to_all_forward_bytes"] != expect["forward"]
                or expect["grad"] <= 0):
            raise AssertionError(f"{dtype} train step on rank {mesh.index}: all_to_all bytes {comm} against "
                                 f"the reckoning {expect}")
        rows.append(row)
    res["rank_steps"], res["exchange_reckoning"] = rows, expect
    res["rank_peak_gb"] = peak_gb()
    if first:
        res["check"] = []
        for i, (got, w) in enumerate(zip(rows, one)):
            diff = {k: abs(got[k] - w[k]) / abs(w[k]) for k in ("loss", "ce", "grad_norm", "moe/load_balance",
                                                                "moe/router_z")}
            res["check"].append({"step": i + 1, "loss": got["loss"], "one_process_loss": w["loss"],
                                 "grad_norm": got["grad_norm"], "one_process_grad_norm": w["grad_norm"],
                                 "relative_difference": diff})
            bound = MESH_LM_TRAIN_F32_REL if dtype == torch.float32 else MESH_LM_TRAIN_LOSS_REL
            keys = ("loss", "grad_norm") if dtype == torch.float32 else ("loss",)
            if not all(diff[k] <= bound for k in keys):
                raise AssertionError(f"{dtype} train step {i + 1} across ranks against one process: {diff}")
    if check_state:  # this rank's shards against the same shards of one process's state
        lr = max(w["lr"] for w in one)
        worst = {}
        for key, tree in (("params", local), ("mu", opt.mu), ("nu", opt.nu)):
            wanted = dict(tree_paths(want[key]))
            for path, leaf in tree_paths(tree):
                w = wanted[path]
                largest = float(mesh.all_reduce(w.abs().max(), mesh.axis_names, "max"))
                err = float((leaf - w).abs().max())
                bound = MESH_LM_TRAIN_STATE_REL * largest + (2 * spec["steps"] * lr if key == "params" else 0.0)
                worst[key] = max(worst.get(key, 0.0), err / bound if bound else float(err > 0))
                if not err <= bound:
                    raise AssertionError(f"float32 train on rank {mesh.index}: {key} {path} {err} beyond {bound}")
        res["state_difference_over_bound"] = worst
        del want
    del local, opt
    reset_peak()
    return res


def mesh_lm_rank(world, smi: str) -> list:
    """Phase 17c on one rank (module level: ``run_ranks`` pickles it):
    ``MESH_LM_ARCH`` at full width served through ``launch/steps``' prefill
    and decode bundles on a (data 1, model ``MESH_LM_RANKS``) mesh over the
    ranks (heads, hidden columns, experts and the vocabulary over
    ``"model"``; the caches' sequence over ``"model"``, over every axis in
    long context), each cell held against the same cell in one process,
    which the first rank runs first from the same weights (every rank draws
    them from one seeded card generator), its MoE as the mesh computes it
    (``moe_on_chunks``). Cells: a prefill; a prefill whose caches, gathered
    and padded, a batched decode continues for some greedy steps; a
    long-context decode at B 1 from that prefill's first row. The mesh's
    decode steps take the tokens the one-process steps took. First a
    float32 copy at depth 2, held within ``MESH_LM_REL``; then the bf16
    cells at depth ``MESH_LM_DEPTH``, every argmax equal but at near ties
    (``MESH_LM_TIE``). Each cell's seconds in one process and on each rank,
    ``COMM`` by kind, peak memory. Returns every rank's readings."""
    from unittest import mock

    import torch

    from repro_torch.configs.registry import ShapeSpec, get_arch
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train.elastic import gather_from_mesh, reshard_for_mesh
    from repro_torch.utils import sync, tree_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = world.device
    mesh = lm.Mesh({"data": 1, "model": world.size}, range(world.size), dev)
    first = mesh.index == 0
    out = {"rank": mesh.index, "coords": mesh.coords, "backend": str(torch.distributed.get_backend()),
           **world.launch}

    def timed(fn, barrier: bool):
        """fn() to a synchronized end: (result, seconds, COMM)."""
        lm.reset_comm()
        if barrier:
            mesh.barrier()
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        return res, time.perf_counter() - t0, dict(lm.COMM)

    def padded(caches, s_max: int):
        return {k: torch.cat([c, c.new_zeros((*c.shape[:2], s_max - c.shape[2], *c.shape[3:]))], 2)
                for k, c in caches.items()}

    def run(cfg, weights, toks_p, toks_d, n_dec: int, n_long: int, m=None, given=None):
        """The cells on ``m`` (None: one process) from ``weights`` (this
        rank's shards on a mesh): {cell: (logits, seconds, COMM) lists}
        and the tokens each decode step took (its own greedy ones unless
        ``given``)."""
        s_d = toks_d.shape[1]
        s_max = s_d + max(n_dec, n_long)

        def shape(kind, name, b, s):
            return ShapeSpec(name, kind, {"global_batch": b, "seq_len": s})

        def place(x, spec):
            return x if m is None else reshard_for_mesh(x, spec, m)

        pre = steps.lm_prefill_bundle(cfg, shape("prefill", "prefill_32k", *toks_p.shape), m)
        pre_d = steps.lm_prefill_bundle(cfg, shape("prefill", "prefill_32k", *toks_d.shape), m)
        warm = toks_p[:, :MESH_LM_WARMUP]  # a first call's costs stay out of the timed ones
        warm_pre = steps.lm_prefill_bundle(cfg, shape("prefill", "prefill_32k", *warm.shape), m)
        timed(lambda: warm_pre.fn(weights, place(warm, m and warm_pre.in_specs[1])), m is not None)
        got, fed = {}, {}
        (lg, _), s, comm = timed(lambda: pre.fn(weights, place(toks_p, m and pre.in_specs[1])), m is not None)
        got["prefill"] = ([lg], [s], [comm])
        (lg, caches), s, comm = timed(lambda: pre_d.fn(weights, place(toks_d, m and pre_d.in_specs[1])),
                                      m is not None)
        got["decode_prefill"] = ([lg], [s], [comm])
        first_token = lg.argmax(-1).to(torch.int32)
        caches = padded(caches if m is None else gather_from_mesh(caches, pre_d.out_specs[1], m), s_max)
        for cell, name, rows, n in (("decode", "decode_32k", toks_d.shape[0], n_dec), ("long", "long_500k", 1, n_long)):
            bundle = steps.lm_decode_bundle(cfg, shape("decode", name, rows, s_max), m)
            c = place({k: v[:, :rows].clone() for k, v in caches.items()}, m and bundle.in_specs[1])
            token = first_token[:rows]
            got[cell], fed[cell] = ([], [], []), []
            for i in range(n):
                if given is not None:
                    token = given[cell][i].to(dev)
                fed[cell].append(token.cpu())
                (lg, c), s, comm = timed(lambda: bundle.fn(weights, c, place(token, m and bundle.in_specs[2]),
                                                           torch.tensor(s_d + i, device=dev)), m is not None)
                for part, x in zip(got[cell], (lg, s, comm)):
                    part.append(x)
                token = lg.argmax(-1).to(torch.int32)
            del c
        return got, fed

    def cells(depth: int, dtype, prefill, decode, n_long: int, tie: float, rel: float | None):
        """The three cells at ``depth``, one process then the mesh, held
        against each other: argmax but at near ties (``tie``), and the
        logits within ``rel`` of the largest where it is given."""
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_arch(MESH_LM_ARCH).make_full(), n_layers=depth, dtype=dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(MESH_LM_SEED)
        params = tfm.serving_params(tfm.init_lm(gen, cfg, device=dev), cfg)
        toks_p = torch.randint(0, cfg.vocab, prefill, generator=gen, device=dev, dtype=torch.int32)
        toks_d = torch.randint(0, cfg.vocab, decode[:2], generator=gen, device=dev, dtype=torch.int32)
        local = reshard_for_mesh(params, tfm.lm_param_specs(cfg), mesh)
        sync(dev)
        res = {"params_gb_whole": tree_bytes(params) / 1e9, "params_gb_rank": tree_bytes(local) / 1e9,
               "init_s": time.perf_counter() - t0}
        mesh.barrier()
        t0 = time.perf_counter()
        one = given = None
        if first:
            with mock.patch.object(tfm, "moe_forward", moe_on_chunks(mesh.size, mesh.shape["model"])):
                one, given = run(cfg, params, toks_p, toks_d, decode[2], n_long)
        del params
        given = mesh.broadcast_object(given)
        res["one_process_section_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, _ = run(cfg, local, toks_p, toks_d, decode[2], n_long, mesh, given)
        res["mesh_section_s"] = time.perf_counter() - t0
        for cell, (logits, secs, comms) in got.items():
            entry = {"rank_s": secs, "comm": comms}
            if first:
                entry["one_process_s"] = one[cell][1]
                entry["check"] = []
                for i, (g, w) in enumerate(zip(logits, one[cell][0])):
                    chk = argmax_check(g, w, tie, f"{dtype} {cell}[{i}]")
                    if rel is not None:
                        chk["bound"] = rel * float(w.abs().max())
                        if not chk["max_abs_diff"] <= chk["bound"]:
                            raise AssertionError(f"{dtype} {cell}[{i}]: logits differ beyond the bound: {chk}")
                    entry["check"].append(chk)
            res[cell] = entry
        if dev.type == "cuda":
            res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            torch.cuda.reset_peak_memory_stats(dev)
        return res

    # a fresh process's first meta tensor costs seconds: every rank
    # builds a bundle now, at once, rather than each in turn below
    t0 = time.perf_counter()
    steps.lm_prefill_bundle(get_arch(MESH_LM_ARCH).make_full(), ShapeSpec("prefill_32k", "prefill", {
        "global_batch": 1, "seq_len": 8}), mesh)
    out["meta_warmup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    f32 = MESH_LM_F32
    out["float32"] = cells(f32["depth"], torch.float32, f32["prefill"], f32["decode"], f32["long"],
                           MESH_LM_F32_TIE, MESH_LM_REL)
    out["float32"]["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["bf16"] = cells(MESH_LM_DEPTH, torch.bfloat16, MESH_LM_PREFILL, MESH_LM_DECODE, MESH_LM_LONG,
                        MESH_LM_TIE, None)
    out["bf16"]["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for name, spec, dtype in (("train_float32", MESH_LM_TRAIN_F32, torch.float32),
                              ("train_bf16", MESH_LM_TRAIN, torch.bfloat16)):
        t0 = time.perf_counter()
        out[name] = mesh_lm_train_cell(mesh, spec, dtype)
        out[name]["s"] = time.perf_counter() - t0
    every = [None] * mesh.size
    torch.distributed.all_gather_object(every, out)
    return every


def mesh_lm_path(dev, smi: str, t_start: float) -> None:
    """Phase 17c: LM serving and training across ``MESH_LM_RANKS`` ranks
    sharing the card over ``gloo`` (``mesh_lm_rank``, then
    ``mesh_lm_train_cell`` in the same ranks, so their start-up is paid
    once). Prints each cell's one-process and per-rank seconds, ``COMM``
    by kind (the ``all_to_all`` bytes apart, in training the backward's
    apart too) and staged bytes, the ranks' start-up and peak memory, the
    float32 checks and the bf16 checks with their margins, beside the
    card's name and power limit. The prefill, the batched decode and every
    train step (its backward too) must have sent ``all_to_all`` bytes on
    every rank, a train step exactly the reckoning's. No kernel of the repo
    runs here."""
    import torch

    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_ranks(mesh_lm_rank, MESH_LM_RANKS, smi, device=dev, timeout=300)
    for r in ranks:
        for part in ("float32", "bf16"):
            sent = {cell: sum(c["all_to_all_bytes"] for c in r[part][cell]["comm"]) for cell in ("prefill", "decode")}
            if min(sent.values()) <= 0:
                raise AssertionError(f"rank {r['rank']} of mesh_lm ({part}) sent no all_to_all bytes: {sent}")
        for part in ("train_float32", "train_bf16"):
            if min(step["comm"]["all_to_all_grad_bytes"] for step in r[part]["rank_steps"]) <= 0:
                raise AssertionError(f"rank {r['rank']} of mesh_lm ({part}) sent no all_to_all bytes in a backward")
    emit({"phase": "mesh_lm", "card": smi, "arch": MESH_LM_ARCH, "depth": MESH_LM_DEPTH, "ranks": MESH_LM_RANKS,
          "mesh": {"data": 1, "model": MESH_LM_RANKS}, "backend": ranks[0]["backend"],
          "sizes": {"prefill": MESH_LM_PREFILL, "decode": MESH_LM_DECODE, "long": MESH_LM_LONG,
                    "float32": MESH_LM_F32, "train_bf16": MESH_LM_TRAIN, "train_float32": MESH_LM_TRAIN_F32},
          "per_rank": ranks, "phase_s": time.perf_counter() - t_phase, "elapsed_s": time.perf_counter() - t_start})


#: the examples and the arguments the smoke gives them: the distributed
#: example's 1,000 rows (from 8,000, then 2,000; its program runs at the
#: paper's width in phase 16 (a); PERF.md §4) in two segments on two ranks
EXAMPLES = (("torch_quickstart", []), ("torch_distributed_build", ["--seg-size", "250", "--ranks", "2"]),
            ("torch_retrieval_serving", []))


def examples_path(dev, t_start: float) -> dict:
    """Phase 18: the three examples' ``main()`` on the card with
    ``EXAMPLES``' arguments (their printed lines above this one), each
    timed; their recall lines come back as their returned dicts. Returns
    the launches of all three, the distributed example's ranks' included."""
    import torch

    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    out = {}
    for name, argv in EXAMPLES:
        t0 = time.perf_counter()
        res = load_example(name).main(argv)
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0, **res}
    launches = dict(ops.launches)
    for res in out.values():  # what the example's ranks launched
        for k, v in res.get("rank_launches", {}).items():
            launches[k] += v
    for name in ("flash_round", "flash_beam", "l2_batch", "flash_scan"):
        if launches[name] == 0:
            raise AssertionError(f"the examples never launched {name}")
    emit({"phase": "examples", **out, "launches": launches, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # The repo's scalability setting is 1M vectors in 64 segments. Both paths
    # at 1M ran 1,119 s and 1,151 s of the 1,200 s limit on the H100, so the
    # rows were cut to 500k, and to 400k when the GNN phase brought the run
    # to 1,173.7 s; then to 200k, with the scale-out path on its first 100k
    # rows, when the flash-ann phase (its 2 x 100,000 x 768 segments) came;
    # then to 100k, the scale-out path on its first 50k, to keep the whole run
    # near half its limit; the 64 segments are kept (PERF.md records every cut).
    ap.add_argument("--n", type=int, default=100_000,
                    help="base rows of the main path (the scalability setting: 1M)")
    ap.add_argument("--n-inc", type=int, default=N_INC,
                    help="rows of the incremental build (phase 6)")
    ap.add_argument("--n-base", type=int, default=N_BASE,
                    help="rows of the baselines and generality phases (7b, 7c)")
    ap.add_argument("--ann-inc", type=int, default=ANN_INC,
                    help="rows a segment of the flash-ann phase's incremental build, part (a)")
    args = ap.parse_args()
    n = args.n

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.data.synthetic import vector_dataset
    from repro_torch.graph.engine import PHASE_NAMES, BuildParams
    from repro_torch.index import AnnIndex, exact_knn
    from repro_torch.kernels import build, ops
    from repro_torch.testing.scan import code_scan_recall

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device + kernel build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build_s = build.build_all()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in build.PTXAS_LOG.items()
    }
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

    # ---- 2. kernels vs plain at the path's shapes ---------------------------
    kern = check_kernels(dev, n)
    emit({"phase": "kernels", **kern})

    # ---- 3. build ----------------------------------------------------------
    t0 = time.perf_counter()
    allx = vector_dataset(0, n=n + QUERIES, d=128, n_clusters=64)
    base_np, q_np = allx[:n], allx[n:]
    data = torch.from_numpy(base_np).to(dev)
    queries = torch.from_numpy(q_np).to(dev)
    data_s = time.perf_counter() - t0
    params = BuildParams()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = AnnIndex.build(
        data, algo="hnsw", backend="flash_blocked", strategy="bulk", params=params,
        backend_kwargs=dict(d_f=64, m_f=16, l_f=4, h=8), device="cuda",
    )
    torch.cuda.synchronize()
    build_wall = time.perf_counter() - t0
    st = index.last_stats
    build_launches = dict(ops.launches)
    emit({"phase": "build", "n": n, "d": 128, "data_gen_s": data_s, "build_s": build_wall,
          "seconds": st.seconds, "n_dists": st.n_dists, "n_dists_by_phase": dict(zip(PHASE_NAMES, st.phases)),
          "n_hops": st.n_hops, "repair_unreachable": st.repair_unreachable, "launches": build_launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for name in ("flash_round", "flash_beam"):  # flash_beam: the repair's inserts
        if build_launches[name] == 0:
            raise AssertionError(f"the build never launched {name}")
    adj0 = index.graph.adj0
    if not bool(((adj0 >= -1) & (adj0 < n)).all()):
        raise AssertionError("adjacency ids out of range")

    # ---- 4. search ---------------------------------------------------------
    t0 = time.perf_counter()
    gt_i32, gt_d = exact_knn(queries, data, k=10)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    gt_l2 = ops.launches["l2_batch"] - build_launches["l2_batch"]
    gt = gt_i32.long()
    gt_check = knn_cross_check(gt, gt_d, data, queries)
    results = []
    fused_ids = {}
    for ef in (64, 256):
        for width in (1, 4):
            before = dict(ops.launches)
            index.search(queries[:32], k=10, ef=ef, width=width)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = index.search(queries, k=10, ef=ef, width=width)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if not bool(torch.isfinite(res.dists).all()) or tuple(res.ids.shape) != (QUERIES, 10):
                raise AssertionError(f"search ef={ef} width={width}: malformed result")
            rec = recall_at(res.ids, gt)
            results.append({"ef": ef, "width": width, "qps": QUERIES / dt, "seconds": dt,
                            "recall@10": rec, "n_scan": res.n_scan, "n_rerank": res.n_rerank,
                            "flash_beam_launches": ops.launches["flash_beam"] - before["flash_beam"]})
            fused_ids[(ef, width)] = res.ids
    for width in (1, 4):
        res_u = index.search(queries, k=10, ef=64, width=width, fused=False)
        if not torch.equal(res_u.ids, fused_ids[(64, width)]):
            raise AssertionError(f"unfused search (ef=64, width={width}) returned other ids than the fused one")
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    for name in ("flash_round", "flash_beam", "flash_scan_blocked", "l2_batch"):
        if launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    if launches["mirror_bytes"] or launches["mirror_words"] != launches["flash_beam"]:
        raise AssertionError("the main path's coder (M = 16) left the 8-byte word layout")
    # where the device time goes in one search and in the ground truth
    # (after the counts were read)
    gt_split = time_split(lambda: exact_knn(queries, data, k=10), "l2_batch_kernel")
    windows = {
        "flash_beam": device_window(lambda: index.search(queries, k=10, ef=64, width=1)),
        "step_loop": device_window(lambda: index.search(queries, k=10, ef=64, width=1, fused=False)),
    }
    # the sanity floor (scan_gate): the search at ef=256 against a scan of
    # the same codes keeping 256 candidates
    scan_rec = code_scan_recall(index.backend, index.data, queries, gt, 256)
    best = max(r["recall@10"] for r in results if r["ef"] == 256)
    emit({"phase": "search", "queries": QUERIES, "k": 10, "results": results,
          "exhaustive_scan_256_recall@10": scan_rec, "unfused_equals_fused": True,
          "ground_truth_s": gt_s, "ground_truth_cross_check": gt_check, "ground_truth_split": gt_split,
          "profile_ef64_w1": windows, "launches": launches, "elapsed_s": time.perf_counter() - t_start})
    scan_gate("the main path's search at ef=256", best, scan_rec)

    spill = os.path.join(root, "build", "chip_smoke_spill")
    shutil.rmtree(spill, ignore_errors=True)
    try:
        # ---- 5. small-input checks against the CPU path ---------------------
        check = small_input_checks(dev, index, queries, plain_knn)
        check.update(segmented_check(base_np, q_np, os.path.join(spill, "check")))
        check.update(card_against_cpu_builds(dev, index.data))
        emit({"phase": "check", **check, "elapsed_s": time.perf_counter() - t_start})

        # ---- 6. the incremental build ---------------------------------------
        inc_launches, bulk_launches, inc_gt_l2 = incremental_path(dev, base_np, queries, args.n_inc, t_start)
        for name in ("flash_beam", "l2_batch"):
            if inc_launches[name] == 0:
                raise AssertionError(f"the incremental path never launched {name}")
        for name in ("flash_beam", "flash_round"):
            if bulk_launches[name] == 0:
                raise AssertionError(f"the bulk build beside the incremental path never launched {name}")

        # ---- 7. snapshot files and the sharded pool -------------------------
        snap_launches = snapshot_path(index, base_np, queries, spill, t_start)
        for name in ("flash_beam", "flash_round", "l2_batch"):
            if snap_launches[name] == 0:
                raise AssertionError(f"the snapshot path never launched {name}")

        # ---- 7d. the serving runtime over the live index --------------------
        serve_launches = serving_path(index, base_np, q_np, queries, spill, t_start)
        del index, data

        # ---- 7b. the baseline backends, 7c. the flat graphs -----------------
        ops.reset_launches()
        base_launches, base_gt_l2 = baselines_path(dev, base_np, queries, args.n_base, t_start)
        ops.reset_launches()
        gen_launches = generality_path(dev, base_np, queries, args.n_base, t_start)

        # ---- 8.–10. the scale-out path --------------------------------------
        scale_launches, l2_uses, coll, gt_live = scale_out_path(base_np[:min(N_SCALE, n)], queries,
                                                                spill, t_start)
        # ---- 10b. the serving router over the scale-out collection ----------
        router_launches = serving_router(coll, queries, gt_live, t_start)
        del coll
        serve_launches = {k: serve_launches[k] + router_launches[k] for k in serve_launches}
        for name in ("flash_beam", "l2_batch"):
            if serve_launches[name] == 0:
                raise AssertionError(f"the serving path never launched {name}")
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    # l2_batch's launches, split by what called it: the assignments (the
    # scale-out path's and the pool's plan), routed add, and the ground
    # truths that score the main, scale-out and incremental paths
    l2_uses["ground_truth"] += gt_l2 + inc_gt_l2 + base_gt_l2 + gen_launches["l2_batch"]
    l2_uses["assignment"] += snap_launches["l2_batch"]
    l2_uses["serving"] = serve_launches["l2_batch"]

    # ---- 11. the retrieval path ------------------------------------------------
    retrieval_launches = retrieval_path(dev, t_start)

    # ---- 12. the training path, then serving from its checkpoint -------------
    train_launches = training_path(dev, t_start)

    # ---- 13. the LM family serving prefill and decode ------------------------
    lm_serving_path(dev, t_start)

    # ---- 14. the LM family training -------------------------------------------
    lm_training_path(dev, t_start)

    # ---- 15. the GNN family training, and the example's kNN graph -------------
    gnn_launches = gnn_training_path(dev, t_start)
    l2_uses["gnn_example"] = gnn_launches["l2_batch"]

    # ---- 16. the paper's own workload: flash-ann's two cells ------------------
    handover = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    try:
        ann_ref_launches, ann_launches = flash_ann_path(dev, args.ann_inc, t_start, handover)
        l2_uses["flash_ann"] = ann_ref_launches["l2_batch"] + ann_launches["l2_batch"]

        # ---- 16b. the same programs across ranks -------------------------------
        mesh_launches = mesh_path(dev, handover, base_np[:MESH_RANKS * MESH_ROWS], q_np, t_start)
        l2_uses["mesh"] = mesh_launches["l2_batch"]
    finally:
        shutil.rmtree(handover, ignore_errors=True)

    # ---- 17. BERT4Rec's serving cells through launch/steps --------------------
    cell_launches = recsys_cells_path(dev, t_start)

    # ---- 17b. the recsys and GNN step bundles across ranks ----------------------
    mesh_step_launches = mesh_steps_path(dev, smi, t_start)

    # ---- 17c. LM serving and training across ranks -----------------------------
    mesh_lm_path(dev, smi, t_start)

    # ---- 18. the examples -------------------------------------------------------
    ex_launches = examples_path(dev, t_start)
    l2_uses["examples"] = ex_launches["l2_batch"]

    rows = []
    for name, key in (("flash_round", "flash_round"), ("flash_expand", "flash_expand_w4"),
                      ("flash_beam", "flash_beam_ef64_w1"),
                      ("flash_scan_blocked", "flash_scan_blocked_w4"), ("l2_batch", "l2_batch_gt"),
                      ("flash_scan", "flash_scan"), ("sq_l2", "sq_l2")):
        kr = kern[key]
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
                     "launches": (launches[name] + inc_launches[name] + bulk_launches[name] + snap_launches[name]
                                  + scale_launches[name] + retrieval_launches[name] + base_launches[name]
                                  + gen_launches[name] + serve_launches[name] + train_launches[name]
                                  + gnn_launches[name] + ann_ref_launches[name] + ann_launches[name]
                                  + mesh_launches[name] + cell_launches[name] + mesh_step_launches[name]
                                  + ex_launches[name]),
                     "max_abs_err": kr["max_abs_err"], "ms": kr["ms"],
                     "plain_ms": kr["plain_ms"], "bound_ms": kr["bound_ms"], "bound_by": kr["bound_by"],
                     "library_ms": kr["library_ms"], "shape": kr["shape"]})
        rows[-1].update({f: kr[f] for f in ("device_ms", "step_loop_ms", "workspace_bytes", "ms_warm",
                                            "bound_fp32_fma_ms", "library_call") if f in kr})
        if isinstance(kr.get("device_ms"), float):  # events minus device: the wrapper's host cost
            rows[-1]["host_us_per_call"] = (kr["ms"] - kr["device_ms"]) * 1e3
        if name == "l2_batch":
            rows[-1]["launches_by_use"] = l2_uses
            rows[-1]["assignment_shape"] = {f: kern["l2_batch_assign"][f] for f in (
                "shape", "max_abs_err", "ms", "ms_warm", "device_ms", "plain_ms", "bound_ms",
                "bound_fp32_fma_ms", "library_ms")}
            rows[-1]["d768"] = {f: kern["l2_batch_d768"][f] for f in (
                "shape", "max_abs_err", "atol", "top10_rows_differ", "top10_near_ties", "ms", "device_ms",
                "plain_ms", "bound_ms", "bound_by", "bound_fp32_fma_ms", "library_ms")}
        if name == "flash_beam":
            rows[-1]["launches_by_use"] = {"main_build": build_launches[name],
                                           "main_search": launches[name] - build_launches[name],
                                           "incremental": inc_launches[name],
                                           "incremental_bulk": bulk_launches[name], "snapshot": snap_launches[name],
                                           "scale_out": scale_launches[name], "baselines": base_launches[name],
                                           "generality": gen_launches[name], "serving": serve_launches[name],
                                           "flash_ann": ann_launches[name], "mesh": mesh_launches[name],
                                           "examples": ex_launches[name]}
            rows[-1]["w16_r96"] = kern["limits"]["flash_beam_w16_r96"]
            rows[-1]["flat_w4_r24"] = {key: kern["flat_shapes"][key] for key in (
                "flash_beam_w4_r24_search", "flash_beam_w4_r24_insert_batch")}
            rows[-1]["byte_layout_m8"] = kern["flash_beam_m8_bytes"]
            rows[-1]["byte_layout_m16"] = kern["flash_beam_ef64_w1"]["bytes_layout_same_inputs"]
        if name == "flash_round":
            rows[-1]["launches_by_use"] = {"main": launches[name], "incremental": inc_launches[name],
                                           "incremental_bulk": bulk_launches[name], "snapshot": snap_launches[name], "scale_out": scale_launches[name],
                                           "retrieval_graph": retrieval_launches[name],
                                           "baselines": base_launches[name], "generality": gen_launches[name],
                                           "serving": serve_launches[name], "gnn_example": gnn_launches[name],
                                           "flash_ann": ann_launches[name], "examples": ex_launches[name]}
            rows[-1]["table_64k"] = kern["limits"]["table_64k"]
        if name == "flash_scan":
            rows[-1]["launches_by_use"] = {"retrieval": retrieval_launches[name], "training": train_launches[name],
                                           "recsys_cells": cell_launches[name],
                                           "mesh_steps": mesh_step_launches[name], "examples": ex_launches[name]}
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
