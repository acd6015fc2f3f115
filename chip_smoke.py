#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``repro_torch`` only (never ``jax``, never ``repro``):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (ptxas' registers and spills printed; every line for the kernels
   that walk a union); count, in ``cuobjdump -sass`` of K5, K6, K9 and
   K10, the L1 invalidations (``CCTL.IVALL``), fences and load kinds:
   K6 and K10 must invalidate L1 at their grid barriers, since their
   walks read state rewritten between layers by plain loads;
3. kernels vs plain versions on the card, at the main path's shapes,
   with inputs captured from a real layer of the main path: the
   measure kernel (K13 redesigned) on every layer, both directions,
   bitwise against its plain version as captured, without the unvisited
   pair and by the count-only arm (counters, sums, total, mode, stats
   columns 0-4, depths), timed on the largest layer (calls queued back
   to back, `device_ms`; CUDA events around one call count the host's
   launch too) beside its bound, and at 33 roots at the main path's
   width on random words (bitwise, timed beside its bound); the union
   planner (not a TPU kernel) bitwise on every layer, as planned and
   with a dense root, and timed beside the planning it replaced;
   restoration and compaction (K2 on the layer's planning bitmap,
   printed as ``frontier_compact_planning``: the main path no longer
   runs K2, and K2's row is phase 10's) must match exactly; gather-expand, on
   the planner's plan, must give the same repaired ``out``/``visited``
   and marked set, and every mark must name a frontier neighbour; each
   kernel's median time (the plan built outside the timed window), its
   plain version's, and its bound.  The same on that layer for K4 (the
   prefetch ring, depths 1, 2, 4: K3's contract) and K5 (one layer in
   one launch, also on the largest layer of the other direction, at
   depths 0 and 2: n_active, ``out`` and the marked set bitwise, P restored, exactly
   one CUDA launch per call by the profiler; its co-resident grid
   printed), K9 the same on the autotuner's SELL layout of the graph
   (phase 3d: its largest ``fused_gather`` layer of each direction,
   where K8 is held to its plain version at depths 0 and 2, and the
   measure kernel on every layer),
   and for the planner, K2 and K3 at B = 1 from a ``run(root)``
   traversal;
4. main path: Graph500 R-MAT SCALE 22 / edgefactor 16 from ``--seed``,
   an all-auto plan (must resolve to BeamerHybrid + fused_gather), a
   batch of 8 roots with degree > 0, timed; one planner launch per
   layer and no call of the planning it replaced; the same traversal
   with that planning gives the same visited and frontier sets, depths,
   stats columns 0-7 and direction log; one measure launch per layer
   (and one that finds every frontier empty), no call of the plain
   counters or apportionment, and, traced (`profile_split`), no device
   time in plain-torch counters; every tree validated and its
   depths checked against an independent level-synchronous BFS;
5. the fusion paths at the same size — ``fused_gather`` at
   ``prefetch_depth=2`` (K4), ``megakernel`` at depth 0 and 2 (K5) and
   ``persistent`` (K6): each timed over 3 runs, trees valid, visited,
   frontier, depths, layers, stats columns 0-6 and the direction log
   equal to the main path's, the launches column as contracted, no
   degrade, no plain counters or apportionment, and by the profiler one
   K5 launch per layer and one K6
   launch per traversal; K6 against its plain version on the batch's
   initial state (frontier, visited, depths, layers, stats bitwise, P
   restored where the plain version's is), timed at 4 and 8 CTAs per
   SM in turns, its grid and state layout printed;
5a. K6's bottom-up walk (`phase_bottom_up_walk`, SCALE 16 with two hub
   components whose lists span at least 3 rows-blocks, one never
   reached by most roots): K6 under BeamerHybrid at 1, 8 and 40 roots,
   depths 0 and 1, against its plain version as in phase 5, and each
   bottom-up layer's neighbour entries tested over the slots walked
   from one traced launch (``bottom_up_walk_b<B>`` lines); alone:
   ``python3 -c "import chip_smoke as c; c.phase_bottom_up_walk(0)"``;
5b. SELL-C-σ at the same size: the autotuner must pick ``sell`` for the
   graph; ``formats.build(g, "auto")`` builds the layout on the card
   (slabs, fill, bytes, build seconds and peak memory printed); the
   SELL paths — ``fused_gather`` at depth 0 and 2 (K8 + K1),
   ``megakernel`` (K9) and ``persistent`` (K10) — each timed over 3
   runs, trees valid, visited, frontier, depths, layers, stats columns
   0-4 and 6 and the direction log equal to the CSR main path's, the
   launches column as contracted, no degrade, one K9 launch per layer
   and one K10 launch per traversal by the profiler; the
   ``fused_gather`` paths plan with one union-planner launch per layer
   and call none of the plain planning functions (``--profile``: the
   depth-0 one traced, one K8 launch per layer); K8 (depths 0, 1, 2, 4,
   on the layer's union plan) and K13 (the measure kernel's count-only
   arm, printed as ``popcount_sell_frontier``) against their plain
   versions on
   the largest captured SELL layer, with the planner on that layer
   beside the planning it replaced; K10 on the batch's initial state
   as K6;
6. the four direction policies at SCALE 16, batch 8, on every pipeline
   of CSR and of SELL (``materialized`` included);
6b. at SCALE 16 with 33 roots (two root-mask words): the measure
   kernel on every layer of CSR and SELL, the planner
   (both arms, every layer, with a dense root), K3 (and K4 at each
   depth), K5, K8 and K9 (both directions, depths 0 and 2),
   K11 and K12 (int32 and float32 layers), and K6 and K10 (the four
   policies, depths 0 and 2) against their plain versions on their
   contracts;
7. GPU vs the port's CPU path at SCALE 12 for CSR and SELL (the SELL
   layout built on the card equals the CPU build bitwise): visited,
   depths, the stats buffer and the direction log must be identical on
   every pipeline (``materialized`` included), and for the three
   portfolio algorithms values, parents, depths and the whole stats
   buffer;
8. the kernels' launch counts from their paths' runs (all > 0; the
   measure kernel runs every host-loop layer and termination test, its
   count-only arm (K13's ``popcount``) the sssp portfolio's counts);
9. (run right after 5b) the semiring portfolio at the main path's
   size, on CSR (K2 + K11) and on the autotuner's SELL layout (K12):
   ksource_bfs (the 8 roots) equals the level-synchronous depths; sssp
   (8 roots, max_layers 512) ends with an empty frontier and passes
   the optimality certificate on every edge; cc (one root) equals
   scipy's min-id components; CSR and SELL agree bitwise (values,
   parents, layers, stats columns 0-4); each timed over 3 runs, with
   one planner launch per layer and no plain planning; K11 and K12
   against their plain versions on the largest ksource_bfs (int32) and
   sssp (float32) layers, bitwise, at 8 roots and for the first root
   alone, beside one ``scatter_reduce_(amin)`` fold of the layer
   (phase 0 only); the planner's SELL arm timed on the ksource layer;
   every measure call of each warm-up run (ksource_bfs, sssp, cc; CSR
   and SELL) replayed against its plain version bitwise at the shape it
   took: the degree arm, sssp's ``discovered=False`` and its (24, W)
   count-only counts, whose largest gives K13's row;
10. (run after 9) the materialized pipeline at the main path's size,
   all-auto policy, on CSR (K2's stream arm + the apportionment + K7 +
   K1) and
   SELL (K8 over every slab group + K1): timed over 3 runs with the
   peak device memory, held to the main path as in phase 5 (stats
   columns 0-4), no edge truncated; K7 against its plain version on
   the largest captured layer of each direction and on a synthetic
   stream at that scale in each direction (``valid`` not a prefix of a
   row, a slot count that is not a multiple of 16, a hub's run longer
   than K7's 16-slot chunk), K3's contract; K2's stream arm and the
   apportionment against their plain versions on the largest layer of
   each direction (queue, counts, totals, truncated counts bitwise,
   ``cum`` on each root's entries, ``valid`` bitwise, ``u``/``v`` where
   valid) and on a synthetic layer whose stream is cut inside a hub's
   list, timed beside their bounds; the bottom-up layer's times give
   K2's and the apportionment's rows;
11. (run after 10) rule 3 at the main path's size: a. ``packed=False``
   on CSR ``fused_gather`` (depths 0 and 2), ``materialized``,
   ``megakernel`` and ``persistent`` and on SELL ``fused_gather``, each
   timed over 3 runs and held to the main path as in phase 5 (its
   launches column 2 per layer on the dense CSR ``fused_gather`` and
   ``materialized`` arms), no K2 and no planner launch on those two,
   the dense materialized path's peak memory, and the dense planning on
   every layer equal to the union planner's and timed beside it (device
   time per traversal, its peak memory); one more dense materialized
   run replays every call of K7, K1 and the apportionment through the
   kernel and its plain version on copies of its inputs, and holds
   every dense queue to K2's stream arm on the same words (`replayed`);
   b. `CompiledTraversal.layer_step`
   ticked from the initial state until every frontier is empty on
   ``fused_gather``, ``megakernel`` and ``persistent``: visited, frontier
   and the tick count equal the ``ThresholdSimd(0)`` traversal's, trees
   valid; c. on the first root, ``run_bfs`` (simd, nonsimd),
   ``run_bfs_jit``, ``run_bfs_vectorized`` (threshold, ``simd_layers``),
   ``run_bfs_hybrid`` (its log equal to the BeamerHybrid plan's),
   ``traverse`` and ``traverse_hostloop`` (ThresholdSimd, BeamerHybrid;
   per-layer frontier, edges and discovered equal to the traversal's
   stats columns 0-2), each tree valid with the oracle's depths, each
   wall printed, and each warm-up run under `replayed` (the hostloop's
   K7 at B = 1 on its pow2 buckets, K1 on one root's P, the
   apportionment on its dense queues), as many replayed calls as the
   timed run launched; d. at SCALE 16, ``plan(EdgeList)`` equal to
   ``plan(from_edges(...))`` and ``persistent`` under a subclass of
   ThresholdSimd recording exactly one ``pipeline_unsupported`` degrade
   and equal to the megakernel's run;
12. (run after 11) the port's serve tier, observability and Graph500
   harness on the main path's graph (`configs.bfs_graph500`
   ``rmat-22``): a. `core.stats.run_harness` over 64 roots from
   ``--seed``, unfiltered and degree > 0, with the main path's plan
   ``run(root)``: every run valid against the level-synchronous BFS,
   the zero-edge runs exactly the degree-0 roots, a ``graph500`` JSON
   line per draw (harmonic-mean and max TEPS, zero runs, mean seconds);
   b. `serve.graph_engine.GraphEngine` (CSR, `SERVE.batch_slots`
   slots) answering the 64 connected roots: every tree valid with the
   oracle's depths, per tick one planner call, K3, K1 and one measure
   count launch (counted, and by the profiler over three ticks), no
   plain counter; latency and tick percentiles, the harvest copy and
   the per-tick state snapshot timed; the same queries on the
   autotuner's SELL layout; a chaos run (two failed ticks, a stall,
   two poisoned slots) delivering every query exactly once and none
   corrupted, with the counters as injected; retry exhaustion
   re-queuing and raising `TickRetriesExhausted`; the portfolio
   queries equal to phase 9's results bitwise; c. `trace_run` on the
   main path's plan and roots: per-layer frontier, edges and discovered
   equal to the ThresholdSimd(0) traversal of phase 11b, one span per
   layer, one measure launch per layer + 1 and no plain counter, the
   Chrome JSON parsed, `torch_profiler`'s trace naming K3, and the
   persistent branch one span whose stats equal ``run_batched``'s;
13. (run after 12) the distributed 1-D BFS (`core.bfs_distributed`):
   b. one rank over NCCL (``init_process_group("nccl", init_method=
   "file://...")``, a ``(1,)`` CUDA mesh) on the main path's graph and
   8 roots, every merge (allreduce, owner, packed) through
   ``plan(g, spec, mesh=mesh).run(root)``: every tree valid with the
   oracle's depths, ``layers == max depth + 1``, the three merges'
   parents bitwise equal, `run_bfs_distributed` equal to the plan, no
   call of the plain rowsweep; the partition seconds, each root's wall
   to a sync, one counted run (one rowsweep launch per layer, one
   launch of the measure kernel's count arm per layer + 1) and one
   profiled root (idle share, largest device items); a. the rowsweep
   kernel against its plain version, bitwise, on every shard of the
   graph partitioned at D = 1, 2 and 4 (the host partition only;
   rebased shards, base > 0),
   on the frontier and visited words of 13b's largest top-down layer,
   timed (events, then back to back) beside its bound, bytes printed;
   c. two spawned ranks over gloo, both on cuda:0, on a SCALE-16 graph:
   each merge's parents and layer counts equal the one-rank run's;
14. (run after 7) the LM serve path (`models/*`, `serve/engine.py`; no
   kernel of its own, plain torch): a. each of the 10 archs of
   `configs.registry` at ``reduced()`` in float32, TF32 off: the same
   weights on the card and on the CPU give the same forward logits,
   prefill logits and 3 decode steps' logits (`LM_PARITY_TOL`, one
   ``lm_parity`` line each); b. ``qwen3-14b`` at its published widths
   and all 40 layers, bf16 weights initialised on the card from
   ``--seed``: `ServeEngine` with 4 slots and a 256-token cache serves 8
   requests (prompts of 8-64 tokens and 16 generated, drawn from the
   seed); every request ends with 16 tokens from finite logits; the
   ``lm_serve`` line gives init seconds, peak memory, ticks, wall,
   tokens/s, tick p50/p99 and the tick's bound; three ticks profiled
   (idle share); a request served at one slot after another equals a
   standalone greedy decode on the card token for token; c. its widths
   at 2 layers in float32: decode logits equal forward logits at every
   position (B = 2, T = 32, `LM_EXACT_TOL`);
15. (run after 14, its weights freed) the LM training path
   (`train/*`, `data/tokens.py`, `checkpoint/ckpt.py`,
   `runtime/fault.py`; no kernel of its own, plain torch): a. each of
   the 10 archs at ``reduced()`` in float32, TF32 off, under both
   optimizer arms: one `make_train_step` step on the card equals the
   port's CPU step of the same weights and batch (loss, grad norm,
   every parameter; `TRAIN_PARITY_TOL`, one ``lm_train_parity`` line
   each); b. ``h2o-danube-1.8b`` at its published widths and all 24
   layers, fp32 master weights initialised on the card from ``--seed``,
   bf16 compute, remat on: `runtime.fault.train_loop` over
   `data.tokens.stream` (seq_len 4096, global batch 8 in 4 micro-batches)
   for 5 steps with fp32 AdamW, then 5 with the 8-bit arm from fresh
   weights and state; every loss finite, the mean of the last two below
   that of the first two in each arm, every tensor on the card; the
   ``lm_train`` line per arm gives init seconds, peak memory, step time
   p50 and max, tokens/s, model FLOPs per step and ``mfu``; one more
   fp32 step profiled (busy ms, idle share, largest device items); c.
   the fault-tolerant loop on the card at ``test_train_substrate.py``'s
   tiny config: checkpoints every 2 steps (keep 2), failures injected
   at steps 3 and 7: 2 restarts, every step reached, the losses after
   each restore equal to an uninterrupted run's (`TRAIN_LOOP_RTOL`).
16. (run after 15) the sharding and launch slice (`models/sharding.py`,
   `launch/mesh.py`, `launch/staging.py`, `train/optimizer.py`'s
   DTensor arm and `zero1_specs`, re-sharding checkpoints; no kernel of
   its own): `MESH_RANKS` spawned gloo ranks share cuda:0 (DTensor's
   collectives staged through host memory, `launch.staging`).  a. the
   reference's ``test_multidevice_train.py`` config (qwen3 reduced,
   float32, 2 layers, 4/2 heads, batch 4, seq 32, `MESH_ADAMW`): three
   steps on a (2 data x 4 model) mesh and the same run with ZeRO-1
   moments give the one-rank card run's losses (`MESH_RTOL`,
   `MESH_ATOL`); a checkpoint saved there restores bitwise onto a (4 x
   2) mesh and one more step is finite; one ``lm_mesh_contracts`` line;
   b. `MESH_FULL_ARCH` at its published widths cut to
   `MESH_FULL_LAYERS` layers, phase 15's recipe, on a (2 x 2) mesh with
   ``param_specs(model_divisor=2)`` and ZeRO-1 moments, global batch
   `MESH_FULL_BATCH`, `MESH_FULL_STEPS` steps: losses finite and within
   `MESH_FULL_RTOL` of a one-rank card run of the same cut (run first,
   freed before the spawn); the ``lm_train_mesh`` line gives the card's
   name and power limit, layers kept, step seconds, tokens/s, peak
   memory per rank, the `CommDebugMode` collective counts of a step by
   kind and the bytes and seconds staged through the host.  A rank that fails, or
   a CUDA mesh that cannot be built, fails the phase.
17. (run after 16) the roofline and the dry run (`roofline/*`,
   `launch/dryrun.py`, `obs.cost_drift.measure_drift`, the 8-bit arm on
   a mesh; no kernel of its own): a. phase 15's one-rank fp32 step of
   `TRAIN_ARCH` at full width, analysed (`roofline.hlo_analyze`) once on
   the card and once on meta tensors on the host: flops, bytes and op
   counts equal; the ``roofline_step`` line gives the predicted peak
   beside ``torch.cuda.max_memory_allocated``, the roofline terms at the
   H100's constants, a timed step against ``t_bound`` and the mfu
   (`model_flops`, through `roofline.analysis.model_flops_for`); b.
   ``python -m repro_torch.launch.dryrun`` as a child per cell of
   `DRYRUN_CELLS` (qwen3-14b's decode on a fake 256-rank mesh, the
   distributed BFS on rmat-22 with the rowsweep on the card): ``status``
   ok, one ``dryrun`` line each with the per-rank terms; c.
   `measure_drift` on the main path's graph (CSR ``fused_gather`` and
   ``materialized``, SELL ``fused_gather``; one ``drift`` line each),
   and the same rows on the card and on the CPU at SCALE 12; d. the
   8-bit arm on 16a's config and meshes (`MESH_RANKS` gloo ranks on
   cuda:0), q and v under `zero1_specs` and the scales under
   `optimizer.qs_specs`: losses within `MESH_RTOL`, `MESH_ATOL` of the
   one-rank 8-bit card run, and the gathered parameters and state
   within `GATE_8BIT` of that run's, which the one-rank fp32 run's state
   fails (one ``lm_mesh_8bit`` line).
18. (run after 12) the affinity table (`formats.affinity`, its rows
   ``formats/affinity_table.json`` swept on the card by
   ``tools/sweep_affinity.py``; no kernel of its own).  Phases 1-17 run
   with the table set aside (`affinity.table_at(None)`: every auto knob
   at its built-in default, the paths they held before the table), and
   name the knobs where they plan a spec of their own
   (`BUILTIN_KNOBS`).  On the main path's graph (phase 2's roots) and
   on the reference sweep's `TORUS_SIDE` x `TORUS_SIDE` torus: a. the
   geometry class on the card equals that of a CPU copy; b. the
   all-auto ``TraversalSpec()`` resolves field by field to the table's
   lowest rows (`table_choices`, read from the file as written), on CSR
   and on ``SellFormat.from_csr`` with the table's σ; c. its batch
   equals the ``fused_gather`` depth-0 plan of the same layout and tile
   (visited, depths, direction log, stats columns 0-6; column 5 only on
   non-scalar layers under CSR ``persistent``, whose scalar layers
   report their planned blocks), trees valid, no degrade; d. the profiler lists the kernels of its pipeline
   (`PIPELINE_KERNELS`) and none that marks another; one
   ``affinity_wall`` line per resolved plan with its wall beside the
   ``fused_gather`` depth-0 wall on the same roots and the card's name
   and power limit (a record, not a claim).

The ``kernels`` line names each row's timing ``method``: ``events``
(the median of CUDA events around one call) or ``back_to_back``
(`device_ms`, with ``event_ms`` beside it for ranking against the
others).

Any failure raises and exits non-zero.  Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--scale 22] [--profile]
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.bfs_graph500 import GRAPHS, SERVE  # noqa: E402
from repro_torch.obs.trace import CALL_RANGES  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
#: the main path's workload: Graph500 R-MAT SCALE 22, edgefactor 16
MAIN = GRAPHS["rmat-22"]
BATCH = SERVE.batch_slots     # 8 roots per traversal and serve slots
REPLACES = {
    "restoration": "src/repro/kernels/restoration.py:65",
    "frontier_compact_batched": "src/repro/kernels/compact.py:211",
    "gather_expand_batched": "src/repro/kernels/gather_expand.py:565",
    "gather_expand_prefetch": "src/repro/kernels/gather_expand.py:565",
    "layer_fused_batched": "src/repro/kernels/layer_fused.py:308",
    "traversal_fused_batched": "src/repro/kernels/traversal_fused.py:457",
    "sell_expand_batched": "src/repro/kernels/sell_expand.py:402",
    "sell_expand_prefetch": "src/repro/kernels/sell_expand.py:402",
    "sell_layer_fused_batched": "src/repro/kernels/sell_expand.py:647",
    "sell_traversal_fused_batched":
        "src/repro/kernels/traversal_fused.py:519",
    "popcount": "src/repro/kernels/bitmap_kernels.py:39",
    "measure": "src/repro/kernels/bitmap_kernels.py:39 (K13) and the "
               "Table-1 counters around it (src/repro/core/engine.py:1038 "
               "bfs.measure_decide)",
    "frontier_expand_batched": "src/repro/kernels/frontier_expand.py:207",
    "gather_relax_batched": "src/repro/kernels/gather_expand.py:493",
    "sell_relax_batched": "src/repro/kernels/sell_expand.py:766",
    "plan_union": "not a TPU kernel: the planning around the kernels "
                  "(src/repro/core/engine.py:447 plan_active_tiles_batched)",
    "apportion": "not a TPU kernel: the materialized stream's "
                 "apportionment (src/repro/core/engine.py:269 apportion)",
    "rowsweep": "not a TPU kernel: the distributed step "
                "(src/repro/core/engine.py:334 rowsweep_stream + "
                "src/repro/core/engine.py:478 candidate_scatter, jnp; "
                "src/repro/core/bfs_distributed.py:104 _local_step)",
}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "restoration": CSRC + "restoration.cu",
    "frontier_compact_batched": CSRC + "compact.cu",
    "gather_expand_batched": CSRC + "gather_expand.cu",
    "gather_expand_prefetch": CSRC + "gather_expand.cu",
    "layer_fused_batched": CSRC + "layer_fused.cu",
    "traversal_fused_batched": CSRC + "traversal_fused.cu",
    "sell_expand_batched": CSRC + "sell_expand.cu",
    "sell_expand_prefetch": CSRC + "sell_expand.cu",
    "sell_layer_fused_batched": CSRC + "sell_layer_fused.cu",
    "sell_traversal_fused_batched": CSRC + "sell_traversal_fused.cu",
    "popcount": CSRC + "measure.cu",
    "measure": CSRC + "measure.cu",
    "frontier_expand_batched": CSRC + "frontier_expand.cu",
    "gather_relax_batched": CSRC + "gather_relax.cu",
    "sell_relax_batched": CSRC + "sell_relax.cu",
    "plan_union": CSRC + "plan_union.cu",
    "apportion": CSRC + "apportion.cu",
    "rowsweep": CSRC + "rowsweep.cu",
}
#: how the work-listed kernels are timed
KERNEL_ONLY = "kernel alone; its plan is built outside the timed window"
#: each kernel row's ``method``: the median of CUDA events around one
#: call (`cuda_ms`, the default), or the device time of calls queued
#: back to back (`device_ms`, for kernels of a few microseconds, where
#: events around one call measure the host's launch); rows of one method
#: rank against each other, and every back-to-back row also has its
#: ``event_ms``
EVENTS, BACK_TO_BACK = "events", "back_to_back"
#: the plain planning functions the union planner replaced: the main
#: path and the portfolio must call none of them
PLAIN_PLANNING = (("repro_torch.core.engine", "plan_active_tiles_batched"),
                  ("repro_torch.core.engine", "mark_blocks_from_queue"),
                  ("repro_torch.kernels.gather_expand", "union_worklist"),
                  ("repro_torch.kernels.sell_expand", "plan_slabs_plain"))
#: the plain-torch counters and apportionment the measure kernel and the
#: apportionment kernel replaced: no path on the card may call them
PLAIN_COUNTERS = (("repro_torch.kernels.bitmap_kernels", "measure_plain"),
                  ("repro_torch.kernels.traversal_fused", "layer_counters"),
                  ("repro_torch.core.bitmap", "masked_degree_sum"),
                  ("repro_torch.kernels.apportion", "apportion_plain"))
#: phase 13: the distributed BFS's merges; the shard counts the
#: rowsweep kernel is held at on the main path's graph (13a); the ranks
#: that share the one card over gloo and their graph's scale (13c)
DIST_MERGES = ("allreduce", "owner", "packed")
DIST_SHARDS = (1, 2, 4)
DIST_RANKS, DIST_SCALE = 2, 16
#: the plain rowsweep the kernel replaced: no run on the card may call it
PLAIN_ROWSWEEP = (("repro_torch.core.engine", "rowsweep_stream"),
                  ("repro_torch.core.engine", "candidate_scatter"),
                  ("repro_torch.kernels.rowsweep", "rowsweep_plain"))
#: phase 14: the LM serve path.  14a holds every reduced arch (float32)
#: on the card to the port's CPU run of the same weights; 14b serves
#: `LM_ARCH` at its published widths and depth in bf16 weights; 14c
#: holds decode to forward at those widths with `LM_EXACT_LAYERS`
#: layers in float32
LM_ARCH = "qwen3-14b"
LM_PARITY_TOL = 1e-3          # 14a: rtol = atol, GPU vs CPU in float32
LM_SLOTS, LM_CACHE, LM_REQUESTS, LM_MAX_TOKENS = 4, 256, 8, 16
LM_PROMPT = (8, 64)           # prompt lengths drawn in [8, 64]
LM_EXACT_LAYERS, LM_EXACT_T, LM_EXACT_TOL = 2, 32, 2e-3
#: phase 15: the LM training path.  15a holds one train step of every
#: reduced arch (float32, both optimizer arms) on the card to the port's
#: CPU step; 15b trains `TRAIN_ARCH` at its published widths and depth
#: (fp32 master weights, bf16 compute, remat) on the reference's
#: train_4k sequence length, global batch cut from 256 to `TRAIN_BATCH`
#: for one card; 15c runs the fault-tolerant loop on the card at the
#: reference test's tiny config
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_SEQ = 4096              # repro/configs/registry.py train_4k
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 8, 4, 5
TRAIN_ADAMW = dict(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
TRAIN_PARITY_TOL = 1e-3       # 15a: rtol = atol, GPU vs CPU in float32
TRAIN_LOOP_RTOL = 1e-5        # 15c: losses after a restore, relative
#: phase 16: the sharding and launch slice.  16a holds the reference's
#: mesh contracts (``tests/test_multidevice_train.py``: its config,
#: `MESH_ADAMW`, its tolerances) with `MESH_RANKS` gloo ranks on cuda:0
#: against a one-rank card run; 16b trains `MESH_FULL_ARCH` at its
#: published widths on a `MESH_FULL_SHAPE` mesh of ranks sharing the
#: card, depth cut to `MESH_FULL_LAYERS` (four ranks' weights, gradients
#: and AdamW state on one 80 GB card; PERF.md section 4 gives the cut),
#: held to a one-rank run of the same cut within `MESH_FULL_RTOL`; each
#: spawn has its deadline
MESH_RANKS, MESH_SHAPES = 8, ((2, 4), (4, 2))
MESH_ADAMW = dict(lr=1e-3, warmup_steps=0)
MESH_RTOL, MESH_ATOL = 2e-4, 2e-5
#: 17d's state gate (`optimizer.gap_8bit` against the one-rank 8-bit
#: run): q within one level on at most a 1e-3 share of entries, scales
#: to fp32 rounding, v and the parameters (1e-5) off on at most a 1e-3
#: share.  Another reduction order moves a few values of m across a
#: rounding boundary; the fp32 arm's state is off on 2-54 % of entries.
GATE_8BIT = {"q_levels": 1, "q_share": 1e-3, "s_rel": 1e-5,
             "v_share": 1e-3, "p_share": 1e-3}
MESH_FULL_ARCH = TRAIN_ARCH
MESH_FULL_SHAPE, MESH_FULL_LAYERS = (2, 2), 20
MESH_FULL_BATCH, MESH_FULL_STEPS = 4, 3
MESH_FULL_RTOL = 1e-3
MESH_DEADLINE_S, MESH_FULL_DEADLINE_S = 300, 480
#: H100 SXM dense bf16 peak (NVIDIA data sheet), the denominator of mfu
BF16_PEAK_FLOPS = 989.4e12
#: phase 17b: the dry run's cells (CLI arguments) and each child's
#: deadline in seconds
DRYRUN_CELLS = (
    (["--arch", "qwen3-14b", "--shape", "decode_32k", "--mesh", "single"],
     120),
    (["--bfs", "--bfs-graph", "rmat-22", "--mesh", "single"], 120),
)
#: phase 17c: the pipelines `measure_drift` runs per format
DRIFT_PIPELINES = {"csr": ("fused_gather", "materialized"),
                   "sell": ("fused_gather",)}
#: the fusion paths of phase 5 (TraversalSpec fields) and the kernel
#: each must launch
PATHS = {
    "fused_gather_d2": (dict(prefetch_depth=2), "gather_expand_prefetch"),
    "megakernel": (dict(pipeline="megakernel"), "layer_fused_batched"),
    "megakernel_d2": (dict(pipeline="megakernel", prefetch_depth=2),
                      "layer_fused_batched"),
    "persistent": (dict(pipeline="persistent"), "traversal_fused_batched"),
}
#: the SELL paths of phase 5b: (TraversalSpec fields, the kernels each
#: must launch, its launches column per layer)
SELL_PATHS = {
    "sell_fused_gather": (dict(), ("sell_expand_batched", "restoration"),
                          2),
    "sell_fused_gather_d2": (dict(prefetch_depth=2),
                             ("sell_expand_prefetch",), 2),
    "sell_megakernel": (dict(pipeline="megakernel"),
                        ("sell_layer_fused_batched",), 1),
    "sell_persistent": (dict(pipeline="persistent"),
                        ("sell_traversal_fused_batched",), 0),
}
PREFETCH_DEPTHS = (1, 2, 4)
#: the knobs the phases before 18 name where they plan a spec of their
#: own: the built-in defaults (phases 1-17 run with the affinity table
#: set aside, `affinity.table_at(None)`, so that the entry points that
#: resolve an auto spec inside, the serve tier, the harness and the
#: legacy shims, keep their paths too; phase 18 reads the table)
BUILTIN_KNOBS = dict(pipeline="fused_gather", prefetch_depth=0)
BUILTIN_CSR_TILE = 1024       # csr_format.DEFAULT_TILE
#: phase 18: the reference sweep's uniform torus (class skew1)
TORUS_SIDE = 64
#: phase 18: the kernels (device names, as the profiler gives them) a
#: resolved plan must launch, by format and pipeline, and the kernels
#: that mark the other pipelines
PIPELINE_KERNELS = {
    ("csr", "persistent"): ("traversal_fused_kernel",),
    ("csr", "megakernel"): ("layer_fused_kernel",),
    ("csr", "fused_gather"): ("gather_expand_kernel", "restoration_kernel",
                              "plan_masks_csr", "measure_kernel"),
    ("sell", "persistent"): ("sell_traversal_fused_kernel",),
    ("sell", "megakernel"): ("sell_layer_fused_kernel",),
    ("sell", "fused_gather"): ("sell_expand_kernel", "restoration_kernel",
                               "plan_masks_sell", "measure_kernel"),
}
#: the build-log entries printed whole (every ptxas line, kernel names
#: included): the kernels that walk the union of the lists, and the
#: planner that builds it
UNION_SOURCES = ("== gather_expand.cu", "== gather_relax.cu",
                 "== sell_expand.cu", "== sell_relax.cu", "== plan_union.cu",
                 "== layer_fused.cu", "== sell_layer_fused.cu",
                 "== traversal_fused.cu", "== sell_traversal_fused.cu",
                 "== measure.cu", "== compact.cu", "== apportion.cu",
                 "== rowsweep.cu")
WIDE_BATCH = 33               # two root-mask words
SYN_HUB_RUN = 4099            # K7's synthetic stream: a hub's run of slots
SELL_DEPTHS = (0, 1, 2, 4)
#: K5 and K9 on a captured layer, K6 and K10 at 33 roots: the depths
#: each is held at (K5, K9: and timed at)
LAYER_DEPTHS = (0, 2)
#: K6 and K10: the CTAs per SM each is held and timed at on the main
#: path's batch (`layer_fused.CTAS_PER_SM` is the kept one)
CTAS_PER_SM_TRIED = (4, 8)
#: how K6 and K10 keep their state across layers
TRAVERSAL_LAYOUT = ("rows (B, n_words) for the planning, root-interleaved "
                    "(n_words, B) for the walk, both written by each "
                    "layer's update pass; the walk reads them by plain "
                    "loads after the grid barrier")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events
    around each call; ``setup`` runs outside the timed window)."""
    import torch
    if setup:
        setup()
    fn()                                     # warm-up
    times = []
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: GPU clock cycles of the sleep kernel that `device_ms` queues launches
#: behind (~30 ms on an H100, far longer than the host takes to queue
#: 20 calls); doubled up to 3 times where it was not
SLEEP_CYCLES = 50_000_000


def device_ms(fn, reps: int) -> float:
    """Device time (ms) of one call of ``fn``: CUDA events around
    ``reps`` calls queued behind a sleep kernel, so that they run back
    to back on the card however long the host takes to launch each (CUDA
    events around one call of a microsecond kernel measure the host's
    launch instead).  The card must still be asleep when the last call
    is queued."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    asleep, start, end = events
    for attempt in range(4):
        torch.cuda._sleep(SLEEP_CYCLES << attempt)
        asleep.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = not asleep.query()
        end.synchronize()
        if hidden:
            return start.elapsed_time(end) / reps
    raise AssertionError("the host could not queue the timed calls within "
                         "the sleep")


def timed_kernel(res: dict, fn, reps: int) -> dict:
    """``res`` with ``ms`` = `device_ms` (calls queued back to back,
    ``method`` `BACK_TO_BACK`) and ``event_ms`` (the median of CUDA
    events around one call, the host's launch included)."""
    res["event_ms"] = cuda_ms(fn, reps)
    res["ms"] = device_ms(fn, reps)
    res["method"] = BACK_TO_BACK
    return res


def level_bfs_depths(src, dst, n_vertices: int, root: int):
    """Independent level-synchronous BFS over the edge list (torch on
    the card): depths, -1 where unreached."""
    import torch
    depth = torch.full((n_vertices,), -1, dtype=torch.int32,
                       device=src.device)
    frontier = torch.zeros((n_vertices,), dtype=torch.bool,
                           device=src.device)
    depth[root] = 0
    frontier[root] = True
    d = 0
    while bool(frontier.any()):
        d += 1
        nxt = torch.zeros_like(frontier)
        nxt[dst[frontier[src]]] = True
        nxt &= depth < 0
        depth[nxt] = d
        frontier = nxt
    return depth


def listed(args) -> int:
    """A work-listed call's key: the (root, block) or (root, slab group)
    pairs its plan lists."""
    return int(args["plan"].na.sum())


def listed_in(bottom_up: bool):
    """A `Spy` key: `listed` for a call in the ``bottom_up`` direction,
    -1 for a call in the other."""
    return lambda a: listed(a) if bool(a["bottom_up"]) == bottom_up else -1


def direction_spies(ops, name: str) -> dict:
    """{bottom_up: a `Spy` of ``name`` keeping the largest call in that
    direction}; enter them with an `contextlib.ExitStack`."""
    return {bu: Spy(ops, {name: listed_in(bu)}) for bu in (False, True)}


def in_direction(spies: dict, name: str, bottom_up: bool):
    """The largest captured call of ``name`` in a direction; the run must
    have had one."""
    call = spies[bottom_up].best.get(name)
    assert call is not None and call["key"] >= 0, \
        f"{name}: no {'bottom-up' if bottom_up else 'top-down'} layer ran"
    return call


class Spy:
    """Wraps kernel wrappers of ``ops`` while traversals run (the
    wrappers are wrapped, not changed).  ``keys`` maps each wrapper's
    name to the key of a call (a function of its arguments by name), or
    to None.  A call is recorded as its arguments by parameter name,
    plus ``args`` (the positional ones, in order) and ``kw`` (the
    keyword-only ones but ``prefetch_depth``, so that the layer replays
    at any depth); tensors are copied before the call, but for the
    graph's arrays.  ``best[name]`` is the call with the largest key,
    with ``before``: the latest call of each keyless wrapper.
    ``calls`` collects ``each(call, result)`` of every call."""

    SHARED = ("rows", "colstarts", "graph", "rows_l", "colstarts_l")

    def __init__(self, ops, keys: dict, each=None):
        self.ops, self.keys, self.each = ops, keys, each
        self.best, self.last, self.calls = {}, {}, []

    def __enter__(self):
        self._orig = {n: getattr(self.ops, n) for n in self.keys}
        for name, orig in self._orig.items():
            setattr(self.ops, name, self._wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.ops, name, orig)
        return False

    def _wrap(self, name, orig):
        import inspect
        import torch
        sig = inspect.signature(orig)
        params = sig.parameters
        key_of = self.keys[name]

        def copy(k, v):
            if k in self.SHARED:
                return v
            if torch.is_tensor(v):
                return v.clone()
            if isinstance(v, tuple) and v and all(map(torch.is_tensor, v)):
                return type(v)(*(x.clone() for x in v))    # a plan
            return v

        def record(bound):
            call = {k: copy(k, v) for k, v in bound.arguments.items()}
            call["args"] = tuple(call[k] for k, p in params.items()
                                 if p.kind is p.POSITIONAL_OR_KEYWORD)
            call["kw"] = {k: call[k] for k, p in params.items()
                          if p.kind is p.KEYWORD_ONLY
                          and k != "prefetch_depth"}
            return call

        @functools.wraps(orig)      # a Spy inside another sees orig's
        def wrapped(*args, **kw):  # signature
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            call = None
            if key_of is None:
                call = self.last[name] = record(bound)
            else:
                key = key_of(bound.arguments)
                if name not in self.best or key > self.best[name]["key"]:
                    self.best.pop(name, None)     # free the old copies
                    call = self.best[name] = dict(
                        record(bound), key=key, before=dict(self.last))
            if self.each is None:
                return orig(*args, **kw)
            call = call or record(bound)
            result = orig(*args, **kw)
            self.calls.append(self.each(call, result))
            return result
        return wrapped


class CallCount:
    """Counts the calls of module-level functions ((module name, function
    name) pairs) while the block runs; the functions are wrapped, not changed.
    ``counts[name]`` is each one's count."""

    def __init__(self, targets):
        self.targets = tuple(targets)
        self.counts = {name: 0 for _, name in self.targets}

    def __enter__(self):
        import importlib
        self._orig = [(importlib.import_module(m), n) for m, n in
                      self.targets]
        self._orig = [(m, n, getattr(m, n)) for m, n in self._orig]
        for module, name, orig in self._orig:
            def wrapped(*a, _orig=orig, _name=name, **kw):
                self.counts[_name] += 1
                return _orig(*a, **kw)
            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name, orig in self._orig:
            setattr(module, name, orig)
        return False


def layer_spy(ops, name: str) -> Spy:
    """A `Spy` of a one-launch layer wrapper (K5 or K9) whose ``calls``
    are each layer's (graph, frontier, visited, bottom_up,
    discoveries)."""
    from repro_torch.kernels.bitmap_kernels import popcount_plain
    return Spy(ops, {name: None}, each=lambda c, out: (
        c["graph"], c["frontier"], c["visited"], c["kw"]["bottom_up"],
        int(popcount_plain(out[0]))))


def k3_bytes(cap, n_marked: int) -> int:
    """Bytes K3 must move for the captured layer, each input read once:
    rows of the plan's union of blocks, the colstarts entries their
    owners span, the union list, count and root masks, frontier +
    visited + out read, out written, and one P word per marked vertex."""
    import torch
    tile = cap["kw"]["tile"]
    plan = cap["plan"]
    n_union = int(plan.ucount)
    blocks = plan.ulist[:n_union].long()
    cs = cap["colstarts"]
    first = torch.searchsorted(cs, (blocks * tile).to(cs.dtype),
                               right=True) - 1
    last = torch.searchsorted(cs, (blocks * tile + tile - 1).to(cs.dtype),
                              right=True) - 1
    cs_entries = int((last - first + 2).sum())
    words = cap["frontier"].numel()
    return (4 * tile * n_union + 4 * cs_entries
            + 4 * (1 + n_union * (1 + int(plan.rmask.shape[1])))
            + 4 * 4 * words + 4 * n_marked)


def fused_layer_bytes(fg, frontier, visited, bottom_up: bool,
                      n_marked: int) -> int:
    """Bytes one fused layer (K5) must move, each input read once: the
    planning reads (two owner ids per block, the degree bitmap, the
    frontier and visited words), the rows of the union of active blocks
    and the colstarts entries they span, P read once for restoration,
    one P word written per discovery, ``out`` and the counts written."""
    import torch
    from repro_torch.kernels.layer_fused import plan_blocks_plain
    wl, na = plan_blocks_plain(fg, visited if bottom_up else frontier,
                               bottom_up)
    used = torch.zeros((fg.n_blocks,), dtype=torch.bool,
                       device=wl.device)
    for b in range(wl.shape[0]):
        used[wl[b, :int(na[b])].long()] = True
    blocks = torch.nonzero(used).flatten()
    cs_entries = int((fg.blk_hi[blocks] - fg.blk_lo[blocks] + 2).sum())
    n_batch, n_words = frontier.shape
    v_pad = int(fg.deg.shape[0])
    return (4 * fg.tile * int(blocks.numel()) + 4 * cs_entries
            + 8 * fg.n_blocks + 4 * n_words + 8 * n_batch * n_words
            + 4 * n_batch * v_pad + 4 * n_marked + 4 * n_batch * n_words
            + 4 * n_batch)


#: sessions tried before an empty trace fails: on the card, the sessions
#: of K9's launch check came back empty up to three times in a row
PROFILER_SESSIONS = 8


def traced_device_events(fn, activities):
    """Run ``fn`` under ``torch.profiler`` and return (device-side
    events, wall microseconds).  A session that recorded no device
    event at all failed to trace (CUPTI on this machine sometimes
    misses a whole session), so it is repeated, up to
    `PROFILER_SESSIONS` sessions; an empty result is then returned and
    fails the caller's count."""
    import torch
    from torch.profiler import profile
    for attempt in range(PROFILER_SESSIONS):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only (kernels, copies), not the host ops
        # that launched them nor the port's per-call ranges, whose
        # device time would count the same work twice
        events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and e.self_device_time_total > 0
                  and e.key not in CALL_RANGES]
        if events:
            return events, wall_us
        log(f"profiler session {attempt + 1} recorded no device event; "
            f"tracing again")
    return [], wall_us


def device_kernels(fn):
    """Run ``fn`` under the profiler (host and device traced, as in
    `profile_run`): {kernel name: launches} of the device-side events
    (kernels and copies)."""
    from torch.profiler import ProfilerActivity
    events, _ = traced_device_events(
        fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    return {e.key: e.count for e in events}


def launches_of(kernels: dict, name: str) -> int:
    return sum(n for k, n in kernels.items() if name in k)


def check_marks(cap, p_racy, frontier_b):
    """Every marked P names a frontier vertex adjacent to its vertex."""
    import torch
    n = cap["kw"]["n_vertices"]
    rows, cs = cap["rows"], cap["colstarts"]
    for b in range(p_racy.shape[0]):
        cand = torch.nonzero(p_racy[b] < 0).flatten()
        if cand.numel() == 0:
            continue
        gate = (p_racy[b, cand] + n).long()
        assert bool(((gate >= 0) & (gate < n)).all()), "parent out of range"
        fw = frontier_b[b, (gate >> 5)]
        assert bool((((fw >> (gate & 31).int()) & 1) == 1).all()), \
            f"root {b}: a marked parent is not in the frontier"
        # binary search cand in adj(gate) (rows sorted per vertex)
        lo, end = cs[gate].long(), cs[gate + 1].long()
        hi = end.clone()
        for _ in range(32):
            mid = (lo + hi) // 2
            right = rows[mid.clamp(max=rows.numel() - 1)] < cand
            lo, hi = torch.where(right, mid + 1, lo), \
                torch.where(right, hi, mid)
        found = (lo < end) & (rows[lo.clamp(max=rows.numel() - 1)] == cand)
        assert bool(found.all()), \
            f"root {b}: a marked parent is not a neighbour"


def phase_kernels(cap, n_vertices: int, v_pad: int, reps: int,
                  label: str = ""):
    """Phase 3: each kernel against its plain version on the card, on
    the captured layer: K2 on its planning bitmap (printed as
    ``frontier_compact_planning``: the main path no longer runs K2, and
    its kernels-line row is the materialized path's stream arm, phase
    10b), the union planner, K3
    on the planner's plan (the plan built outside the timed window) and
    K1.  The plain K3's output stays in ``cap["plain_k3"]`` for phase
    3b."""
    import torch
    from repro_torch.kernels import compact as ck
    from repro_torch.kernels import gather_expand as ge
    from repro_torch.kernels import restoration as rest
    results = {}
    kw = cap["kw"]
    n_batch, n_words = cap["frontier"].shape
    plan_call = cap["before"]["plan_union"]

    # K2 on the captured planning bitmap
    words = plan_call["words"]
    if plan_call["kw"]["complement"]:
        words = ~words
    size, fill = v_pad, n_vertices
    q_k, c_k = ck.compact_cuda(words, size, fill)
    q_p, c_p = ck.compact_plain(words, size, fill)
    err = max(int((q_k - q_p).abs().max()), int((c_k - c_p).abs().max()))
    assert err == 0, f"frontier compaction disagrees: max |err| {err}"
    k2_bytes = 4 * words.numel() + 4 * n_batch * size + 4 * n_batch
    results["frontier_compact_planning"] = timed_kernel(dict(
        max_abs_err=err, bytes=k2_bytes,
        plain_ms=cuda_ms(lambda: ck.compact_plain(words, size, fill),
                         max(3, reps // 4))),
        lambda: ck.compact_cuda(words, size, fill), reps)

    # the union planner on the same layer
    results["plan_union"] = plan_row(plan_call, reps)

    # K3 on the captured layer; K1 on its racy output
    def k3(fn):
        out, p = cap["out_init"].clone(), cap["p_init"].clone()
        fn(cap["plan"], cap["rows"], cap["colstarts"], cap["frontier"],
           cap["visited"], out, p, **kw)
        return out, p

    out_p, p_p = k3(ge.gather_expand_plain)
    cap["plain_k3"] = (out_p, p_p)
    out_k, p_k = k3(ge.gather_expand_cuda)
    torch.cuda.synchronize()
    k3_err = k3_contract(cap, out_k, p_k)
    n_marked = int((p_k < 0).sum())
    out_buf, p_buf = cap["out_init"].clone(), cap["p_init"].clone()

    def reset():
        out_buf.copy_(cap["out_init"])
        p_buf.copy_(cap["p_init"])

    def run_k3(fn):
        return lambda: fn(cap["plan"], cap["rows"], cap["colstarts"],
                          cap["frontier"], cap["visited"], out_buf, p_buf,
                          **kw)

    results["gather_expand_batched"] = dict(
        max_abs_err=k3_err, bytes=k3_bytes(cap, n_marked),
        active_tiles=cap["key"], union_blocks=int(cap["plan"].ucount),
        marked=n_marked, bottom_up=kw["bottom_up"], timing=KERNEL_ONLY,
        ms=cuda_ms(run_k3(ge.gather_expand_cuda), reps, setup=reset),
        plain_ms=cuda_ms(run_k3(ge.gather_expand_plain),
                         max(3, reps // 4), setup=reset))

    # K1 on the kernel's racy P
    f_k, d_k = rest.restoration_cuda(p_k, n_vertices)
    f_p, d_p = rest.restoration_plain(p_k, n_vertices)
    err = max(int((f_k - f_p).abs().max()),
              int((d_k != d_p).sum()))
    assert err == 0, f"restoration disagrees: {err}"
    results["restoration"] = dict(
        max_abs_err=err,
        bytes=8 * n_batch * v_pad + n_batch * v_pad // 8,
        ms=cuda_ms(lambda: rest.restoration_cuda(p_k, n_vertices), reps),
        plain_ms=cuda_ms(lambda: rest.restoration_plain(p_k, n_vertices),
                         max(3, reps // 4)))
    for name, r in results.items():
        r.setdefault("bound_ms", r["bytes"] / HBM_BYTES_PER_S * 1e3)
        log_row(name + label, r)
    log(f"K3 layer{label}: {cap['key']} listed (root, block) pairs, "
        f"{results['gather_expand_batched']['union_blocks']} union blocks, "
        f"{n_marked} marked, bottom_up={kw['bottom_up']}")
    return results


def log_row(name: str, r: dict, **extra) -> None:
    """One kernel's JSON line: its numbers and the facts beside them."""
    log(json.dumps({"kernel": name, **extra, **{
        k: r[k] for k in ("ms", "event_ms", "method", "plain_ms",
                          "replaced_ms", "bytes", "bound_ms", "max_abs_err",
                          "active_tiles", "union_blocks", "timing",
                          "ms_without_unvisited", "ms_count_only", "layer",
                          "roots", "entries", "direction", "valid_slots",
                          "slots", "shape") if k in r}}))


def plan_bytes(graph, words, plan) -> int:
    """Bytes the union planner must move on one layer, each input read
    once: the planning words of every root; CSR: blk_lo, blk_hi and the
    degree words; SELL: every slab's row ids; the root masks, the list,
    its count and the per-root counts written."""
    from repro_torch.kernels import sell_expand as se
    n_items = int(plan.ulist.shape[0])
    if isinstance(graph, se.SellGraph):
        graph_bytes = 4 * int(graph.slab_rows.numel())
    else:
        graph_bytes = 8 * n_items + 4 * int(graph.nz.numel())
    return (4 * words.numel() + graph_bytes + 4 * plan.rmask.numel()
            + 4 * n_items + 4 + 4 * plan.na.numel())


def replaced_planning(graph, words, complement: bool, dense):
    """What the union planner replaced on a layer, as the port ran it
    before the planner: CSR: K2 compacts the planning bitmap, plain
    torch marks the blocks and folds the lists (`union_worklist`); SELL:
    plain-torch slab membership (`plan_slabs_plain`) and the fold.
    Returns the same `UnionPlan`."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import compact as ck
    from repro_torch.kernels import gather_expand as ge
    from repro_torch.kernels import sell_expand as se
    active = ~words if complement else words
    if isinstance(graph, se.SellGraph):
        wl, na = se.plan_slabs_plain(graph, active)
        n = graph.n_steps
    else:
        n = graph.n_blocks
        queue, _ = ck.compact_cuda(active, active.shape[1] * 32,
                                   graph.n_vertices)
        wl, na = engine.mark_blocks_from_queue(
            graph.colstarts, queue, graph.n_vertices, graph.tile, n)
    if dense is not None:
        full = torch.arange(n, dtype=torch.int32, device=wl.device)
        wl = torch.where(dense[:, None], full[None], wl)
        na = torch.where(dense, n, na)
    return ge.UnionPlan.of_lists(wl, na, n)


def plan_row(call, reps: int) -> dict:
    """The union planner on a captured call (graph, words, complement,
    dense): bitwise against its plain version, its time, the plain
    version's, and the time of what it replaced on that layer."""
    from repro_torch.kernels import plan as pl
    graph, words = call["graph"], call["words"]
    kw = dict(complement=call["kw"]["complement"], dense=call["kw"]["dense"])
    err = plan_gate(graph, words, **kw)
    plan = pl.plan_union_cuda(graph, words, **kw)
    r = dict(max_abs_err=err, bytes=plan_bytes(graph, words, plan),
             union_blocks=int(plan.ucount), timing=KERNEL_ONLY,
             ms=cuda_ms(lambda: pl.plan_union_cuda(graph, words, **kw),
                        reps),
             plain_ms=cuda_ms(lambda: pl.plan_union_plain(graph, words,
                                                          **kw),
                              max(3, reps // 4)),
             replaced_ms=cuda_ms(lambda: replaced_planning(
                 graph, words, kw["complement"], kw["dense"]),
                 max(3, reps // 4)))
    r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
    return r


def same_as_parent_planning(ct, roots, res) -> None:
    """The main path once more with the planning it had before the union
    planner (`replaced_planning`, charged one launch as K2 was): its
    visited and frontier sets, depths, stats columns 0-7 and direction
    log must equal ``res``'s bitwise."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.kernels import ops

    def parent_plan(graph, words, *, complement=False, dense=None):
        ops._charge_launch()
        return replaced_planning(graph, words, complement, dense)

    planner = ops.plan_union
    ops.plan_union = parent_plan
    try:
        old = ct.run_batched(roots)
    finally:
        ops.plan_union = planner
    for what, a, b in (("visited", old.state.visited, res.state.visited),
                       ("frontier", old.state.frontier, res.state.frontier),
                       ("depths", old.depths, res.depths),
                       ("stats columns 0-7", old.stats, res.stats)):
        assert torch.equal(a, b), \
            f"main path: {what} differ from the parent's planning"
    assert bfs.direction_log(old) == bfs.direction_log(res)
    log("main path with the parent's planning (K2 + block marking + "
        "union_worklist): visited, frontier, depths, stats columns 0-7 and "
        "direction log bitwise equal")


def plan_gate(graph, words, complement: bool = False, dense=None) -> int:
    """The union planner against its plain version, bitwise: list, count,
    root masks and per-root counts.  Returns the count of disagreeing
    entries (0; any other count fails)."""
    from repro_torch.kernels import plan as pl
    got = pl.plan_union_cuda(graph, words, complement=complement,
                             dense=dense)
    want = pl.plan_union_plain(graph, words, complement=complement,
                               dense=dense)
    err = 0
    for name, a, b in zip(type(got)._fields, got, want):
        assert a.shape == b.shape, f"plan_union: {name} shape"
        err += int((a != b).sum())
    assert err == 0, f"plan_union disagrees with its plain version in " \
                     f"{err} entries"
    return err


def plan_gates(layers, graphs: dict, label: str = "") -> None:
    """`plan_gate` on every captured layer (graph, words, complement) for
    each arm in ``graphs`` ({arm: graph}, None for the layer's own
    graph), as planned and with the batch's middle root dense."""
    import torch
    n = 0
    for graph, words, complement in layers:
        dense = torch.zeros((words.shape[0],), dtype=torch.bool,
                            device=words.device)
        dense[words.shape[0] // 2] = True
        for g in graphs.values():
            for d in (None, dense):
                plan_gate(graph if g is None else g, words, complement, d)
                n += 1
    dirs = sorted({"bottomup" if c else "topdown" for _, _, c in layers})
    log(f"plan_union gate{label}: {len(layers)} layers ({', '.join(dirs)}),"
        f" {layers[0][1].shape[0]} roots, arms {sorted(graphs)}: bitwise "
        f"equal to plan_union_plain as planned and with a dense root "
        f"({n} checks)")


def plan_layers_spy(ops) -> Spy:
    """A `Spy` whose ``calls`` are every planner call's (graph, words,
    complement)."""
    return Spy(ops, {"plan_union": None}, each=lambda c, _: (
        c["graph"], c["words"], c["kw"]["complement"]))


def k3_contract(cap, out_k, p_k) -> int:
    """K3's contract against its plain version's output on the captured
    layer (``cap["plain_k3"]``): after restoration ``out``, ``visited``
    and the marked set equal, every mark a frontier neighbour.  Returns
    the count of disagreeing entries (0; any other count fails)."""
    import torch
    from repro_torch.kernels import restoration as rest
    n = cap["kw"]["n_vertices"]
    out_p, p_p = cap["plain_k3"]
    err = int(((p_k < 0) != (p_p < 0)).sum())
    _, delta_k = rest.restoration_plain(p_k, n)
    _, delta_p = rest.restoration_plain(p_p, n)
    for name, a, b in (("out|delta", out_k | delta_k, out_p | delta_p),
                       ("visited|delta", cap["visited"] | delta_k,
                        cap["visited"] | delta_p)):
        err = max(err, int((a != b).sum()))
        assert torch.equal(a, b), f"gather_expand: {name} disagrees"
    assert err == 0, "gather_expand: the marked sets disagree"
    check_marks(cap, p_k, cap["frontier"])
    return err


def phase_prefetch(cap, reps: int, k3: dict, label: str = ""):
    """Phase 3b: K4 at each depth on the captured layer, on K3's
    contract against the plain version (K3's)."""
    import torch
    from repro_torch.kernels import gather_expand as ge
    kw = cap["kw"]
    out_buf, p_buf = cap["out_init"].clone(), cap["p_init"].clone()

    def reset():
        out_buf.copy_(cap["out_init"])
        p_buf.copy_(cap["p_init"])

    per_depth = {}
    for depth in PREFETCH_DEPTHS:
        reset()
        run = lambda: ge.gather_expand_cuda(
            cap["plan"], cap["rows"], cap["colstarts"], cap["frontier"],
            cap["visited"], out_buf, p_buf, prefetch_depth=depth, **kw)
        run()
        torch.cuda.synchronize()
        err = k3_contract(cap, out_buf, p_buf)
        per_depth[depth] = cuda_ms(run, reps, setup=reset)
        log(json.dumps({"kernel": "gather_expand_prefetch" + label,
                        "prefetch_depth": depth, "ms": per_depth[depth],
                        "k3_ms": k3["ms"], "max_abs_err": err,
                        "union_blocks": k3["union_blocks"]}))
    return dict(max_abs_err=0, ms=per_depth[2], plain_ms=k3["plain_ms"],
                bytes=k3["bytes"], bound_ms=k3["bound_ms"],
                per_depth=per_depth, union_blocks=k3["union_blocks"],
                timing=KERNEL_ONLY)


def layer_contract(name: str, got, want, p_init, n_active) -> int:
    """K5's or K9's contract on one layer against its plain version:
    n_active (also equal to the layer's own plan), ``out`` and the
    marked set bitwise, P restored (no negative mark left).  Returns the
    count of disagreeing entries (0; any other count fails)."""
    (out_k, p_k, na_k), (out_p, p_p, na_p) = got, want
    err = max(int((na_k != na_p).sum()), int((na_k != n_active).sum()),
              int((out_k != out_p).sum()),
              int(((p_k != p_init) != (p_p != p_init)).sum()),
              int((p_k < 0).sum()))
    assert err == 0, f"{name} disagrees with its plain version"
    return err


def phase_layer_kernel(kind: str, cap, reps: int, label: str = "",
                       g=None):
    """K5 (``kind`` "csr", on a captured K3 layer) or K9 ("sell", on a
    captured K8 layer, ``g`` the CSR graph for the marks) against its
    plain version at each depth of `LAYER_DEPTHS`: `layer_contract`,
    every parent a frontier neighbour, one CUDA launch per call by the
    profiler, each timed beside the plain version.  Returns the
    kernels-line numbers (depth 0)."""
    import torch
    from repro_torch.kernels import layer_fused as lf
    from repro_torch.kernels import sell_expand as se
    bu, p_init = cap["kw"]["bottom_up"], cap["p_init"]
    fr, vis = cap["frontier"], cap["visited"]
    if kind == "csr":
        name, device_name = "layer_fused_batched", "layer_fused_kernel"
        n = cap["kw"]["n_vertices"]
        graph = lf.fused_csr(cap["colstarts"], cap["rows"], n,
                             cap["kw"]["tile"], int(p_init.shape[1]))
        cuda, plain, n_active = (lf.layer_fused_cuda, lf.layer_fused_plain,
                                 cap["plan"].na)
        grid_of = lambda d: lf.layer_fused_grid(graph, d)[0]
        marks = lambda p: check_marks(cap, p, fr)
        bytes_of = lambda m: fused_layer_bytes(graph, fr, vis, bu, m)
    else:
        name = "sell_layer_fused_batched"
        device_name = "sell_layer_fused_kernel"
        graph = cap["graph"]
        n = graph.n_vertices
        cuda, plain, n_active = (se.sell_layer_fused_cuda,
                                 se.sell_layer_fused_plain, cap["plan"].na)
        grid_of = lambda d: se.sell_layer_fused_grid(graph, d)
        marks = lambda p: sell_check_marks(cap, p, g)
        bytes_of = lambda m: sell_layer_bytes(graph, fr, vis, bu, m)
    p_plain = p_init.clone()
    want = tuple(t.clone() for t in plain(graph, fr, vis, p_plain,
                                          bottom_up=bu))
    p_buf = p_init.clone()

    def reset():
        p_buf.copy_(p_init)

    runs = {depth: functools.partial(cuda, graph, fr, vis, p_buf,
                                     bottom_up=bu, prefetch_depth=depth)
            for depth in LAYER_DEPTHS}
    # one launch per call, by the profiler, on the main path's layer (no
    # label), one call per session: CUPTI
    # on the card's machine dropped events of sessions that held several
    # calls and, once long traversals had been profiled, returned three
    # empty sessions in a row (phases 5b and 6b of four runs)
    for depth in () if label else LAYER_DEPTHS:
        reset()
        kernels = device_kernels(runs[depth])
        assert sum(kernels.values()) == 1 \
            and launches_of(kernels, device_name) == 1, \
            f"{name} must be one CUDA launch per call, profiler saw " \
            f"{kernels}"
    per = {}
    for depth, run in runs.items():
        reset()
        got = run()
        torch.cuda.synchronize()
        err = layer_contract(f"{name}{label} (depth {depth})", got, want,
                             p_init, n_active)
        marked = got[1] != p_init
        marks(torch.where(marked, got[1] - n, p_init))
        n_marked = int(marked.sum())
        per[depth] = ms = cuda_ms(run, reps, setup=reset)
        log(json.dumps({"kernel": name + label, "prefetch_depth": depth,
                        "ms": ms, "grid": grid_of(depth),
                        "max_abs_err": err, "bottom_up": bu,
                        "marked": n_marked, "cuda_launches_per_call": 1}))
    res = dict(max_abs_err=0, n_marked=n_marked, bytes=bytes_of(n_marked),
               ms=per[0], per_depth=per,
               plain_ms=cuda_ms(lambda: plain(graph, fr, vis, p_plain,
                                              bottom_up=bu), 3,
                                setup=lambda: p_plain.copy_(p_init)))
    res["bound_ms"] = res["bytes"] / HBM_BYTES_PER_S * 1e3
    log_row(name + label, res, bottom_up=bu)
    return res


def layer_kernel_both_ways(kind: str, cap, dirs: dict, reps: int,
                           label: str = "", g=None):
    """`phase_layer_kernel` on the captured largest layer ``cap`` and on
    the largest layer of the other direction (``dirs``: the run's
    `direction_spies`); returns the numbers of the first."""
    res = phase_layer_kernel(kind, cap, reps, label, g)
    bu = not cap["kw"]["bottom_up"]
    name = "gather_expand_batched" if kind == "csr" else "sell_batched"
    phase_layer_kernel(kind, in_direction(dirs, name, bu),
                       max(3, reps // 4),
                       label + ("_bottomup" if bu else "_topdown"), g)
    return res


@contextlib.contextmanager
def ctas_per_sm(n: int):
    """K6's and K10's grid at ``n`` CTAs per SM while the block runs
    (their wrappers read `layer_fused.CTAS_PER_SM` at each launch)."""
    from repro_torch.kernels import layer_fused as lf
    kept, lf.CTAS_PER_SM = lf.CTAS_PER_SM, n
    try:
        yield
    finally:
        lf.CTAS_PER_SM = kept


def traversal_case(kind: str, fmt, spec, roots):
    """K6 (``kind`` "csr") or K10 ("sell") on ``fmt`` under the resolved
    ``spec``: (kernel name, CUDA wrapper, plain version, grid function
    of the depth, graph, the batch's initial state, keyword
    arguments)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import traversal_fused as tf
    if kind == "csr":
        graph = fmt.fused_graph(spec)
        case = ("traversal_fused_batched", tf.traversal_fused_cuda,
                tf.traversal_fused_plain,
                lambda d: tf.traversal_fused_grid(graph, d)[0])
    else:
        graph = fmt.sell_graph(spec.tile)
        case = ("sell_traversal_fused_batched",
                tf.sell_traversal_fused_cuda, tf.sell_traversal_fused_plain,
                lambda d: tf.sell_traversal_fused_grid(graph, d))
    r = torch.as_tensor(roots, dtype=torch.int32, device=fmt.device)
    state = engine._init_batched(r, fmt.n_vertices, fmt.n_vertices_padded)
    kw = dict(code=engine.encode_policy(spec.policy, fmt.n_vertices,
                                        len(roots), spec.max_layers),
              max_layers=spec.max_layers)
    return (*case, graph, state, kw)


def traversal_gate(name: str, cuda, graph, state, kw, want,
                   depth: int = 0) -> int:
    """K6's or K10's contract against its plain version's outputs
    ``want``: frontier, visited, depths, layers and stats bitwise, P
    restored and set where the plain version's is (parents race).
    Returns the count of disagreeing entries (0; any other fails)."""
    import torch
    got = cuda(graph, *state, **kw, prefetch_depth=depth)
    torch.cuda.synchronize()
    p0 = state[2]
    for i, what in ((0, "frontier"), (1, "visited"), (3, "depths"),
                    (4, "layers"), (5, "stats")):
        assert torch.equal(got[i], want[i]), \
            f"{name} (depth {depth}): {what} disagrees with its plain " \
            f"version"
    assert int(got[2].min()) >= 0 \
        and torch.equal(got[2] != p0, want[2] != p0), \
        f"{name} (depth {depth}): P is not restored as its plain version's"
    return 0


def phase_traversal_kernel(kind: str, ct, roots, layers, reps: int):
    """K6 (``kind`` "csr", ``ct`` a CSR ``persistent`` plan) or K10
    ("sell") on the batch's initial state: `traversal_gate` and timing
    at each of `CTAS_PER_SM_TRIED` CTAs per SM, in turns (the kept
    count, the other, the other, the kept); bytes = the per-layer K5
    (K9) bytes of the same traversal (``layers`` from a `layer_spy` of a
    megakernel run) plus one read of the degrees."""
    from repro_torch.kernels import layer_fused as lf
    name, cuda, plain, grid_of, graph, state, kw = traversal_case(
        kind, ct.fmt, ct.resolved, roots)
    layer_bytes = fused_layer_bytes if kind == "csr" else sell_layer_bytes
    want = plain(graph, *state, **kw)
    kept = lf.CTAS_PER_SM
    order = [kept] + [n for n in CTAS_PER_SM_TRIED if n != kept]
    times, grids = {n: [] for n in order}, {}
    for n in order + order[::-1]:
        with ctas_per_sm(n):
            if n not in grids:
                traversal_gate(name, cuda, graph, state, kw, want)
                grids[n] = grid_of(0)
            times[n].append(cuda_ms(lambda: cuda(graph, *state, **kw),
                                    reps))
    bytes_ = sum(layer_bytes(gr, f, v, bu, m)
                 for gr, f, v, bu, m in layers) + 4 * int(graph.deg.shape[0])
    res = dict(max_abs_err=0, bytes=bytes_,
               bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
               ms=statistics.mean(times[kept]),
               plain_ms=cuda_ms(lambda: plain(graph, *state, **kw), 1))
    log(json.dumps({"kernel": name, "ms": res["ms"],
                    "plain_ms": res["plain_ms"], "bytes": bytes_,
                    "bound_ms": res["bound_ms"], "max_abs_err": 0,
                    "layers": int(want[4][0]), "grid": grids[kept],
                    "ctas_per_sm": kept,
                    "ms_by_ctas_per_sm": {str(n): t for n, t in
                                          times.items()},
                    "grid_by_ctas_per_sm": {str(n): g for n, g in
                                            grids.items()},
                    "layout": TRAVERSAL_LAYOUT}))
    return res


def bottom_up_graph(scale: int, seed: int, tile: int, device: str):
    """An R-MAT graph at ``scale`` with two hub components appended,
    symmetrized: hub ``h`` (3 ``tile`` + 8 leaves, its list spanning at
    least 3 rows-blocks) reached from the R-MAT hub by a path of 3
    vertices, the last of which ends ``h``'s list; hub ``h2`` with as
    many leaves and no edge to the rest, so that every root outside it
    leaves ``h2`` and its leaves unvisited with no frontier neighbour in
    each bottom-up layer.  Returns (graph, R-MAT hub, a leaf of h2,
    h, h2)."""
    import torch
    from repro_torch.core import csr as csr_mod
    from repro_torch.core import rmat
    base = rmat.generate(seed, scale, 16, symmetrize=False, device=device)
    n0 = base.n_vertices
    deg = torch.bincount(torch.cat([base.src, base.dst]).long(),
                         minlength=n0)
    g0 = int(torch.argmax(deg))
    leaves = 3 * tile + 8
    h = n0                                   # its leaves h + 1 .. h + leaves
    x1, x2, x3 = h + leaves + 1, h + leaves + 2, h + leaves + 3
    h2 = x3 + 1                              # its leaves after it
    n = h2 + leaves + 1
    src = [g0, x1, x2, x3] + [h] * leaves + [h2] * leaves
    dst = [x1, x2, x3, h] + list(range(h + 1, h + 1 + leaves)) \
        + list(range(h2 + 1, h2 + 1 + leaves))
    add_s = torch.tensor(src, dtype=torch.int32, device=device)
    add_d = torch.tensor(dst, dtype=torch.int32, device=device)
    s = torch.cat([base.src, add_s])
    d = torch.cat([base.dst, add_d])
    edges = rmat.EdgeList(torch.cat([s, d]), torch.cat([d, s]), n)
    return csr_mod.from_edges(edges, device=device), g0, h2 + 1, h, h2


def phase_bottom_up_walk(seed: int = 0) -> None:
    """Phase 5a: K6's bottom-up walk (vertex by vertex, each root's break
    at its first frontier parent) against K6's plain version
    (`traversal_gate`) under BeamerHybrid at B = 1, 8 and 40 (two
    root-mask words), depths 0 and 1, on `bottom_up_graph` at SCALE 16,
    tile 256: the batch must run bottom-up layers, its last root sits in
    ``h2``'s component, and ``h2`` stays unvisited for the others; then
    one traced launch of each batch (outputs as untraced) prints each
    bottom-up layer's neighbour entries tested over the slots walked."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.kernels.traversal_fused import MODE_BOTTOMUP
    from repro_torch.obs.trace import PHASES, read_phases
    tile = 256
    g, g0, leaf2, h, h2 = bottom_up_graph(16, seed, tile, "cuda")
    cs = g.colstarts.cpu()
    for v in (h, h2):
        first, last = int(cs[v]) // tile, (int(cs[v + 1]) - 1) // tile
        assert last - first + 1 >= 3, (v, first, last)
    ct = bfs.plan(g, bfs.TraversalSpec(policy=bfs.BeamerHybrid(),
                                       pipeline="persistent", tile=tile))
    giant = [int(g.rows[int(cs[g0])])] + [
        r for r in pick_roots(g, 64, seed + 5) if r < h and r != g0]
    for n_batch in (1, 8, 40):
        roots = giant[:1] if n_batch == 1 \
            else giant[:n_batch - 1] + [leaf2]
        assert len(roots) == n_batch
        name, cuda, plain, _, graph, state, kw = traversal_case(
            "csr", ct.fmt, ct.resolved, roots)
        want = plain(graph, *state, **kw)
        modes = want[5][:int(want[4][0]), 3].tolist()
        assert MODE_BOTTOMUP in modes, modes
        vis = want[1].cpu()
        for b in range(n_batch - (n_batch > 1)):
            assert not (int(vis[b, h2 >> 5]) >> (h2 & 31)) & 1
        for depth in (0, 1):
            traversal_gate(f"{name}_bottom_up_b{n_batch}", cuda, graph,
                           state, kw, want, depth)
        with PHASES.recording():
            got = cuda(graph, *state, **kw, prefetch_depth=1)
        torch.cuda.synchronize()
        for i in (0, 1, 3, 4, 5):
            assert torch.equal(got[i], want[i]), (n_batch, i)
        p = read_phases(PHASES.launches[-1])
        walked = [(l, int(p.walked[l, 0]), int(p.walked[l, 1]))
                  for l in range(p.layers) if p.modes[l] == MODE_BOTTOMUP]
        assert walked and all(s > 0 and 0 < e for _, e, s in walked), walked
        assert all(e == 0 and s == 0 for (l, (e, s)) in
                   enumerate(p.walked.tolist())
                   if p.modes[l] != MODE_BOTTOMUP), p.walked
        log(f"bottom_up_walk_b{n_batch}: K6 at depths [0, 1] equals its "
            f"plain version (modes {modes}); examined / slots by "
            f"bottom-up layer "
            f"{[(l, e, s, round(e / s, 4)) for l, e, s in walked]}")


def wide_traversal_gates(g, sell, roots, label: str) -> None:
    """Phase 6b: K6 on ``g`` and K10 on its SELL layout ``sell`` at
    ``roots`` under the four policies, at each depth of `LAYER_DEPTHS`,
    against their plain versions (`traversal_gate`)."""
    import repro_torch.bfs as bfs
    for pol in (bfs.TopDown(), bfs.ThresholdSimd(), bfs.PaperLiteralLayers(),
                bfs.BeamerHybrid()):
        modes = {}
        for kind, fmt in (("csr", g), ("sell", sell)):
            ct = bfs.plan(fmt, bfs.TraversalSpec(policy=pol,
                                                 pipeline="persistent"))
            name, cuda, plain, _, graph, state, kw = traversal_case(
                kind, ct.fmt, ct.resolved, roots)
            want = plain(graph, *state, **kw)
            for depth in LAYER_DEPTHS:
                traversal_gate(name + label, cuda, graph, state, kw, want,
                               depth)
            modes[kind] = want[5][:int(want[4][0]), 3].tolist()
        log(f"{type(pol).__name__}{label}: K6 and K10 at depths "
            f"{list(LAYER_DEPTHS)} equal their plain versions; modes per "
            f"layer {modes}")


#: what K6's and K10's barriers compile to: the grid barrier's acquire
#: must invalidate L1, since the walk reads state rewritten between
#: layers by plain loads
SASS_OPS = ("CCTL.IVALL", "MEMBAR", "LDG.E.STRONG.GPU", "LDG.E.CONSTANT",
            "LDG")


def barrier_sass() -> dict:
    """Counts of `SASS_OPS` in the built SASS of K5, K6, K9 and K10
    (``cuobjdump -sass`` of the library); logged per kernel.  Returns
    {kernel: counts}."""
    import re
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    dump = subprocess.run([str(cuobjdump), "-sass", str(_build.build())],
                          check=True, capture_output=True,
                          text=True).stdout
    funcs, current = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = funcs.setdefault(m.group(1), [])
        elif current is not None:
            current.append(line)
    out = {}
    for kernel in ("traversal_fused_kernel", "sell_traversal_fused_kernel",
                   "layer_fused_kernel", "sell_layer_fused_kernel"):
        # a plain kernel's mangled name, or a template's untraced build
        tags = (f"{len(kernel)}{kernel}E", f"{len(kernel)}{kernel}ILb0E")
        body = [ln for k, v in funcs.items() if any(t in k for t in tags)
                for ln in v]
        out[kernel] = {op: sum(op in ln for ln in body) for op in SASS_OPS}
        log(json.dumps({"sass": kernel, **out[kernel]}))
    return out


def sell_groups(graph, wl, na) -> int:
    """Slab groups in the union of the roots' work-lists."""
    import torch
    used = torch.zeros((graph.n_steps,), dtype=torch.bool, device=wl.device)
    for b in range(wl.shape[0]):
        used[wl[b, :int(na[b])].long()] = True
    return int(used.sum())


def sell_k8_bytes(cap, n_marked: int) -> int:
    """Bytes K8 must move for a captured layer, each input read once:
    cols and slab_rows of the plan's union of groups, the union list,
    its count and root masks, frontier + visited + out read, out
    written, one P word per marked vertex."""
    from repro_torch.kernels.sell_expand import SLAB_INTS
    graph, plan = cap["graph"], cap["plan"]
    n_batch, n_words = cap["frontier"].shape
    n_union = int(plan.ucount)
    return (4 * graph.spp * SLAB_INTS * n_union
            + 4 * (1 + n_union * (1 + int(plan.rmask.shape[1])))
            + 4 * 4 * n_batch * n_words + 4 * n_marked)


def sell_layer_bytes(graph, frontier, visited, bottom_up: bool,
                     n_marked: int) -> int:
    """Bytes one SELL layer (K9) must move, each input read once: every
    slab's row ids (the plan), the planning and sweep bitmaps, the cols
    of the union of active groups, P read once for restoration, one P
    word per discovery, ``out`` and the counts written."""
    from repro_torch.kernels.sell_expand import (SLICE_C, W_QUANT,
                                                 plan_slabs_plain)
    wl, na = plan_slabs_plain(graph, ~visited if bottom_up else frontier)
    n_batch, n_words = frontier.shape
    v_pad = int(graph.deg.shape[0])
    return (4 * int(graph.slab_rows.numel())
            + 4 * graph.spp * W_QUANT * SLICE_C * sell_groups(graph, wl, na)
            + 8 * n_batch * n_words + 4 * n_batch * v_pad + 4 * n_marked
            + 4 * n_batch * n_words + 4 * n_batch)


def sell_check_marks(cap, p_racy, g):
    """`check_marks` for a SELL layer: the SELL adjacency is the CSR
    adjacency, so the marks are checked against the main path's CSR."""
    check_marks(dict(kw=dict(n_vertices=g.n_vertices), rows=g.rows,
                     colstarts=g.colstarts), p_racy, cap["frontier"])


def k8_gate(cap, g, depth: int, want) -> int:
    """K8 at ``depth`` on a captured call (``cap``: its plan, state and
    direction) against its plain version's (out, P) ``want``: after
    restoration ``out``, ``visited`` and the marked set equal, every
    mark a frontier neighbour.  Returns the count of disagreeing entries
    (0; any other count fails)."""
    import torch
    from repro_torch.kernels import restoration as rest
    from repro_torch.kernels import sell_expand as se
    n = g.n_vertices
    out, p = cap["out_init"].clone(), cap["p_init"].clone()
    se.sell_expand_cuda(cap["graph"], cap["plan"], cap["frontier"],
                        cap["visited"], out, p,
                        bottom_up=cap["kw"]["bottom_up"],
                        prefetch_depth=depth)
    torch.cuda.synchronize()
    out_p, p_p = want
    _, delta_k = rest.restoration_plain(p, n)
    _, delta_p = rest.restoration_plain(p_p, n)
    err = int(((p < 0) != (p_p < 0)).sum())
    for a, b in ((out | delta_k, out_p | delta_p),
                 (cap["visited"] | delta_k, cap["visited"] | delta_p)):
        err = max(err, int((a != b).sum()))
    assert err == 0, f"K8 at depth {depth} disagrees with its plain version"
    sell_check_marks(cap, p, g)
    return err


def k8_plain(cap):
    """K8's plain version on a captured call: (out, P)."""
    from repro_torch.kernels import sell_expand as se
    out, p = cap["out_init"].clone(), cap["p_init"].clone()
    se.sell_expand_plain(cap["graph"], cap["plan"], cap["frontier"],
                         cap["visited"], out, p,
                         bottom_up=cap["kw"]["bottom_up"])
    return out, p


def phase_sell_kernels(cap, g, reps: int):
    """K8 (depths 0, 1, 2, 4) on the captured SELL layer, on the union
    planner's plan of that layer, and K13 on its frontier words (printed
    as ``popcount_sell_frontier``; K13's kernels-line row is the sssp
    portfolio's count-only measure, phase 9), each
    against its plain version on the card; the planner on that layer
    beside the planning it replaced (`plan_slabs_plain` + the fold)."""
    from repro_torch.kernels import bitmap_kernels as bk
    from repro_torch.kernels import sell_expand as se
    graph = cap["graph"]
    bu = cap["kw"]["bottom_up"]
    res = {}

    want = k8_plain(cap)
    n_marked = int((want[1] < 0).sum())
    out_buf, p_buf = cap["out_init"].clone(), cap["p_init"].clone()

    def reset():
        out_buf.copy_(cap["out_init"])
        p_buf.copy_(cap["p_init"])

    def k8(fn, **kw):
        return lambda: fn(graph, cap["plan"], cap["frontier"], cap["visited"],
                          out_buf, p_buf, bottom_up=bu, **kw)

    per_depth = {}
    n_union = int(cap["plan"].ucount)
    for depth in SELL_DEPTHS:
        err = k8_gate(cap, g, depth, want)
        per_depth[depth] = cuda_ms(k8(se.sell_expand_cuda,
                                      prefetch_depth=depth), reps,
                                   setup=reset)
        log(json.dumps({"kernel": "sell_expand", "prefetch_depth": depth,
                        "ms": per_depth[depth], "max_abs_err": err,
                        "union_blocks": n_union}))
    bytes_k8 = sell_k8_bytes(cap, n_marked)
    plain_ms = cuda_ms(k8(se.sell_expand_plain), max(3, reps // 4),
                       setup=reset)
    res["sell_expand_batched"] = dict(
        max_abs_err=0, ms=per_depth[0], plain_ms=plain_ms, bytes=bytes_k8,
        groups=cap["key"], marked=n_marked, bottom_up=bu,
        union_blocks=n_union, timing=KERNEL_ONLY)
    res["sell_expand_prefetch"] = dict(
        max_abs_err=0, ms=per_depth[2], plain_ms=plain_ms, bytes=bytes_k8,
        per_depth=per_depth, union_blocks=n_union, timing=KERNEL_ONLY)

    # K13 on the layer's frontier words
    words = cap["frontier"]
    got, want_n = bk.popcount_cuda(words), bk.popcount_plain(words)
    err = abs(int(got) - int(want_n))
    assert err == 0, f"popcount disagrees: {int(got)} vs {int(want_n)}"
    res["popcount_sell_frontier"] = timed_kernel(dict(
        max_abs_err=err, bytes=4 * words.numel() + 4,
        plain_ms=cuda_ms(lambda: bk.popcount_plain(words), reps)),
        lambda: bk.popcount_cuda(words), reps)
    for name, r in res.items():
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        log(json.dumps({"kernel": name, **{
            k: r[k] for k in ("ms", "event_ms", "method", "plain_ms",
                              "bytes", "bound_ms", "max_abs_err",
                              "union_blocks", "timing") if k in r}}))
    log(f"K8 layer: {cap['key']} listed (root, group) pairs over "
        f"{n_union} union groups, {n_marked} marked, bottom_up={bu}")
    # the SELL fused_gather planning of the same layer
    log_row("plan_union_sell_fused_gather",
            plan_row(cap["before"]["plan_union"], reps), bottom_up=bu)
    return res


def k8_both_ways(dirs: dict, g, label: str = "") -> None:
    """K8 on the largest layer of each direction of a SELL fused_gather
    run (``dirs``: its `direction_spies` of ``sell_batched``) at each
    depth of `LAYER_DEPTHS`, against its plain version (`k8_gate`)."""
    for bu in (False, True):
        cap = in_direction(dirs, "sell_batched", bu)
        want = k8_plain(cap)
        for depth in LAYER_DEPTHS:
            k8_gate(cap, g, depth, want)
        log(f"sell_expand{label} ({'bottom-up' if bu else 'top-down'}, "
            f"{cap['frontier'].shape[0]} roots, {int(cap['plan'].ucount)} "
            f"union groups): K8 at depths {list(LAYER_DEPTHS)} equals its "
            f"plain version")


def phase_sell_layer(g, roots, reps: int, label: str = ""):
    """Phase 3d (and 6b): K8 (`k8_both_ways`, depths 0 and 2) and K9
    (`layer_kernel_both_ways`) on the largest SELL layer of each
    direction of a ``fused_gather`` run of ``roots`` on the autotuner's
    SELL layout of ``g``.  On the main path it runs
    before any long traversal is profiled: after those, the card's
    CUPTI returned empty sessions."""
    import repro_torch.bfs as bfs
    from repro_torch import formats
    from repro_torch.kernels import ops
    fmt = formats.build(g, "auto")
    assert isinstance(fmt, formats.SellFormat), type(fmt)
    dirs = direction_spies(ops, "sell_batched")
    with Spy(ops, {"sell_batched": listed}) as spy, \
            MeasureCapture(ops) as measured, \
            contextlib.ExitStack() as stack:
        for d in dirs.values():
            stack.enter_context(d)
        bfs.plan(fmt, bfs.TraversalSpec(**BUILTIN_KNOBS)) \
            .run_batched(roots)
    measure_gates(measured.calls, f"_sell{label}")
    del measured
    res = layer_kernel_both_ways("sell", spy.best["sell_batched"], dirs,
                                 reps, label, g)
    # after K9's profiled launch checks: on the card, a profiler session
    # right after these gates once came back empty three times
    k8_both_ways(dirs, g, label)
    return res


def phase_sell(g, roots, base, oracle, edges: int, reps: int,
               plan_layers, profile: bool = False):
    """Phase 5b: the SELL-C-σ layout of the main path's graph, built on
    the card by the autotuner's choice, on its four paths and kernels;
    the union planner's SELL arm on the main path's planning bitmaps
    (``plan_layers``); the ``fused_gather`` paths plan with the planner
    alone (one launch per layer, no call of `PLAIN_PLANNING`), and with
    ``profile`` the depth-0 one is traced.  Returns ({kernel: results},
    {kernel: launches})."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch import formats
    from repro_torch.formats import autotune
    from repro_torch.kernels import ops
    choice = autotune.choose(g)
    log(f"autotune: {choice.format} ({choice.reason})")
    assert choice.format == "sell", choice
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fmt = formats.build(g, "auto")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    assert isinstance(fmt, formats.SellFormat), type(fmt)
    assert fmt.sigma == formats.SellFormat.DEFAULT_SIGMA, fmt.sigma
    log(f"sell layout: {fmt.n_slabs} slabs, sigma {fmt.sigma}, fill "
        f"{fmt.fill_ratio:.6f}, {fmt.footprint().summary()}; built on the "
        f"card in {build_s:.6f} s, peak device memory during the build "
        f"{peak / 2**30:.3f} GiB")
    plan_gates(plan_layers, {"sell": fmt.sell_graph(
        bfs.plan(fmt, bfs.TraversalSpec(**BUILTIN_KNOBS)).resolved.tile)},
        "_sell")
    kres, launches = {}, {}
    n_layers = int(base.state.layer)
    for name, (fields, kernels, per_layer) in SELL_PATHS.items():
        with CallCount(PLAIN_PLANNING) as plain:
            ct, launched, _ = run_path(fmt, g, roots, name, fields, kernels,
                                       per_layer, base, oracle, edges,
                                       (0, 1, 2, 3, 4, 6))
        for k in kernels:
            launches.setdefault(k, launched[k])
        if "fused_gather" in name:
            assert launched["plan_union"] == n_layers \
                and not any(plain.counts.values()), \
                (name, launched["plan_union"], plain.counts)
            log(f"{name} planning: {n_layers} plan_union launches for "
                f"{n_layers} layers; no call of "
                f"{', '.join(sorted(plain.counts))}")
        if name == "sell_fused_gather":           # an untimed capture run
            with Spy(ops, {"plan_union": None,
                           "sell_batched": listed}) as cap:
                ct.run_batched(roots)
            if profile:
                kernels_seen = profile_run(ct, roots, name, top=8)
                got = launches_of(kernels_seen, "sell_expand_kernel")
                assert got == n_layers, \
                    f"K8 must be one CUDA launch per layer, saw {got}"
        if name == "sell_megakernel":
            kernels_seen = profile_run(ct, roots, name, top=8)
            got = launches_of(kernels_seen, "sell_layer_fused_kernel")
            assert got == n_layers, \
                f"K9 must be one CUDA launch per layer, saw {got}"
            log(f"sell_megakernel: {n_layers} K9 launches for {n_layers} "
                f"layers")
            with layer_spy(ops, "sell_layer_fused_batched") as mega_cap:
                ct.run_batched(roots)
        if name == "sell_persistent":
            kernels_seen = profile_run(ct, roots, name, top=8)
            assert launches_of(kernels_seen,
                               "sell_traversal_fused_kernel") == 1, \
                "K10 must be one CUDA launch per traversal"
            log(f"sell_persistent: 1 K10 launch per traversal; "
                f"{sum(kernels_seen.values()) - 1} other device events "
                f"(initial state)")
            kres["sell_traversal_fused_batched"] = \
                phase_traversal_kernel("sell", ct, roots, mega_cap.calls, 5)
        del ct
    kres.update(phase_sell_kernels(cap.best["sell_batched"], g, reps))
    del cap, mega_cap, fmt
    bfs.clear_plan_cache()
    torch.cuda.empty_cache()
    return kres, launches


def relax_bytes(name, args) -> int:
    """Bytes K11 or K12 must move for a captured layer, each input read
    once: the rows (CSR: with the colstarts entries their owners span)
    or cols and slab_rows (SELL) of the plan's union of blocks or
    groups, the union list, count and root masks, the frontier words,
    ``vals`` read and ``out_vals`` and ``p_layer`` written."""
    import torch
    from repro_torch.kernels.sell_expand import SLAB_INTS
    if name == "gather_relax_batched":
        plan, rows, cs, frontier, vals = args
        tile = int(rows.shape[0]) // int(plan.ulist.shape[0])
        n_union = int(plan.ucount)
        blocks = plan.ulist[:n_union].long()
        first = torch.searchsorted(cs, (blocks * tile).to(cs.dtype),
                                   right=True) - 1
        last = torch.searchsorted(
            cs, (blocks * tile + tile - 1).to(cs.dtype), right=True) - 1
        graph_bytes = 4 * tile * n_union \
            + 4 * int((last - first + 2).sum())
    else:
        graph, plan, frontier, vals = args
        n_union = int(plan.ucount)
        graph_bytes = 4 * graph.spp * SLAB_INTS * n_union
    return (graph_bytes + 4 * (1 + n_union * (1 + int(plan.rmask.shape[1])))
            + 4 * frontier.numel() + 3 * 4 * vals.numel())


def relax_fold_inputs(name, args, kw):
    """The layer's candidates as one scatter-min's inputs over the
    flattened (B * V_pad) value rows: (index, candidate) of every edge
    from a frontier vertex to a real neighbour."""
    import torch
    from repro_torch.kernels import gather_expand as ge
    from repro_torch.kernels import sell_expand as se
    unit, weighted = kw["unit"], kw["weighted"]
    if name == "gather_relax_batched":
        plan, rows, cs, frontier, vals = args
        n = kw["n_vertices"]
        edges = lambda b: ge.worklist_edges(plan.items_of(b), rows, cs,
                                            kw["tile"])
    else:
        graph, plan, frontier, vals = args
        n = graph.n_vertices
        edges = lambda b: se.slab_edges(graph, plan.items_of(b))
    v_pad = vals.shape[1]
    idx, cand = [], []
    for b in range(vals.shape[0]):
        for src, nbr in edges(b):
            mask, c = ge.relax_candidates(n, src, nbr, frontier[b], vals[b],
                                          unit=unit, weighted=weighted)
            idx.append(nbr[mask] + b * v_pad)
            cand.append(c[mask])
    return torch.cat(idx), torch.cat(cand)


def timed_once(fn):
    """(result, device ms) of one call of ``fn``, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def relax_arms() -> dict:
    """{relax wrapper: (its CUDA arm, its plain version)}."""
    from repro_torch.kernels import gather_expand as ge
    from repro_torch.kernels import sell_expand as se
    return {"gather_relax_batched": (ge.gather_relax_cuda,
                                     ge.gather_relax_plain),
            "sell_relax_batched": (se.sell_relax_cuda, se.sell_relax_plain)}


def relax_gate(name, args, kw) -> int:
    """K11 or K12 against its plain version on one call's arguments:
    ``out_vals`` and ``p_layer`` bitwise, no negative value.  Returns
    the count of disagreeing entries (0)."""
    import torch
    cuda_fn, plain_fn = relax_arms()[name]
    got = cuda_fn(*args, **kw)
    want = plain_fn(*args, **kw)
    err = int((got[0].view(torch.int32) != want[0].view(torch.int32)).sum()) \
        + int((got[1] != want[1]).sum())
    assert err == 0, f"{name} disagrees with its plain version in {err} " \
                     f"entries"
    assert bool((got[0] >= 0).all()), f"{name}: negative value"
    return err


def first_root(name, args):
    """A captured relax call's arguments for its first root alone (B = 1),
    with that root's plan."""
    from repro_torch.kernels import gather_expand as ge
    from repro_torch.kernels.layer_fused import compact_worklist
    at = 0 if name == "gather_relax_batched" else 1
    plan = args[at]
    n_items = int(plan.ulist.shape[0])
    wl, na = compact_worklist(plan.listed()[:1], n_items)
    one = list(args)
    one[at] = ge.UnionPlan.of_lists(wl, na, n_items)
    one[-2] = args[-2][:1].contiguous()          # frontier
    one[-1] = args[-1][:1].contiguous()          # vals
    return tuple(one)


def phase_relax_kernels(cap, reps: int, label: str = "",
                        fold: bool = True):
    """K11 and K12 on the largest captured layer of each algorithm
    (``cap``: {algorithm: its `Spy`}), against their plain versions:
    ``out_vals`` and ``p_layer`` bitwise, at the layer's batch and for
    its first root alone (B = 1).  Each is timed on the layer's plan,
    built outside the window.  Returns {algorithm: {kernel: results}};
    with ``fold`` each result also holds, as ``phase0_fold_ms``, the
    time of one ``scatter_reduce_(amin)`` fold of the layer's
    candidates, computed beforehand: phase 0 only, since no one PyTorch
    call computes the whole function (so the kernel's ``library_ms``
    stays null)."""
    import torch
    arms = relax_arms()
    out = {}
    for alg, spy in cap.items():
        out[alg] = {}
        for name, call in spy.best.items():
            items, args, kw = call["key"], call["args"], call["kw"]
            cuda_fn, plain_fn = arms[name]
            want, plain_ms = timed_once(lambda: plain_fn(*args, **kw))
            vals = args[-1]
            got = cuda_fn(*args, **kw)
            err = int((got[0].view(torch.int32)
                       != want[0].view(torch.int32)).sum()) \
                + int((got[1] != want[1]).sum())
            assert err == 0, f"{name} ({alg}) disagrees with its plain " \
                             f"version in {err} entries"
            assert bool((got[0] >= 0).all()), f"{name}: negative value"
            err_b1 = relax_gate(name, first_root(name, args), kw)
            plan = args[0] if name == "gather_relax_batched" else args[1]
            r = dict(max_abs_err=max(err, err_b1), items=items,
                     bytes=relax_bytes(name, args),
                     improved=int((got[0] != vals).sum()),
                     ms=cuda_ms(lambda: cuda_fn(*args, **kw), reps),
                     plain_ms=plain_ms, dtype=str(vals.dtype).split(".")[-1],
                     union_blocks=int(plan.ucount), timing=KERNEL_ONLY)
            if fold:
                idx, cand = relax_fold_inputs(name, args, kw)
                flat = vals.reshape(-1).clone()
                r["phase0_fold_ms"] = cuda_ms(
                    lambda: flat.scatter_reduce_(0, idx, cand, "amin",
                                                 include_self=True), reps,
                    setup=lambda: flat.copy_(vals.reshape(-1)))
                assert torch.equal(flat.view(vals.shape), got[0]), \
                    f"{name}: the scatter_reduce_ fold disagrees with " \
                    f"K11/K12"
                del idx, cand, flat
            r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
            out[alg][name] = r
            log(json.dumps({"kernel": name + label, "algorithm": alg, **{
                k: r[k] for k in ("ms", "plain_ms", "phase0_fold_ms",
                                  "bytes", "bound_ms", "max_abs_err",
                                  "items", "union_blocks",
                                  "improved", "dtype", "timing") if k in r},
                "roots": int(vals.shape[0]), "b1_equal": err_b1 == 0,
                **({"phase0_fold": "scatter_reduce_(amin) of the "
                                   "candidates, phase 0 only"}
                   if fold else {})}))
            del got, want
            torch.cuda.empty_cache()
    return out


def phase_wide_batch(g, sell, seed: int, reps: int) -> None:
    """Phase 6b: a batch of `WIDE_BATCH` roots (two root-mask words) on
    ``g`` and its SELL layout ``sell``: the union planner (both arms, on
    every layer of the main-path traversal, as planned and with a dense
    root), K2, K3 (and K4 at each depth) and K1 on the largest layer,
    K5, K8 and K9 on the largest layer of each direction (depths 0 and
    2),
    K11 and K12 on the largest ksource_bfs (int32) and sssp (float32)
    layers, against their plain versions with the phase-3 and phase-9
    contracts, and K6 and K10 under the four policies at depths 0 and 2
    (`wide_traversal_gates`)."""
    import repro_torch.bfs as bfs
    from repro_torch.kernels import ops
    roots = pick_roots(g, WIDE_BATCH, seed + 3)
    assert len(roots) == WIDE_BATCH
    label = f"_b{WIDE_BATCH}"
    ct = bfs.plan(g, bfs.TraversalSpec(**BUILTIN_KNOBS,
                                       tile=BUILTIN_CSR_TILE))
    sell_graph = sell.sell_graph(bfs.plan(
        sell, bfs.TraversalSpec(**BUILTIN_KNOBS)).resolved.tile)
    dirs = direction_spies(ops, "gather_expand_batched")
    with plan_layers_spy(ops) as layers, \
            Spy(ops, {"plan_union": None,
                      "gather_expand_batched": listed}) as spy, \
            MeasureCapture(ops) as measured, \
            contextlib.ExitStack() as stack:
        for d in dirs.values():
            stack.enter_context(d)
        ct.run_batched(roots)
    measure_gates(measured.calls, label)
    del measured
    plan_gates(layers.calls, {"csr": None, "sell": sell_graph}, label)
    cap = spy.best["gather_expand_batched"]
    k3 = phase_kernels(cap, g.n_vertices, g.n_vertices_padded, reps,
                       label=label)
    phase_prefetch(cap, reps, k3["gather_expand_batched"], label=label)
    layer_kernel_both_ways("csr", cap, dirs, reps, label)
    del cap, spy, layers, dirs
    phase_sell_layer(g, roots, reps, label)
    relax = {}
    for alg, fields in (("ksource_bfs", {}),
                        ("sssp", dict(max_layers=512))):
        relax[alg] = Spy(ops, {"gather_relax_batched": listed,
                               "sell_relax_batched": listed})
        with relax[alg]:
            for fmt in (g, sell):
                bfs.plan(fmt, bfs.TraversalSpec(algorithm=alg, **fields)) \
                    .run_batched(roots)
    phase_relax_kernels(relax, reps, label=label, fold=False)
    wide_traversal_gates(g, sell, roots, label)
    log(f"wide batch: {WIDE_BATCH} roots (2 mask words) at "
        f"V={g.n_vertices}: the measure kernel, the planner, K3, K4, K5, "
        f"K6, K8, K9, K10, K11 and K12 equal their plain versions")


def sssp_certificate(g, res, roots, src, dst, w) -> None:
    """The optimality certificate of every root's distances, on the card:
    no edge from a reached vertex relaxes (``fl32(dist[u] + w) >=
    dist[v]``, v reached), the root is 0 and its own parent, and every
    other reached v is ``fl32(dist[p] + w(p, v))`` for its parent p,
    (p, v) an edge (searched in the sorted int64 edge keys)."""
    import torch
    from repro_torch.algorithms.semiring import edge_weight
    n = g.n_vertices
    keys = src * n + dst          # CSR order: sorted
    ids = torch.arange(n, device=src.device)
    for b, r in enumerate(roots):
        dist = res.values[b, :n]
        parent = res.state.parent[b, :n].long()
        reached = torch.isfinite(dist)
        assert float(dist[r]) == 0.0 and int(parent[r]) == r, f"root {r}"
        from_reached = reached[src]
        assert bool(reached[dst][from_reached].all()), \
            f"root {r}: an edge leaves the reached set"
        relaxed = dist[src] + w
        assert bool((relaxed >= dist[dst])[from_reached].all()), \
            f"root {r}: an edge still relaxes"
        v = torch.nonzero(reached & (ids != r)).flatten()
        p = parent[v]
        assert bool(((p >= 0) & (p < n)).all()) and bool(reached[p].all())
        assert torch.equal(dist[v], dist[p] + edge_weight(p, v)), \
            f"root {r}: a distance is not its parent's plus the edge"
        k = p * n + v
        pos = torch.searchsorted(keys, k).clamp(max=keys.numel() - 1)
        assert torch.equal(keys[pos], k), f"root {r}: a parent is not a " \
                                          f"neighbour"


def cc_min_labels(g):
    """Min vertex id of each vertex's component, from scipy on the host."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    import torch
    n, e = g.n_vertices, g.n_edges
    mat = sp.csr_matrix((np.ones(e, np.int8), g.rows[:e].cpu().numpy(),
                         g.colstarts.cpu().numpy()), shape=(n, n))
    n_comp, labels = connected_components(mat, directed=False)
    _, first = np.unique(labels, return_index=True)   # least id each
    return torch.from_numpy(first[labels].astype(np.int32)), n_comp


def phase_portfolio(g, roots, oracle, reps: int):
    """Phase 9: the semiring portfolio at the main path's size on CSR and
    on the autotuner's SELL layout.  ksource_bfs (8 roots) equals the
    level-synchronous depths; sssp (8 roots, max_layers 512) ends with
    an empty frontier and passes the edge certificate; cc (one root)
    equals scipy's min-id components; CSR and SELL agree bitwise on
    values, parents, layers and stats columns 0-4.  Returns ({kernel:
    results}, {kernel: launches}, the SELL planner's row, {algorithm:
    (values, parents) of the CSR run, on the host}): K11 and K12 are
    timed on the largest
    layers of the ksource_bfs runs, so their launches are those runs'
    (the sssp and cc runs' are printed beside them).  Every measure call
    of each warm-up run is replayed against its plain version
    (`measure_gates`); K13's row is the count-only arm on the sssp CSR
    run's (3B, W) counts (`count_only_row`), whose launches it counts."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch import formats
    from repro_torch.algorithms.semiring import INT_INF, edge_weight
    from repro_torch.obs.metrics import clear_degrade_log, degrade_log
    from repro_torch.kernels import ops
    n = g.n_vertices
    layouts = {"csr": g, "sell": formats.build(g, "auto")}
    assert isinstance(layouts["sell"], formats.SellFormat)
    src = torch.repeat_interleave(torch.arange(n, device=g.rows.device),
                                  g.degrees().long(), output_size=g.n_edges)
    dst = g.rows[:g.n_edges].long()
    w = edge_weight(src, dst)
    cc_want, n_comp = cc_min_labels(g)
    log(f"scipy: {n_comp} components")
    cc_want = cc_want.to(g.rows.device)
    kernel_of = {"csr": "gather_relax_batched", "sell": "sell_relax_batched"}
    launches = {}
    per_run = {}
    cap = {}
    results = {}
    kept = {}
    for alg, alg_roots, fields in (
            ("ksource_bfs", roots, {}), ("sssp", roots,
                                         dict(max_layers=512)),
            ("cc", roots[:1], dict(max_layers=512))):
        # the kernels are compared on the int32 and float32 layers
        capture = (cap.setdefault(alg, Spy(ops, {
            "plan_union": None, **dict.fromkeys(kernel_of.values(),
                                                listed)}))
            if alg != "cc" else contextlib.nullcontext())
        for lay, fmt in layouts.items():
            ct = bfs.plan(fmt, bfs.TraversalSpec(algorithm=alg, **fields))
            with capture, MeasureCapture(ops) as measured:  # warm-up
                ct.run_batched(alg_roots)
            torch.cuda.synchronize()
            # every measure call of the run, at the shapes it took
            measure_gates(measured.calls, f"_{alg}_{lay}",
                          both_directions=False)
            if alg == "sssp" and lay == "csr":
                popcount_row = count_only_row(measured.calls, reps)
            del measured
            clear_degrade_log()
            ops.reset_kernel_launches()
            times = []
            with CallCount(PLAIN_PLANNING + PLAIN_COUNTERS) as plain:
                for _ in range(3):
                    t0 = time.perf_counter()
                    res = ct.run_batched(alg_roots)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    if len(times) == 1:
                        counted = dict(ops.KERNEL_LAUNCHES)
            assert not degrade_log(), degrade_log()
            k = kernel_of[lay]
            assert counted[k] > 0, f"{alg} {lay}: {k} never launched"
            assert not any(plain.counts.values()), \
                f"{alg} {lay}: plain planning ran: {plain.counts}"
            per_run[f"{alg} {lay}"] = counted[k]
            if alg == "ksource_bfs":
                launches[k] = counted[k]
            if alg == "sssp" and lay == "csr":
                launches["popcount"] = counted["popcount"]
            n_layers = int(res.state.layer)
            assert n_layers < ct.resolved.max_layers, \
                f"{alg} {lay}: hit max_layers"
            assert counted["plan_union"] == counted[k] == n_layers, \
                f"{alg} {lay}: {counted['plan_union']} planner and " \
                f"{counted[k]} {k} launches for {n_layers} layers"
            assert counted["measure"] == n_layers + 1, \
                f"{alg} {lay}: {counted['measure']} measure launches"
            assert int(ops.popcount(res.state.frontier)) == 0
            vals = res.values[:, :n]
            if alg == "ksource_bfs":
                for b, r in enumerate(alg_roots):
                    d = oracle(r)
                    want = torch.where(d >= 0, d, int(INT_INF))
                    assert torch.equal(vals[b], want), \
                        f"ksource {lay}: root {r} depths differ"
            elif alg == "sssp":
                sssp_certificate(g, res, alg_roots, src, dst, w)
            else:
                assert torch.equal(vals[0], cc_want), f"cc {lay}: labels"
            if lay == "csr":
                base = res
                kept[alg] = (res.values[:, :n].cpu(),
                             res.state.parent[:, :n].cpu())
            else:
                for what, a, b in (
                        ("values", res.values.view(torch.int32),
                         base.values.view(torch.int32)),
                        ("parents", res.state.parent, base.state.parent),
                        ("depths", res.depths, base.depths),
                        ("stats columns 0-4", res.stats[:, :5],
                         base.stats[:, :5])):
                    assert torch.equal(a, b), \
                        f"{alg}: SELL and CSR {what} differ"
                assert n_layers == int(base.state.layer)
            log(f"portfolio {alg} {lay}: {len(alg_roots)} roots, "
                f"{n_layers} layers, runs {[round(t, 6) for t in times]} s; "
                f"launches {k}={counted[k]}, plan_union="
                f"{counted['plan_union']}, measure={counted['measure']}, "
                f"popcount={counted['popcount']}, no plain planning or "
                f"counters" + (
                    "; equals CSR bitwise (values, parents, layers, stats "
                    "0-4)" if lay == "sell" else ""))
            results[(alg, lay)] = times
            del ct
        del res, base
    log(json.dumps({"portfolio_launches": per_run}))
    del src, dst, w, layouts
    torch.cuda.empty_cache()
    kres = phase_relax_kernels(cap, reps)
    sell_plan = plan_row(cap["ksource_bfs"].best["sell_relax_batched"]
                         ["before"]["plan_union"], reps)
    log_row("plan_union_sell", sell_plan, algorithm="ksource_bfs")
    del cap
    torch.cuda.empty_cache()
    rows = {name: dict(kres["ksource_bfs"][name])
            for name in kernel_of.values()}
    rows["popcount"] = popcount_row
    return rows, launches, sell_plan, kept


def synthetic_k7_stream(cap, check_frontier: bool, seed: int) -> dict:
    """K7's inputs at the scale of a captured layer (``cap``: its batch,
    slot count, bitmaps and P), made on the card from ``seed``: each
    root's slots in runs of one owner (nbr top-down, cand bottom-up) of
    1-31 slots, the second run `SYN_HUB_RUN` long (longer than K7's
    16-slot chunk, starting mid-chunk); the other side random; about
    64% of the slots valid, at random (not a prefix of a row), the last
    3 valid; the slot count cut to one that is not a multiple of 16."""
    import torch
    n = cap["kw"]["n_vertices"]
    n_batch, n_slots = cap["cand"].shape
    n_slots -= 5 if n_slots % 16 == 0 else 0
    dev = cap["cand"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    total = n_batch * n_slots
    lens = torch.randint(1, 32, (total // 12 + 2,), generator=gen,
                         device=dev)
    lens[:2] = torch.tensor([5, SYN_HUB_RUN], device=dev)
    owners = torch.randint(0, n, lens.shape, generator=gen, device=dev,
                           dtype=torch.int32)
    owner = torch.repeat_interleave(owners, lens)
    assert owner.numel() >= total, "too few owner runs"
    owner = owner[:total].view(n_batch, n_slots).clone()
    del lens, owners
    other = torch.randint(0, n, (n_batch, n_slots), generator=gen,
                          device=dev, dtype=torch.int32)
    valid = torch.randint(0, 100, (n_batch, n_slots), generator=gen,
                          device=dev, dtype=torch.uint8) < 64
    valid[:, -3:] = True
    nbr, cand = (other, owner) if check_frontier else (owner, other)
    return dict(nbr=nbr, cand=cand, valid=valid, frontier=cap["frontier"],
                visited=cap["visited"], out_init=cap["out_init"],
                p_init=cap["p_init"], key=int(valid.sum()),
                kw=dict(n_vertices=n, check_frontier=check_frontier))


def k7_gate(cap, g, what: str, marks: bool = True):
    """K7 against its plain version on one call's inputs (``cap``: the
    streams, the bitmaps, ``out_init`` and ``p_init``, copied for each
    arm, and ``kw``), under K3's contract: the marked sets, ``out|delta``
    and ``visited|delta`` bitwise; with ``marks``, every mark a frontier
    neighbour of its vertex.  Returns (0, the kernel's racy P)."""
    import torch
    from repro_torch.kernels import frontier_expand as fe
    from repro_torch.kernels import restoration as rest
    n = g.n_vertices
    streams = (cap["nbr"], cap["cand"], cap["valid"], cap["frontier"],
               cap["visited"])
    out_k, p_k = cap["out_init"].clone(), cap["p_init"].clone()
    fe.frontier_expand_cuda(*streams, out_k, p_k, **cap["kw"])
    out_p, p_p = cap["out_init"].clone(), cap["p_init"].clone()
    fe.frontier_expand_plain(*streams, out_p, p_p, **cap["kw"])
    torch.cuda.synchronize()
    _, delta_k = rest.restoration_plain(p_k, n)
    _, delta_p = rest.restoration_plain(p_p, n)
    err = int(((p_k < 0) != (p_p < 0)).sum())
    for a, b in ((out_k | delta_k, out_p | delta_p),
                 (cap["visited"] | delta_k, cap["visited"] | delta_p)):
        err = max(err, int((a != b).sum()))
    assert err == 0, f"frontier_expand ({what}) disagrees with its plain " \
                     f"version"
    del out_p, p_p, delta_k, delta_p
    if marks:
        check_marks(dict(kw=dict(n_vertices=n), rows=g.rows,
                         colstarts=g.colstarts), p_k, cap["frontier"])
    return err, p_k


def phase_expand_kernel(cap, g, reps: int, stream: str = "captured"):
    """K7 against its plain version on a stream (``cap``: a captured
    layer's call, or `synthetic_k7_stream`), under K3's contract: the
    marked sets, ``out|delta`` and ``visited|delta`` bitwise; every mark
    a frontier neighbour of its vertex on a captured layer, its parent
    a real vertex (bottom-up: in the frontier) on a synthetic one."""
    import torch
    from repro_torch.kernels import frontier_expand as fe
    n, kw = g.n_vertices, cap["kw"]
    streams = (cap["nbr"], cap["cand"], cap["valid"], cap["frontier"],
               cap["visited"])
    err, p_k = k7_gate(cap, g, stream, stream == "captured")
    n_marked = int((p_k < 0).sum())
    assert n_marked > 0, f"frontier_expand ({stream}): nothing discovered"
    if stream != "captured":
        gate = (p_k[p_k < 0] + n).long()
        assert bool(((gate >= 0) & (gate < n)).all()), "parent out of range"
        if kw["check_frontier"]:
            rows = torch.nonzero(p_k < 0)[:, 0]
            fw = cap["frontier"][rows, gate >> 5]
            assert bool((((fw >> (gate & 31).int()) & 1) == 1).all()), \
                "a marked parent is not in the frontier"
    out_buf, p_buf = cap["out_init"].clone(), cap["p_init"].clone()

    def reset():
        out_buf.copy_(cap["out_init"])
        p_buf.copy_(cap["p_init"])

    run = lambda fn: lambda: fn(*streams, out_buf, p_buf, **kw)
    n_batch, n_slots = cap["cand"].shape
    # the valid flags of every slot, nbr and cand of the valid ones, the
    # three bitmaps read, out written, one P word per discovery
    bytes_ = (n_batch * n_slots + 8 * cap["key"]
              + 4 * 4 * cap["frontier"].numel() + 4 * n_marked)
    res = dict(max_abs_err=err, bytes=bytes_, n_marked=n_marked,
               ms=cuda_ms(run(fe.frontier_expand_cuda), reps, setup=reset),
               plain_ms=cuda_ms(run(fe.frontier_expand_plain), 1,
                                setup=reset))
    res["bound_ms"] = bytes_ / HBM_BYTES_PER_S * 1e3
    log(json.dumps({"kernel": "frontier_expand_batched", "stream": stream,
                    "ms": res["ms"], "plain_ms": res["plain_ms"],
                    "bytes": bytes_, "bound_ms": res["bound_ms"],
                    "max_abs_err": err, "valid_slots": cap["key"],
                    "slots": n_batch * n_slots, "marked": n_marked,
                    "check_frontier": kw["check_frontier"]}))
    return res


def phase_expand_streams(ct, g, roots, reps: int, seed: int):
    """K7 on the materialized path's largest layer of each direction
    (`phase_expand_kernel`), then on a synthetic stream at that scale in
    each direction (`synthetic_k7_stream`).  Returns the numbers of the
    layer with the most valid slots."""
    import torch
    from repro_torch.kernels import ops
    spies = {bu: Spy(ops, {"expand_batched": (
        lambda a, bu=bu: int(a["valid"].sum())
        if bool(a["check_frontier"]) == bu else -1)}) for bu in (False, True)}
    with contextlib.ExitStack() as stack:
        for spy in spies.values():
            stack.enter_context(spy)
        res = ct.run_batched(roots)
    assert not bool(res.stats[:, 6].any()), "edges truncated"
    log("path materialized: every layer's truncated count is 0")
    del res
    best, states = None, {}
    for bu, spy in spies.items():
        cap = spy.best["expand_batched"]
        assert cap["key"] >= 0, f"no {'bottom-up' if bu else 'top-down'} layer"
        r = phase_expand_kernel(cap, g, reps)
        if best is None or cap["key"] > best[0]:
            best = (cap["key"], r)
        # the layer's state and its stream's shape, for the synthetic one
        states[bu] = {k: cap[k] for k in ("frontier", "visited", "out_init",
                                          "p_init", "kw")}
        states[bu]["cand"] = cap["cand"][:, :1].expand(cap["cand"].shape)
        spy.best.clear()
        del cap
        torch.cuda.empty_cache()
    for bu, state in states.items():
        syn = synthetic_k7_stream(state, bu, seed + bu)
        phase_expand_kernel(syn, g, reps, stream="synthetic")
        del syn
        torch.cuda.empty_cache()
    return best[1]


def phase_materialized(g, roots, base, oracle, edges: int, reps: int,
                       seed: int):
    """Phase 10: the materialized pipeline at the main path's size, on
    CSR (K2's stream arm + the apportionment + K7 + K1) and on the
    autotuner's SELL layout (K8 over every slab group + K1), all-auto
    policy: each timed over 3 runs with its peak device memory, held to
    the main path (`run_path`); K7 against its plain version on the
    largest captured layer of each direction and on a synthetic stream
    at that scale (`phase_expand_streams`); K2's stream arm and the
    apportionment on the same layers and a synthetic hub
    (`phase_stream`).  Returns ({kernel: results}, {kernel: launches}):
    K7's, K2's and the apportionment's launches and rows (K2's stream
    arm and the apportionment timed on the bottom-up layer); K8's stay those of phase 5b's work-listed run, whose layer
    its time is measured on (its full sweep here is printed)."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch import formats
    from repro_torch.kernels import ops
    launches = {}
    kres = {}
    for name, fmt, kernels, per_layer in (
            ("materialized", g, ("frontier_expand_batched", "restoration"),
             3),
            ("sell_materialized", formats.build(g, "auto"),
             ("sell_expand_batched", "restoration"), 2)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ct, launched, _ = run_path(fmt, g, roots, name,
                                   dict(pipeline="materialized"), kernels,
                                   per_layer, base, oracle, edges,
                                   (0, 1, 2, 3, 4))
        peak = torch.cuda.max_memory_allocated()
        log(f"path {name}: batch {len(roots)}, peak device memory "
            f"{peak / 2**30:.3f} GiB")
        if name == "materialized":
            # K2 runs here, no longer on the main path
            for k in (kernels[0], "frontier_compact_batched", "apportion"):
                assert launched[k] > 0, f"{name}: {k} never launched"
                launches[k] = launched[k]
            kres["frontier_expand_batched"] = phase_expand_streams(
                ct, g, roots, reps, seed)
            torch.cuda.empty_cache()
            kres["frontier_compact_batched"], kres["apportion"] = \
                phase_stream(ct, g, roots, reps)
        del ct
        bfs.clear_plan_cache()
        torch.cuda.empty_cache()
    return kres, launches


class MeasureCapture:
    """Records every `ops.measure` call of the traversals run inside the
    block: the words (copied), the degree array, the layer and, copied,
    the layer log as it stood before the call (the wrapper is wrapped,
    not changed).  ``calls`` lists them in order."""

    def __init__(self, ops):
        self.ops, self.calls = ops, []

    def __enter__(self):
        self._orig = orig = self.ops.measure

        def wrapped(frontier, visited=None, deg=None, *, log=None, layer=0,
                    discovered=True):
            self.calls.append(dict(
                frontier=frontier.clone(),
                visited=None if visited is None else visited.clone(),
                deg=deg, log=None if log is None else copy_log(log),
                layer=layer, discovered=discovered))
            return orig(frontier, visited, deg, log=log, layer=layer,
                        discovered=discovered)
        self.ops.measure = wrapped
        return self

    def __exit__(self, *exc):
        self.ops.measure = self._orig
        return False


def copy_log(log):
    """A `bitmap_kernels.LayerLog` with its buffers copied."""
    return log._replace(stats=log.stats.clone(), depths=log.depths.clone(),
                        ctrl=log.ctrl.clone(), acc=log.acc.clone())


def measure_gate(call) -> int:
    """One captured measure call replayed by the kernel and by its plain
    version, each on a copy of the call's log (and with its
    ``discovered``): as captured and, where it was not already, without
    the unvisited pair and by the count-only arm.  Counters, batch sums,
    total, stats, depths, ``ctrl`` and the accumulator bitwise; returns
    the mode the layer took (-1 without a log)."""
    import torch
    from repro_torch.kernels import bitmap_kernels as bk
    variants = [(call["visited"], call["deg"]), (None, call["deg"]),
                (None, None)]
    first = 2 if call["deg"] is None else 0 if call["visited"] is not None \
        else 1
    mode = -1
    for visited, deg in variants[first:]:
        kw = dict(layer=call["layer"], discovered=call["discovered"])
        logs = [None if call["log"] is None else copy_log(call["log"])
                for _ in range(2)]
        got = bk.measure_cuda(call["frontier"], visited, deg, log=logs[0],
                              **kw)
        want = bk.measure_plain(call["frontier"], visited, deg, log=logs[1],
                                **kw)
        pairs = list(zip(got, want))
        if logs[0] is not None:
            pairs += list(zip(logs[0][:4], logs[1][:4]))
            if mode < 0 and int(logs[1].ctrl[0]):
                mode = int(logs[1].ctrl[1])
        for a, b in pairs:
            assert torch.equal(a, b), \
                f"measure disagrees with its plain version at layer " \
                f"{call['layer']} (unvisited={visited is not None}, " \
                f"degrees={deg is not None})"
    return mode


def measure_gates(calls, label: str, both_directions: bool = True) -> None:
    """`measure_gate` on every captured call; with ``both_directions``
    (the BFS host loop) the layers must take both directions."""
    modes = [measure_gate(c) for c in calls]
    if both_directions:
        assert 2 in modes and 1 in modes, \
            f"measure{label}: one direction only"
    shapes = sorted({tuple(c["frontier"].shape) for c in calls})
    arms = {"unvisited pair": sum(c["visited"] is not None for c in calls),
            "degrees only": sum(c["visited"] is None and c["deg"] is not None
                                for c in calls),
            "count-only": sum(c["deg"] is None for c in calls),
            "discovered=False": sum(not c["discovered"] for c in calls)}
    log(f"measure{label}: {len(calls)} calls at shapes {shapes} ({arms}; "
        f"{modes.count(1)} top-down, {modes.count(2)} bottom-up layers, "
        f"{modes.count(-1) + modes.count(0)} other) equal measure_plain "
        f"bitwise as captured and by the arms below each (counters, sums, "
        f"total, mode, stats columns 0-4, depths)")


def count_only_row(calls, reps: int) -> dict:
    """K13's row: the measure kernel's count-only arm timed on the
    captured count-only call with the most set bits, as the path
    launches it; bytes: the words read once, the counters written."""
    from repro_torch.kernels import bitmap_kernels as bk
    call = max((c for c in calls if c["deg"] is None),
               key=lambda c: int(bk.popcount_plain(c["frontier"])))
    f = call["frontier"]
    res = dict(max_abs_err=0, bytes=4 * f.numel() + 4 * (4 * f.shape[0] + 5),
               plain_ms=cuda_ms(lambda: bk.measure_plain(f),
                                max(3, reps // 4)),
               shape=list(f.shape))
    timed_kernel(res, lambda: bk.measure_cuda(f), reps)
    res["bound_ms"] = res["bytes"] / HBM_BYTES_PER_S * 1e3
    log_row("popcount", res)
    return res


def measure_row(calls, reps: int) -> dict:
    """The measure kernel timed on the captured layer with the largest
    frontier, as the main path launches it (with the unvisited pair and
    its log) and without the pair; bytes: the words and the degree
    array read once, the counters and the log's row written."""
    from repro_torch.kernels import bitmap_kernels as bk
    call = max(calls, key=lambda c: int(bk.popcount_plain(c["frontier"])))
    f, vis, deg = call["frontier"], call["visited"], call["deg"]
    scratch = copy_log(call["log"])
    n_batch, n_words = f.shape
    run = lambda v: lambda: bk.measure_cuda(f, v, deg, log=scratch,
                                            layer=call["layer"])
    res = dict(max_abs_err=0,
               bytes=4 * f.numel() * (2 if vis is not None else 1)
               + 4 * deg.numel() + 4 * (4 * n_batch + 9) + 4 * n_batch,
               ms_without_unvisited=device_ms(run(None), reps),
               ms_count_only=device_ms(lambda: bk.measure_cuda(f), reps),
               plain_ms=cuda_ms(lambda: bk.measure_plain(
                   f, vis, deg, log=copy_log(call["log"]),
                   layer=call["layer"]), max(3, reps // 4)),
               layer=call["layer"], roots=n_batch)
    timed_kernel(res, run(vis), reps)
    res["bound_ms"] = res["bytes"] / HBM_BYTES_PER_S * 1e3
    log_row("measure", res)
    return res


def measure_wide_row(deg, n_words: int, seed: int, reps: int) -> dict:
    """The measure kernel at `WIDE_BATCH` roots at the main path's width
    on random words (1 bit in 16 of the frontier set, half the vertices
    visited): against its plain version (`measure_gate`: the three arms
    bitwise), timed back to back with and without the unvisited pair,
    beside its bound (the words and the degrees read once, as the
    kernel reads the degrees for up to 512 roots)."""
    import torch
    from repro_torch.core import bitmap as bm
    from repro_torch.kernels import bitmap_kernels as bk
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def words(p):
        return bm.pack_bool(torch.rand((WIDE_BATCH, 32 * n_words),
                                       generator=gen, device="cuda") < p)
    f, vis = words(1 / 16), words(1 / 2)
    measure_gate(dict(frontier=f, visited=vis, deg=deg, log=None, layer=0,
                      discovered=True))
    res = dict(max_abs_err=0,
               bytes=8 * f.numel() + 4 * deg.numel()
               + 4 * (4 * WIDE_BATCH + 5),
               roots=WIDE_BATCH,
               ms_without_unvisited=device_ms(
                   lambda: bk.measure_cuda(f, None, deg), reps),
               plain_ms=cuda_ms(lambda: bk.measure_plain(f, vis, deg),
                                max(3, reps // 4)))
    timed_kernel(res, lambda: bk.measure_cuda(f, vis, deg), reps)
    res["bound_ms"] = res["bytes"] / HBM_BYTES_PER_S * 1e3
    log_row(f"measure_b{WIDE_BATCH}_main_width", res)
    log(f"measure at {WIDE_BATCH} roots, {n_words} words: the three arms "
        f"equal measure_plain bitwise")
    return res


def stream_bytes(q, words) -> int:
    """Bytes K2's stream arm must move: the words read once, the degrees
    of the set bits (a 32-byte sector, 8 vertices' degrees, for every
    byte of the words with a set bit: the least the card reads them
    in), the queue written, and cum for each entry, the counts, totals
    and truncated counts."""
    import torch
    n_batch, size = q.queue.shape
    sectors = int((words.contiguous().view(torch.uint8) != 0).sum())
    return (4 * words.numel() + 32 * sectors + 4 * n_batch * size
            + 4 * int(q.count.clamp(max=size).sum()) + 12 * n_batch)


def apportion_bytes(q, valid, colstarts_read: int) -> int:
    """Bytes the apportionment must move: every slot's valid flag, u and
    v and a rows entry for each valid slot, the queue and cum entries
    and one colstarts entry for each real entry read once."""
    n_valid = int(valid.sum())
    entries = int(q.count.clamp(max=q.queue.shape[1]).sum())
    return (valid.numel() + 12 * n_valid + 8 * entries
            + 4 * colstarts_read + 8 * q.count.numel())


def stream_gate(words, kw, colstarts, rows, what: str):
    """K2's stream arm and the apportionment against their plain versions
    on one layer's words: the queue, counts, totals and truncated counts
    bitwise, cum on each root's entries, the stream's valid flags
    bitwise, u and v wherever valid holds.  Returns (CUDA queue, CUDA
    stream, plain stream)."""
    import torch
    from repro_torch.kernels import compact as ck
    args = (kw["size"], kw["fill"], kw["deg"], kw["n_vertices"],
            kw["n_slots"])
    got = ck.queue_cuda(words, *args)
    want = ck.queue_plain(words, *args)
    for name in ("queue", "count", "total", "truncated"):
        assert torch.equal(getattr(got, name), getattr(want, name)), \
            f"frontier_queue ({what}): {name} differs from its plain version"
    size = want.queue.shape[1]
    for b in range(want.queue.shape[0]):
        k = min(int(want.count[b]), size)
        assert torch.equal(got.cum[b, :k], want.cum[b, :k]), \
            f"frontier_queue ({what}): cum of root {b} differs"
    del want
    return (got,) + apportion_gate(colstarts, rows, got, kw["n_vertices"],
                                   kw["n_slots"], what)


def apportion_gate(colstarts, rows, q, n_vertices: int, n_slots: int,
                   what: str):
    """The apportionment against its plain version on one queue ``q``:
    the valid flags and truncated counts bitwise, u and v wherever valid
    holds.  Returns (CUDA stream, plain stream)."""
    import torch
    from repro_torch.kernels import apportion as ap
    stream_k = ap.apportion_cuda(colstarts, rows, q, n_slots)
    stream_p = ap.apportion_plain(colstarts, rows, q.queue, n_vertices,
                                  n_slots)
    valid = stream_p[2]
    assert torch.equal(stream_k[2], valid) and \
        torch.equal(stream_k[3], stream_p[3]), \
        f"apportion ({what}): valid or truncated differ"
    for i, name in ((0, "u"), (1, "v")):
        assert torch.equal(stream_k[i][valid], stream_p[i][valid]), \
            f"apportion ({what}): {name} differs where valid"
    return stream_k, stream_p


def queue_gate(colstarts, words, q, list_size: int, n_vertices: int,
               n_slots: int, what: str) -> None:
    """A dense-mask queue ``q`` of ``words`` (`engine.dense_queue`)
    against K2's stream arm on the same words: queue, counts, totals and
    truncated counts bitwise, cum on each root's entries."""
    import torch
    from repro_torch.core import bitmap as bm
    from repro_torch.kernels import compact as ck
    deg = bm.degree_matrix(colstarts[1:] - colstarts[:-1],
                           words.shape[1] * bm.BITS_PER_WORD).reshape(-1)
    want = ck.queue_cuda(words.contiguous(), list_size, n_vertices, deg,
                         n_vertices, n_slots)
    for name in ("queue", "count", "total", "truncated"):
        assert torch.equal(getattr(q, name), getattr(want, name)), \
            f"dense queue ({what}): {name} differs from K2's stream arm"
    for b in range(want.queue.shape[0]):
        k = min(int(want.count[b]), list_size)
        assert torch.equal(q.cum[b, :k], want.cum[b, :k]), \
            f"dense queue ({what}): cum of root {b} differs from K2's"


#: the wrappers `replayed` gates, by module
REPLAYED = (("repro_torch.kernels.ops", "expand_batched"),
            ("repro_torch.kernels.ops", "restore"),
            ("repro_torch.kernels.ops", "apportion"),
            ("repro_torch.core.engine", "dense_queue"))


@contextlib.contextmanager
def replayed(g, what: str):
    """While the block runs, every call of `ops.expand_batched` (K7; the
    B = 1 calls of `ops.expand` go through it), `ops.restore` (K1) and
    `ops.apportion` is first replayed through the kernel and its plain
    version on copies of its inputs (`k7_gate`, K1 bitwise, the
    apportionment by `apportion_gate`), then runs as it was made; every
    `engine.dense_queue` is held to K2's stream arm on its words
    (`queue_gate`).  The replays call the kernels directly, so they
    count no launch.  The wrappers are wrapped, not changed.  Yields
    {wrapper: [the shape of each call's P, stream or words]}."""
    import importlib
    import torch
    from repro_torch.kernels import restoration as rest
    seen = {name: [] for _, name in REPLAYED}
    orig = {name: getattr(importlib.import_module(m), name)
            for m, name in REPLAYED}

    def expand_batched(nbr, cand, valid, frontier, visited, out_init,
                       p_init, *, n_vertices, check_frontier=False):
        kw = dict(n_vertices=n_vertices, check_frontier=check_frontier)
        k7_gate(dict(nbr=nbr, cand=cand, valid=valid, frontier=frontier,
                     visited=visited, out_init=out_init.clone(),
                     p_init=p_init.clone(), kw=kw), g, what)
        seen["expand_batched"].append(tuple(nbr.shape))
        return orig["expand_batched"](nbr, cand, valid, frontier, visited,
                                      out_init, p_init, **kw)

    def restore(parent, *, n_vertices):
        got = rest.restoration_cuda(parent.clone(), n_vertices)
        want = rest.restoration_plain(parent.clone(), n_vertices)
        assert all(map(torch.equal, got, want)), \
            f"restoration ({what}) disagrees with its plain version"
        seen["restore"].append(tuple(parent.shape))
        return orig["restore"](parent, n_vertices=n_vertices)

    def apportion(colstarts, rows, queue, *, n_vertices, n_slots):
        apportion_gate(colstarts, rows, queue, n_vertices, n_slots, what)
        torch.cuda.empty_cache()
        seen["apportion"].append((tuple(queue.queue.shape), n_slots))
        return orig["apportion"](colstarts, rows, queue,
                                 n_vertices=n_vertices, n_slots=n_slots)

    def dense_queue(colstarts, words, list_size, n_vertices, n_slots):
        q = orig["dense_queue"](colstarts, words, list_size, n_vertices,
                                n_slots)
        queue_gate(colstarts, words, q, list_size, n_vertices, n_slots,
                   what)
        seen["dense_queue"].append(tuple(words.shape))
        return q

    wrappers = dict(expand_batched=expand_batched, restore=restore,
                    apportion=apportion, dense_queue=dense_queue)
    for m, name in REPLAYED:
        setattr(importlib.import_module(m), name, wrappers[name])
    try:
        yield seen
    finally:
        for m, name in REPLAYED:
            setattr(importlib.import_module(m), name, orig[name])


#: `KERNEL_LAUNCHES` counter of each replayed wrapper
REPLAYED_COUNTER = {"expand_batched": "frontier_expand_batched",
                    "restore": "restoration", "apportion": "apportion"}


def replay_report(seen, launches, what: str) -> str:
    """Asserts that the replayed run made as many calls of each gated
    kernel as ``launches`` (a run of the same path) counts; returns the
    calls' shapes, printable."""
    for name, counter in REPLAYED_COUNTER.items():
        assert len(seen[name]) == launches.get(counter, 0), \
            f"{what}: {len(seen[name])} replayed {name} calls, " \
            f"{launches.get(counter, 0)} launches"
    return json.dumps({k: sorted(set(v)) for k, v in seen.items() if v})


def phase_stream(ct, g, roots, reps: int) -> dict:
    """Phase 10b: K2's stream arm and the apportionment on the largest
    layer of each direction of a materialized CSR run, against their
    plain versions (`stream_gate`), timed with CUDA events beside their
    bounds, then on a synthetic layer whose stream is cut inside a hub's
    list (a hub keeps its list prefix).  Returns the rows of
    ``frontier_compact_batched`` (the stream arm) and ``apportion`` on the
    bottom-up layer."""
    import torch
    from repro_torch.core import bitmap as bm
    from repro_torch.kernels import apportion as ap
    from repro_torch.kernels import bitmap_kernels as bk
    from repro_torch.kernels import compact as ck
    from repro_torch.kernels import ops
    calls = []
    orig = ops.frontier_queue

    def wrapped(words, **kw):
        calls.append((words.clone(), kw))
        return orig(words, **kw)
    ops.frontier_queue = wrapped
    try:
        res = ct.run_batched(roots)
    finally:
        ops.frontier_queue = orig
    modes = res.stats[:len(calls), 3].tolist()
    assert len(calls) == int(res.state.layer), (len(calls), res.state.layer)
    colstarts, rows = g.colstarts, g.rows
    rows_out = {}
    for mode, name in ((1, "top-down"), (2, "bottom-up")):
        layer = max((i for i, m in enumerate(modes) if m == mode),
                    key=lambda i: int(bk.popcount_plain(calls[i][0])))
        words, kw = calls[layer]
        q, stream_k, stream_p = stream_gate(words, kw, colstarts, rows, name)
        entries = int(q.count.clamp(max=q.queue.shape[1]).sum())
        n_valid = int(stream_p[2].sum())
        del stream_k, stream_p
        args = (kw["size"], kw["fill"], kw["deg"], kw["n_vertices"],
                kw["n_slots"])
        k2 = dict(max_abs_err=0, bytes=stream_bytes(q, words),
                  plain_ms=cuda_ms(lambda: ck.queue_plain(words, *args), 3),
                  layer=layer, entries=entries, direction=name)
        timed_kernel(k2, lambda: ck.queue_cuda(words, *args), reps)
        torch.cuda.empty_cache()
        out = ap.apportion_cuda(colstarts, rows, q, kw["n_slots"])
        valid = out[2]
        del out
        app = dict(max_abs_err=0,
                   bytes=apportion_bytes(q, valid, entries),
                   plain_ms=cuda_ms(lambda: ap.apportion_plain(
                       colstarts, rows, q.queue, kw["n_vertices"],
                       kw["n_slots"]), 1),
                   layer=layer, valid_slots=n_valid,
                   slots=valid.numel(), direction=name)
        timed_kernel(app, lambda: ap.apportion_cuda(
            colstarts, rows, q, kw["n_slots"]), max(3, reps // 4))
        del valid, q
        torch.cuda.empty_cache()
        for r in (k2, app):
            r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        log_row("frontier_queue", k2)
        log_row("apportion", app)
        rows_out[name] = (k2, app)
    # a stream cut inside a hub's list: each root queues the highest-
    # degree vertex and a few low-degree ones
    deg = calls[0][1]["deg"]
    hub = int(torch.argmax(deg))
    low = torch.nonzero((deg > 0) & (deg < 8)).flatten()[:3].tolist()
    dense = torch.zeros(deg.shape, dtype=torch.bool, device=deg.device)
    dense[[hub] + low] = True
    words = bm.pack_bool(dense).expand(calls[0][0].shape).contiguous()
    kw = dict(calls[0][1], n_slots=int(deg[low].sum()) + int(deg[hub]) // 2)
    q, stream_k, _ = stream_gate(words, kw, colstarts, rows, "synthetic hub")
    assert bool((q.truncated > 0).all()) and \
        int(stream_k[2].sum(dim=1).min()) == kw["n_slots"], \
        "the synthetic hub did not overrun the stream"
    log(f"frontier_queue + apportion (synthetic): a hub of degree "
        f"{int(deg[hub])} cut at {kw['n_slots']} slots keeps its list "
        f"prefix; {int(q.truncated[0])} edges truncated per root; equal "
        f"their plain versions")
    del calls, q, stream_k
    torch.cuda.empty_cache()
    return rows_out["bottom-up"]


def profile_run(ct, roots, label: str = "main path", top: int = 15):
    """Trace one run: device time by kernel name and the device's idle
    share of the run's wall time.  Returns {kernel name: launches}."""
    from torch.profiler import ProfilerActivity
    events, wall_us = traced_device_events(
        lambda: ct.run_batched(roots),
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}, "
        f"{sum(e.count for e in events)} device events")
    for e in events[:top]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return {e.key: e.count for e in events}


#: functions whose device time one CSR fused_gather traversal spends in
#: planning and in the Table-1 counters (module name, function name);
#: the names of the tree before the union planner are listed too, so
#: that one split reads both trees (a missing name is skipped)
SPLIT_RANGES = {
    "planning": (("repro_torch.kernels.ops", "plan_union"),
                 ("repro_torch.core.engine", "plan_active_tiles_batched"),
                 ("repro_torch.kernels.gather_expand", "union_worklist")),
    "counters": (("repro_torch.core.bitmap", "masked_degree_sum"),
                 ("repro_torch.core.engine", "row_popcounts")),
}
#: the port's own kernels (launched through ctypes, which the profiler
#: does not tie to the range that launched them) by a part of their
#: device names: the planning's (the planner; K2 before it) and the
#: layer's
SPLIT_KERNELS = {
    "planning": ("plan_masks", "plan_write", "tile_popcounts_kernel",
                 "rank_scatter_kernel", "fill_tail_kernel"),
    "gather_expand (K3)": ("gather_expand_kernel",),
    "restoration (K1)": ("restoration_kernel",),
    "popcount (K13)": ("popcount_kernel",),
    "measure (K13)": ("measure_kernel",),
}


def planning_split(ct, roots, required: bool = True) -> dict | None:
    """One traversal of ``ct`` under ``torch.profiler``, its device time
    split into the planning and the Table-1 counters (the device time of
    the torch kernels launched inside the functions of `SPLIT_RANGES`,
    wrapped in a ``record_function`` range while the run is traced, plus
    the port's own kernels of `SPLIT_KERNELS`), the layer's kernels by
    name, and the rest (policy, stats rows, state updates).  Prints and
    returns the split in ms."""
    import importlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    wrapped = []
    for rng, targets in SPLIT_RANGES.items():
        for mod_name, fn_name in targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name, None)
            if fn is None:
                continue

            def ranged(*a, _fn=fn, _rng=rng, **kw):
                with record_function(_rng):
                    return _fn(*a, **kw)
            setattr(mod, fn_name, ranged)
            wrapped.append((mod, fn_name, fn))
    try:
        ct.run_batched(roots)                   # warm-up, wrappers on
        torch.cuda.synchronize()
        for attempt in range(PROFILER_SESSIONS):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ct.run_batched(roots)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages()
                       if str(getattr(e, "device_type", "")).endswith("CUDA")
                       and e.self_device_time_total > 0
                       and e.key not in SPLIT_RANGES
                       and e.key not in CALL_RANGES]
            if kernels:
                break
            log(f"profiler session {attempt + 1} recorded no device event; "
                f"tracing again")
    finally:
        for mod, fn_name, fn in wrapped:
            setattr(mod, fn_name, fn)
    if not kernels and not required:
        log("profile_split: the profiler recorded no device event; the "
            "split is not measured in this run")
        return None
    assert kernels, "the profiler recorded no device event"
    named = lambda name: any(part in name for parts in SPLIT_KERNELS.values()
                             for part in parts)

    def torch_kernels(e):        # the kernels tied to e and its children
        return [k for k in e.kernels if not named(k.name)] + [
            k for c in e.cpu_children for k in torch_kernels(c)]

    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = {rng: sum(k.duration for e in prof.events()
                      if e.name == rng and e.device_type == DeviceType.CPU
                      for k in torch_kernels(e)) / 1e3
             for rng in SPLIT_RANGES}
    for label, parts in SPLIT_KERNELS.items():
        split[label] = split.get(label, 0.0) + sum(
            e.self_device_time_total for e in kernels
            if any(part in e.key for part in parts)) / 1e3
    split["other"] = busy - sum(split.values())
    log(json.dumps({"profile_split": "csr fused_gather", "wall_ms": wall_ms,
                    "device_busy_ms": busy,
                    "idle_share": 1 - busy / wall_ms,
                    "device_ms": split}))
    return split


#: phase 11a: the dense-mask arm (``packed=False``) on the main path's
#: graph: (path name, SELL layout?, TraversalSpec fields, the kernels it
#: must launch, its launches column per layer, stats columns held to the
#: main path)
DENSE_PATHS = (
    ("dense_fused_gather", False, dict(packed=False),
     ("gather_expand_batched", "restoration"), 2, range(7)),
    ("dense_fused_gather_d2", False, dict(packed=False, prefetch_depth=2),
     ("gather_expand_prefetch", "restoration"), 2, range(7)),
    ("dense_materialized", False, dict(packed=False,
                                       pipeline="materialized"),
     ("frontier_expand_batched", "restoration", "apportion"), 2,
     (0, 1, 2, 3, 4, 6)),
    ("dense_megakernel", False, dict(packed=False, pipeline="megakernel"),
     ("layer_fused_batched",), 1, range(7)),
    ("dense_persistent", False, dict(packed=False, pipeline="persistent"),
     ("traversal_fused_batched",), 0, range(7)),
    ("dense_sell_fused_gather", True, dict(packed=False),
     ("sell_expand_batched", "restoration"), 2, (0, 1, 2, 3, 4, 6)),
)
#: phase 11b: the pipelines `CompiledTraversal.layer_step` ticks through
TICK_PIPELINES = ("fused_gather", "megakernel", "persistent")


@contextlib.contextmanager
def recorded(module, name: str):
    """While the block runs, ``module.<name>`` is wrapped (not changed)
    and each call's (args, kwargs) appended to the yielded list."""
    orig = getattr(module, name)
    calls = []

    def wrapped(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)
    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def tree_ok(g, parent, root: int, oracle) -> None:
    """One root's (V_pad,) P: a valid tree with the oracle's depths."""
    import torch
    from repro_torch.core.validate import validate
    p = parent[:g.n_vertices]
    v = validate(g, torch.where(p >= g.n_vertices, -1, p), root,
                 reference_depth=oracle(root))
    assert v.ok, f"root {root}: tree invalid {v[:7]}"


def dense_planning(ct, calls, reps: int) -> dict:
    """The dense arm's planning on every captured layer of a dense
    ``fused_gather`` run (`engine._plan_dense` folded by
    `UnionPlan.of_lists`) against the union planner on the same words:
    the plans equal, each one's device time per traversal (calls queued
    back to back, summed over the layers) and the dense planning's peak
    of device memory above what was allocated."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import gather_expand as ge
    from repro_torch.kernels import ops
    graph = ct.fmt.fused_graph(ct.resolved)
    dense_ms = planner_ms = dense_ev = planner_ev = 0.0
    peak = 0
    for args, _ in calls:
        colstarts, active, n_vertices, tile, n_blocks = args
        dense = lambda: ge.UnionPlan.of_lists(*engine._plan_dense(
            colstarts, active, n_vertices, tile, n_blocks), n_blocks)
        planner = lambda: ops.plan_union(graph, active)
        for x, y in zip(dense(), planner()):
            assert torch.equal(x, y), "the dense planning's union differs " \
                "from the union planner's"
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dense()
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        dense_ms += device_ms(dense, reps)
        planner_ms += device_ms(planner, reps)
        dense_ev += cuda_ms(dense, reps)
        planner_ev += cuda_ms(planner, reps)
    return {"layers": len(calls), "dense_device_ms": dense_ms,
            "planner_device_ms": planner_ms, "dense_event_ms": dense_ev,
            "planner_event_ms": planner_ev, "dense_peak_bytes": peak,
            "batch": int(calls[0][0][1].shape[0]) if calls else 0}


def phase_dense(g, roots, base, oracle, edges: int,
                profile: bool = False) -> dict:
    """Phase 11a: ``packed=False`` at the main path's size (`DENSE_PATHS`,
    each through `run_path`: timed over 3 runs, held to the main path,
    its launches column 2 per layer on the dense CSR arms); the dense
    CSR arms launch no K2 and no planner; the dense materialized path's
    peak memory; the dense planning against the planner
    (`dense_planning`); with ``profile``, the dense CSR ``fused_gather``
    and ``materialized`` runs traced.  Returns {path: its first run's
    launches}."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch import formats
    from repro_torch.core import engine
    launched_by = {}
    sell = formats.build(g, "auto")
    for name, on_sell, fields, kernels, per_layer, cols in DENSE_PATHS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with recorded(engine, "_plan_dense") as calls:
            ct, launched, _ = run_path(sell if on_sell else g, g, roots,
                                       name, fields, kernels, per_layer,
                                       base, oracle, edges, cols)
        peak = torch.cuda.max_memory_allocated()
        assert ct.resolved.packed is False, ct.resolved
        if not on_sell:
            for k in ("frontier_compact_batched", "plan_union"):
                assert launched[k] == 0, f"{name}: {k} was launched"
        launched_by[name] = {k: launched[k] for k in kernels}
        if profile and name in ("dense_fused_gather", "dense_materialized"):
            profile_run(ct, roots, name, top=15)
            if name == "dense_materialized":      # the packed arm, beside
                profile_run(bfs.plan(g, bfs.TraversalSpec(
                    pipeline="materialized")), roots, "materialized", top=8)
        log(f"path {name}: batch {len(roots)}, peak device memory "
            f"{peak / 2**30:.3f} GiB; no K2 and no plan_union launch"
            if not on_sell else f"path {name}: SELL ignores packed")
        if name == "dense_materialized":
            with replayed(g, name) as seen:
                ct.run_batched(roots)
            torch.cuda.empty_cache()
            assert len(seen["dense_queue"]) == len(seen["apportion"]) \
                == int(base.state.layer), seen
            log(f"path {name} replayed: every K7, K1 and apportionment "
                f"call of one run equals its plain version on copies of "
                f"its inputs, and every dense queue K2's stream arm on "
                f"its words; calls {replay_report(seen, launched, name)}")
        if name == "dense_fused_gather":
            n_layers = int(base.state.layer)
            calls = calls[-n_layers:]          # the last timed run's
            assert len(calls) == n_layers, (len(calls), n_layers)
            split = dense_planning(ct, calls, 5)
            log(json.dumps({"dense_planning": split}))
            log(f"dense planning: {split['dense_device_ms']:.4f} ms of "
                f"device time per traversal ({split['layers']} layers, "
                f"8 roots) against the union planner's "
                f"{split['planner_device_ms']:.4f} ms on the same words; "
                f"peak {split['dense_peak_bytes'] / 2**30:.3f} GiB above "
                f"the resident state; every layer's plans equal")
        del ct, calls
        bfs.clear_plan_cache()
    torch.cuda.empty_cache()
    return launched_by


def phase_ticks(g, roots, oracle) -> list:
    """Phase 11b: `CompiledTraversal.layer_step` from the initial state
    until every frontier is empty (one host read per tick) on
    `TICK_PIPELINES`: visited, frontier and the tick count equal the
    ThresholdSimd(0) traversal (the SIMD step on every layer); trees
    valid.  Returns the ``fused_gather`` ThresholdSimd(0) traversal's
    `LayerStats` (phase 12c's reference)."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.core import engine
    for pipeline in TICK_PIPELINES:
        ct = bfs.plan(g, bfs.TraversalSpec(pipeline=pipeline))
        want = bfs.plan(g, bfs.TraversalSpec(
            policy=bfs.ThresholdSimd(0), pipeline=pipeline)) \
            .run_batched(roots)
        walls = []
        for _ in range(2):                   # a warm-up, then timed
            f, v, p = engine._init_batched(
                torch.tensor(roots, dtype=torch.int32, device=g.device),
                g.n_vertices, g.n_vertices_padded)
            st = bfs.BfsState(f, v, p, torch.zeros((), dtype=torch.int32,
                                                   device=g.device))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ticks = 0
            while bool(st.frontier.any()):    # the tick's one host read
                st = ct.layer_step(st)
                ticks += 1
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        assert torch.equal(st.visited, want.state.visited), pipeline
        assert torch.equal(st.frontier, want.state.frontier), pipeline
        assert ticks == int(st.layer) == int(want.state.layer), \
            (pipeline, ticks, int(want.state.layer))
        for b, r in enumerate(roots):
            tree_ok(g, st.parent[b], r, oracle)
        log(f"layer_step {pipeline}: {ticks} ticks of {len(roots)} roots "
            f"in {walls[-1]:.6f} s (warm-up {walls[0]:.6f} s); visited, "
            f"frontier and layers equal the ThresholdSimd(0) traversal; "
            f"trees valid")
        if pipeline == "fused_gather":
            simd_stats = bfs.layer_stats(want)
        del ct, want, st
        bfs.clear_plan_cache()
    return simd_stats


def phase_legacy(g, root: int, oracle) -> None:
    """Phase 11c: the legacy entry points and `traverse_hostloop` on one root
    at the main path's size: trees valid with the oracle's depths, each
    wall and kernel launches printed; `run_bfs_hybrid`'s log equals the
    BeamerHybrid plan's; the hostloop's per-layer frontier, edges and
    discovered equal the traversal's stats columns 0-2 under the same
    policy."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.obs.metrics import clear_degrade_log, degrade_log
    from repro_torch.core import bfs_hybrid, bfs_parallel, bfs_vectorized
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    clear_degrade_log()
    replays = {}

    def timed(name, fn):
        """fn's result and its wall and kernel launches, printable, of a
        run after a warm-up run under `replayed`."""
        with replayed(g, name) as seen:
            fn()
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in ops.KERNEL_LAUNCHES.items() if n}
        replays[name] = seen
        return out, f"{wall:.6f} s, launches {json.dumps(launches)}, " \
            f"replayed {replay_report(seen, launches, name)}"

    legacy = (
        ("run_bfs simd", lambda: bfs_parallel.run_bfs(g, root)),
        ("run_bfs nonsimd", lambda: bfs_parallel.run_bfs(
            g, root, algorithm="nonsimd")),
        ("run_bfs_jit", lambda: bfs_parallel.run_bfs_jit(
            g.colstarts, g.rows, root, g.n_vertices)),
        ("run_bfs_vectorized threshold",
         lambda: bfs_vectorized.run_bfs_vectorized(g, root)),
        ("run_bfs_vectorized simd_layers",
         lambda: bfs_vectorized.run_bfs_vectorized(g, root,
                                                   simd_layers=(1, 2))),
        ("traverse", lambda: bfs.traverse(
            g, root, spec=bfs.TraversalSpec(**BUILTIN_KNOBS,
                                            tile=BUILTIN_CSR_TILE)).state),
    )
    for name, fn in legacy:
        st, took = timed(name, fn)
        tree_ok(g, st.parent, root, oracle)
        log(f"legacy {name}: root {root}, {int(st.layer)} layers, "
            f"{took}; tree valid, depths equal the oracle")
    (st, hyb_log), took = timed("run_bfs_hybrid", lambda: (
        bfs_hybrid.run_bfs_hybrid(g, root, collect_stats=True)))
    tree_ok(g, st.parent, root, oracle)
    plan_log = bfs.direction_log(bfs.plan(g, bfs.TraversalSpec(
        policy=bfs.BeamerHybrid(), max_layers=1024)).run(root))
    assert hyb_log == plan_log, (hyb_log, plan_log)
    log(f"legacy run_bfs_hybrid: root {root}, {took}; log "
        f"{hyb_log} equals the BeamerHybrid plan's; tree valid")
    for pol in (bfs.ThresholdSimd(), bfs.BeamerHybrid()):
        hostloop = f"hostloop {type(pol).__name__}"
        (st, stats, hl_log), took = timed(hostloop, lambda: (
            engine.traverse_hostloop(g, root, policy=pol,
                                     collect_stats=True)))
        seen = replays[hostloop]
        assert {s[0] for s in seen["expand_batched"]} == {1} and \
            {len(s) for s in seen["restore"]} == {1} and \
            len(seen["dense_queue"]) == len(seen["apportion"]) \
            == len(stats), (hostloop, seen, len(stats))
        tree_ok(g, st.parent, root, oracle)
        fused = bfs.plan(g, bfs.TraversalSpec(policy=pol)).run(root)
        want = [tuple(s[1:4]) for s in bfs.layer_stats(fused)]
        got = [tuple(s[1:4]) for s in stats]
        assert got == want, (type(pol).__name__, got, want)
        assert hl_log == bfs.direction_log(fused)
        log(f"{hostloop}: root {root}, {len(stats)} "
            f"layers, {took}; per-layer frontier/edges/discovered "
            f"equal the traversal's stats columns 0-2; log {hl_log}; tree "
            f"valid")
    assert not degrade_log(), degrade_log()
    bfs.clear_plan_cache()


def phase_repairs(seed: int, device) -> None:
    """Phase 11d at SCALE 16: ``plan(EdgeList)`` equals ``plan(Csr)``;
    ``persistent`` with a subclass of ThresholdSimd records exactly one
    ``pipeline_unsupported`` degrade and equals the megakernel's run
    (columns 0-6 and everything else)."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.obs.metrics import clear_degrade_log, degrade_log
    from repro_torch.core import csr as csr_mod
    from repro_torch.core import rmat
    edges = rmat.generate(seed, 16, GRAPHS["rmat-16"].edgefactor,
                          device=device)
    g16 = csr_mod.from_edges(edges, device=device)
    roots16 = pick_roots(g16, BATCH, seed + 3)
    fixed = bfs.TraversalSpec(**BUILTIN_KNOBS, tile=BUILTIN_CSR_TILE)
    a = bfs.plan(edges, fixed).run_batched(roots16)
    b = bfs.plan(g16, fixed).run_batched(roots16)
    for what, x, y in (("stats", a.stats, b.stats),
                       ("visited", a.state.visited, b.state.visited),
                       ("depths", a.depths, b.depths)):
        assert torch.equal(x, y), f"plan(EdgeList): {what} differ"
    assert bfs.direction_log(a) == bfs.direction_log(b)
    log("repair plan(EdgeList) @ SCALE 16: stats, visited, depths and "
        "direction log equal plan(from_edges(...))")

    class Custom(bfs.ThresholdSimd):
        pass
    clear_degrade_log()
    got = bfs.plan(g16, bfs.TraversalSpec(
        policy=Custom(), pipeline="persistent")).run_batched(roots16)
    sites = [e.site for e in degrade_log()]
    assert sites == ["pipeline_unsupported"], degrade_log()
    clear_degrade_log()
    mega = bfs.plan(g16, bfs.TraversalSpec(
        policy=Custom(), pipeline="megakernel")).run_batched(roots16)
    assert not degrade_log(), degrade_log()
    for what, x, y in (("stats columns 0-6", got.stats[:, :7],
                        mega.stats[:, :7]),
                       ("stats", got.stats, mega.stats),
                       ("visited", got.state.visited, mega.state.visited),
                       ("depths", got.depths, mega.depths)):
        assert torch.equal(x, y), f"persistent(Custom): {what} differ"
    log("repair persistent(unregistered policy) @ SCALE 16: one "
        "pipeline_unsupported degrade, equal to the megakernel's run")
    del edges, g16
    bfs.clear_plan_cache()


def oracle_of(g, known: dict):
    """A level-synchronous BFS depth oracle for any root of ``g``
    (`level_bfs_depths`, cached; ``known`` seeds the cache) and a
    function that frees its edge list."""
    import torch
    state = {}

    def depths(root: int):
        root = int(root)
        if root not in known:
            if "src" not in state:
                state["src"] = torch.repeat_interleave(
                    torch.arange(g.n_vertices, device=g.rows.device),
                    g.degrees().long(), output_size=g.n_edges)
                state["dst"] = g.rows[:g.n_edges].long()
            known[root] = level_bfs_depths(state["src"], state["dst"],
                                           g.n_vertices, root)
        return known[root]
    return depths, state.clear


def phase_harness(g, ct, oracle, seed: int):
    """Phase 12a: the Graph500 harness (`core.stats.run_harness`) on the
    main path's graph and plan, ``run(root)``, over `MAIN.n_roots` roots
    from ``seed``: unfiltered (the paper) and degree > 0 (Graph500).
    Every run valid against the level-synchronous oracle; the zero-edge
    runs are exactly the degree-0 roots; no plain counter.  Returns the
    connected draw's roots."""
    from repro_torch.core.stats import choose_roots, run_harness
    from repro_torch.kernels import ops
    deg = g.degrees().cpu()
    big = g.n_vertices // 100
    for label, connected in (("paper", False), ("graph500", True)):
        roots = choose_roots(seed, g.n_vertices, MAIN.n_roots, degrees=deg,
                             require_connected=connected)
        assert len(roots) == MAIN.n_roots, (label, len(roots))
        ops.reset_kernel_launches()
        with CallCount(PLAIN_COUNTERS) as plain:
            res = run_harness(g, lambda c, r: ct.run(r).state, seed,
                              roots=roots, validate_runs=True,
                              reference_depths_fn=oracle)
        assert not any(plain.counts.values()), plain.counts
        assert all(r.valid for r in res.runs), \
            [r.root for r in res.runs if not r.valid]
        zero = sorted(r.root for r in res.runs if r.edges == 0)
        deg0 = sorted(int(r) for r in roots if int(deg[int(r)]) == 0)
        assert zero == deg0, (zero, deg0)
        giant = [r.teps for r in res.runs if r.reached >= big]
        log(json.dumps({"graph500": label, "require_connected": connected,
                        "n_roots": len(res.runs),
                        "hmean_teps": res.hmean_teps,
                        "max_teps": res.max_teps,
                        "n_zero_runs": res.n_zero_runs,
                        "mean_s": res.mean_seconds,
                        "median_teps": statistics.median(
                            r.teps for r in res.runs),
                        "giant_runs": len(giant),
                        "giant_hmean_teps": len(giant) / sum(
                            1 / t for t in giant) if giant else 0.0,
                        "small_component_runs": sum(
                            0 < r.edges and r.reached < big
                            for r in res.runs),
                        "valid": sum(bool(r.valid) for r in res.runs),
                        "launches": {k: n for k, n in
                                     ops.KERNEL_LAUNCHES.items() if n}}))
    log(f"graph500 harness: {MAIN.n_roots} roots per draw, every run "
        f"valid, zero-edge runs exactly the degree-0 roots; no plain "
        f"counters")
    return [int(r) for r in roots]


def serve_queries(eng, roots, oracle, g) -> float:
    """Submit one query per root, drain, and hold the delivery: every
    uid exactly once, untruncated, each tree valid with the oracle's
    depths and its layers equal to the oracle's depth.  Returns the
    wall seconds from the first submit to the drained queue."""
    import torch
    from repro_torch.core.validate import validate
    from repro_torch.serve.graph_engine import BfsQuery
    t0 = time.perf_counter()
    for i, r in enumerate(roots):
        eng.submit(BfsQuery(uid=i, root=r))
    eng.run_until_done()
    wall = time.perf_counter() - t0
    uids = sorted(q.uid for q in eng.finished)
    assert uids == list(range(len(roots))), uids
    for q in eng.finished:
        assert q.done and not q.truncated and q.error is None, q.uid
        depth = oracle(q.root)
        assert validate(g, torch.from_numpy(q.parent).to(g.rows.device),
                        q.root, reference_depth=depth).ok, q.uid
        assert q.n_layers == int(depth.max()) + 1, (q.uid, q.n_layers)
    return wall


def tick_sections(eng) -> dict:
    """Wrap the engine's tick sections (the dispatch with its state
    snapshot, the harvests, the slot refills) so that each adds its wall
    seconds, the card synchronised at both ends, to the returned dict."""
    import torch
    spent = {}
    for name in ("_dispatch_with_retry", "_harvest", "_fill_slots"):
        def timed(*a, _orig=getattr(eng, name), _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*a, **kw)
            torch.cuda.synchronize()
            spent[_name] = spent.get(_name, 0.0) + time.perf_counter() - t0
            return out
        setattr(eng, name, timed)
    return spent


def phase_serve(g, roots, oracle, portfolio: dict, roots8) -> None:
    """Phase 12b: the query service at the main path's size."""
    import numpy as np
    import torch
    from repro_torch.algorithms.semiring import INT_INF
    from repro_torch.errors import InjectedFault, TickRetriesExhausted
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import robust
    from repro_torch.serve.graph_engine import BfsQuery, GraphEngine

    def engine(fmt="csr", **kw):
        return GraphEngine(g, batch_slots=SERVE.batch_slots,
                           graph_format=fmt, registry=MetricsRegistry(),
                           device=g.rows.device, **kw)

    serve_queries(engine(), roots[:BATCH], oracle, g)       # warm-up
    eng = engine()
    ops.reset_kernel_launches()
    torch.cuda.synchronize()
    with CallCount(PLAIN_COUNTERS) as plain:
        wall = serve_queries(eng, roots, oracle, g)
    launched = {k: n for k, n in ops.KERNEL_LAUNCHES.items() if n}
    ticks = int(eng.metrics.counter("serve.ticks").value)
    assert not any(plain.counts.values()), plain.counts
    assert launched == {"plan_union": ticks, "gather_expand_batched": ticks,
                        "restoration": ticks, "popcount": ticks}, \
        (launched, ticks)
    lat = eng.metrics.histogram("serve.query_latency_s")
    tick = eng.metrics.histogram("serve.tick_s")
    # the harvest's one copy of a parent row: dropped at once (host pages
    # reused), and kept as a delivered tree is (fresh host pages each)
    row = eng.parent[0, :g.n_vertices]
    copies = {"dropped": [], "kept": []}
    delivered = []
    for how in ("dropped", "kept", "dropped", "kept"):
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = torch.where(row >= g.n_vertices, -1, row).cpu().numpy()
            copies[how].append(time.perf_counter() - t1)
            if how == "kept":
                delivered.append(out)
            del out
    del delivered
    state = (eng.frontier, eng.visited, eng.parent)
    snapshot_ms = cuda_ms(lambda: [t.clone() for t in state], 10)
    log(json.dumps({
        "serve": "csr", "queries": len(roots), "slots": SERVE.batch_slots,
        "ticks": ticks, "wall_s": wall, "queries_per_s": len(roots) / wall,
        "query_latency_s": {"p50": lat.percentile(0.5),
                            "p99": lat.percentile(0.99)},
        "tick_s": {"p50": tick.percentile(0.5), "p99": tick.percentile(0.99),
                   "mean": tick.sum / tick.count},
        "harvest_copy_s": statistics.median(copies["dropped"]),
        "harvest_copy_kept_s": statistics.median(copies["kept"]),
        "harvest_bytes": 4 * g.n_vertices,
        "snapshot_ms": snapshot_ms,
        "snapshot_bytes": sum(4 * t.numel() for t in state),
        "launches": launched}))
    # the profiler: per tick one planner call (two launches), K3, K1 and
    # one measure count launch; no plain counter
    for i, r in enumerate(roots[:BATCH]):
        eng.submit(BfsQuery(uid=100 + i, root=r))
    ticked = []

    def three_ticks():
        before = eng.metrics.counter("serve.ticks").value
        for _ in range(3):
            eng.step()
        ticked.append(int(eng.metrics.counter("serve.ticks").value - before))
    from torch.profiler import ProfilerActivity
    events, wall_us = traced_device_events(
        three_ticks, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    kernels = {e.key: e.count for e in events}
    busy_us = sum(e.self_device_time_total for e in events)
    n = ticked[-1]          # the ticks of the trace the profiler kept
    per_tick = {name: launches_of(kernels, name) for name in (
        "plan_masks_csr", "plan_write", "gather_expand_kernel",
        "restoration_kernel", "measure_kernel")}
    assert n > 0 and all(v == n for v in per_tick.values()), \
        (n, per_tick, kernels)
    eng.run_until_done()
    del eng
    # where a tick's time goes: the same queries on a fresh engine whose
    # tick sections are timed (synchronised, so this run is slower)
    eng = engine()
    spent = tick_sections(eng)
    wall_sections = serve_queries(eng, roots, oracle, g)
    n_ticks = eng.metrics.counter("serve.ticks").value
    log(json.dumps({"serve_tick_sections": {
        "ticks": n_ticks, "wall_s": wall_sections,
        "dispatch_s": spent["_dispatch_with_retry"],
        "harvest_s": spent["_harvest"], "fill_s": spent["_fill_slots"],
        "other_s": wall_sections - sum(spent.values())}}))
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    log(json.dumps({"serve_profile": {
        "ticks": n, "wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "top": {e.key[:60]: [e.count, e.self_device_time_total / 1e3]
                for e in top}}}))
    log(f"serve csr: {len(roots)} queries over {SERVE.batch_slots} slots in "
        f"{ticks} ticks, every tree valid with the oracle's depths; the "
        f"profiler over {n} ticks: {per_tick} (the planner's two launches "
        f"per call); no plain counters")
    del eng

    # the autotuner's layout (SELL on this graph)
    eng = engine("auto")
    ops.reset_kernel_launches()
    with CallCount(PLAIN_COUNTERS) as plain:
        wall = serve_queries(eng, roots, oracle, g)
    launched = {k: n for k, n in ops.KERNEL_LAUNCHES.items() if n}
    ticks = int(eng.metrics.counter("serve.ticks").value)
    assert not any(plain.counts.values()), plain.counts
    assert launched.get("sell_expand_batched") == launched.get(
        "restoration") == launched.get("popcount") == ticks, launched
    log(f"serve {eng.fmt.name}: {len(roots)} queries in {ticks} ticks, "
        f"{wall:.6f} s, every tree valid; launches {json.dumps(launched)}")
    del eng

    # chaos: failures at two ticks, one stall, poisoned slots at two
    inj = robust.ServeFaultInjector(fail_ticks=(3, 7), slow_ticks=(5,),
                                    slow_s=0.05, poison=((2, 1), (6, 4)))
    eng = engine(injector=inj, retry_backoff_s=0.001)
    serve_queries(eng, roots, oracle, g)
    c = eng.metrics.snapshot()["counters"]
    assert inj.faults_remaining == 0
    assert (c["serve.retries"], c["serve.poisoned"], c["serve.requeued"]) \
        == (2, 2, 2), c
    assert sum(q.retries for q in eng.finished) == 2
    log(f"serve chaos: {len(roots)} queries delivered exactly once, none "
        f"corrupted; retries {c['serve.retries']:g}, poisoned "
        f"{c['serve.poisoned']:g}, requeued {c['serve.requeued']:g}")
    del eng

    class AlwaysFail(robust.ServeFaultInjector):
        def check_tick(self, tick):
            if tick == 0:
                raise InjectedFault("tick 0 always fails")
    eng = engine(injector=AlwaysFail(), max_tick_retries=2,
                 retry_backoff_s=0.001)
    qs = [BfsQuery(uid=i, root=r) for i, r in enumerate(roots[:BATCH])]
    for q in qs:
        eng.submit(q)
    try:
        eng.step()
        raise AssertionError("retry exhaustion did not raise")
    except TickRetriesExhausted as e:
        assert isinstance(e.__cause__, InjectedFault)
    assert len(eng.queue) == BATCH and all(q.retries == 1 for q in qs)
    eng.run_until_done()
    assert sorted(q.uid for q in eng.finished) == list(range(BATCH))
    log(f"serve retry exhaustion: {BATCH} in-flight queries re-queued, "
        f"TickRetriesExhausted raised, then all delivered")
    del eng

    # the portfolio equals phase 9's results bitwise
    eng = engine()
    dist, parent = eng.shortest_paths(roots8)
    vals, par = portfolio["sssp"]
    assert torch.equal(torch.from_numpy(dist).view(torch.int32),
                       vals.view(torch.int32)), "sssp distances"
    assert np.array_equal(parent, torch.where(torch.isfinite(vals), par,
                                              -1).numpy()), "sssp parents"
    labels, n_comp = eng.components()
    assert torch.equal(torch.from_numpy(labels), portfolio["cc"][0][0]), \
        "cc labels"
    depths = eng.ksource_depths(roots8)
    kvals = portfolio["ksource_bfs"][0]
    assert np.array_equal(depths, torch.where(kvals >= int(INT_INF), -1,
                                              kvals).numpy()), \
        "ksource depths"
    log(f"serve portfolio: shortest_paths, components ({n_comp}) and "
        f"ksource_depths on {len(roots8)} roots equal phase 9 bitwise")
    del eng
    torch.cuda.empty_cache()


def phase_trace(ct, roots, simd_stats) -> None:
    """Phase 12c: `trace_run` on the main path's plan and roots."""
    import glob
    import tempfile
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    ops.reset_kernel_launches()
    with CallCount(PLAIN_COUNTERS) as plain:
        tr = ct.trace_run(roots)
    assert not any(plain.counts.values()), plain.counts
    want = [tuple(s[:4]) for s in simd_stats]
    assert [tuple(s[:4]) for s in tr.stats] == want, (tr.stats, want)
    names = [s.name for s in tr.tracer.spans]
    assert names.count(trace.LAYER_SPAN) == names.count(trace.STEP_SPAN) \
        == len(tr.stats) == len(want)
    assert ops.KERNEL_LAUNCHES["measure"] == len(tr.stats) + 1, \
        ops.KERNEL_LAUNCHES
    top = next(s for s in tr.tracer.spans if s.name == trace.TRAVERSAL_SPAN)
    with tempfile.TemporaryDirectory() as tmp:
        doc = json.load(open(tr.tracer.export(f"{tmp}/trace.json")))
        assert len(doc["traceEvents"]) == len(tr.tracer) + 1
        tr2 = ct.trace_run(roots, profile_logdir=tmp)
        assert [tuple(s[:4]) for s in tr2.stats] == want
        (path,) = glob.glob(f"{tmp}/bfs_trace_*.json")
        events = json.load(open(path))["traceEvents"]
        k3 = sum("gather_expand_kernel" in str(e.get("name", ""))
                 for e in events)
    assert k3 > 0, "the profiler's trace names no K3 launch"
    log(json.dumps({"trace_run": "fused_gather", "roots": len(roots),
                    "layers": len(tr.stats), "spans": len(tr.tracer),
                    "traversal_s": top.dur_us / 1e6,
                    "layer_s": tr.layer_seconds,
                    "measure_launches": ops.KERNEL_LAUNCHES["measure"],
                    "profiled_k3_events": k3}))
    ctp = bfs.plan(ct.fmt, bfs.TraversalSpec(pipeline="persistent"),
                   device=ct.fmt.device)
    trp = ctp.trace_run(roots)
    assert [s.name for s in trp.tracer.spans] == [trace.PERSISTENT_SPAN]
    assert trp.stats == bfs.layer_stats(ctp.run_batched(roots))
    assert [tuple(s[:4]) for s in trp.stats] == \
        [tuple(s[:4]) for s in bfs.layer_stats(ct.run_batched(roots))]
    log(f"trace_run: {len(tr.stats)} layer spans equal the ThresholdSimd(0) "
        f"traversal's frontier/edges/discovered, one measure launch per "
        f"layer + 1, no plain counters; Chrome JSON parsed; the profiler's "
        f"trace names K3 ({k3} events); persistent: one span, stats equal "
        f"run_batched's ({trp.tracer.spans[0].dur_us / 1e3:.3f} ms)")
    del ctp, trp
    torch.cuda.empty_cache()


def rowsweep_bytes(colstarts_l, frontier, visited, base: int):
    """(bytes, active edges) of one shard's rowsweep: its frontier words,
    its colstarts, the rows of its active owners and the visited words
    read once, the (v_cap,) candidate array written once."""
    from repro_torch.core import bitmap as bm
    v_loc = colstarts_l.shape[0] - 1
    w0 = base // bm.BITS_PER_WORD
    words = frontier[w0:w0 + v_loc // bm.BITS_PER_WORD]
    deg = colstarts_l[1:] - colstarts_l[:-1]
    edges = int(deg[bm.unpack_bool(words)].sum())
    n = words.numel() + colstarts_l.numel() + edges + visited.numel() \
        + frontier.numel() * bm.BITS_PER_WORD
    return 4 * n, edges


def fit_words(words, n_words: int):
    """``words`` zero-padded or cut to ``n_words`` (the bits past V are
    zero, so either keeps every vertex)."""
    import torch
    pad = max(0, n_words - words.numel())
    return torch.nn.functional.pad(words, (0, pad))[:n_words].contiguous()


def phase_rowsweep(g, layers: list, reps: int) -> dict:
    """Phase 13a: the rowsweep kernel against its plain version on every
    shard of the main path's graph partitioned at `DIST_SHARDS` (the
    host partition only), on the frontier and visited words of the
    largest top-down layer of 13b's first root: bitwise, timed (events,
    then back to back) beside its bound and the plain version; at D = 1
    also every layer of that root, timed back to back, with the largest
    degree among its frontier vertices.  Returns the D = 1 shard's row
    on the largest layer."""
    import torch
    from repro_torch.core import bfs_distributed as bd
    from repro_torch.core import bitmap as bm
    from repro_torch.kernels import ops
    from repro_torch.kernels import rowsweep as rw
    captured = max(layers, key=lambda c: c["n"])
    row = None
    for n_dev in DIST_SHARDS:
        t0 = time.perf_counter()
        rows_sh, cs_sh = bd.partition_csr(g, n_dev)
        part_s = time.perf_counter() - t0
        v_loc = cs_sh.shape[1] - 1
        w_cap = v_loc * n_dev // 32
        frontier = fit_words(captured["frontier"], w_cap)
        visited = fit_words(captured["visited"], w_cap)
        for d in range(n_dev):
            rows_l, cs_l = rows_sh[d].cuda(), cs_sh[d].cuda()
            base = d * v_loc
            args = (rows_l, cs_l, frontier, visited)
            want = rw.rowsweep_plain(*args, base, g.n_vertices)
            got = ops.rowsweep_candidates(*args, base=base,
                                          n_vertices=g.n_vertices)
            torch.cuda.synchronize()
            assert torch.equal(got, want), \
                f"rowsweep D={n_dev} shard {d}: kernel != plain version"
            nbytes, edges = rowsweep_bytes(cs_l, frontier, visited, base)
            res = dict(shards=n_dev, shard=d, base=base, v_loc=v_loc,
                       e_loc=rows_sh.shape[1], active_edges=edges,
                       candidates=int((got < g.n_vertices).sum()),
                       bytes=nbytes,
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       max_abs_err=int((got - want).abs().max()))
            timed_kernel(res, lambda: ops.rowsweep_candidates(
                *args, base=base, n_vertices=g.n_vertices), reps)
            res["plain_ms"] = cuda_ms(
                lambda: rw.rowsweep_plain(*args, base, g.n_vertices),
                max(3, reps // 4))
            log(json.dumps({"kernel": "rowsweep", **res}))
            if n_dev == 1:
                row = res
                deg = cs_l[1:] - cs_l[:-1]
                for i, layer in enumerate(layers):
                    f = fit_words(layer["frontier"], w_cap)
                    v = fit_words(layer["visited"], w_cap)
                    nb, ne = rowsweep_bytes(cs_l, f, v, 0)
                    log(json.dumps({
                        "kernel": "rowsweep_layer", "layer": i,
                        "frontier": layer["n"], "active_edges": ne,
                        "max_degree": int(deg[bm.unpack_bool(f)].max())
                        if layer["n"] else 0,
                        "bound_ms": nb / HBM_BYTES_PER_S * 1e3,
                        "ms": device_ms(lambda: ops.rowsweep_candidates(
                            rows_l, cs_l, f, v, base=0,
                            n_vertices=g.n_vertices), reps)}))
            del rows_l, cs_l, want, got
        log(f"partition at D={n_dev}: {part_s:.3f} s on the host, e_loc "
            f"{rows_sh.shape[1]}")
        del rows_sh, cs_sh
        torch.cuda.empty_cache()
    log(f"rowsweep: the kernel equals its plain version bitwise on every "
        f"shard at D = {list(DIST_SHARDS)} (layer of {captured['n']} "
        f"frontier vertices)")
    return row


def dist_rank(rank: int, world: int, store: str, graph: str, roots,
              out: str) -> None:
    """One rank of 13c: gloo, on cuda:0 like every other rank, every
    merge for every root of the SCALE-16 graph; writes its parents and
    layer counts to ``<out>.<rank>.pt``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import bfs_distributed as bd
    from repro_torch.core.csr import Csr
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        parts = torch.load(graph)
        g = Csr(parts["rows"].cuda(), parts["colstarts"].cuda(),
                parts["n_vertices"], parts["n_edges"])
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("x",))
        got = {}
        for merge in DIST_MERGES:
            for r in roots:
                p, layers = bd.run_bfs_distributed(g, r, mesh, merge=merge)
                got[(merge, r)] = (p.cpu(), layers)
        torch.save(got, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_two_ranks(g16, roots16, want: dict, tmp: str) -> None:
    """Phase 13c: `DIST_RANKS` spawned processes over gloo, all on cuda:0
    (NCCL refuses two ranks on one device), on the SCALE-16 graph: each
    merge's parents and layer counts equal the one-rank NCCL run's
    bitwise, on every rank."""
    import multiprocessing as mp
    import torch
    torch.save({"rows": g16.rows.cpu(), "colstarts": g16.colstarts.cpu(),
                "n_vertices": g16.n_vertices, "n_edges": g16.n_edges},
               f"{tmp}/g16.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(
        rank, DIST_RANKS, f"{tmp}/gloo", f"{tmp}/g16.pt", roots16,
        f"{tmp}/ranks")) for rank in range(DIST_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"13c: ranks {hung} still running after 300 s"
    assert [p.exitcode for p in procs] == [0] * DIST_RANKS, \
        [p.exitcode for p in procs]
    for rank in range(DIST_RANKS):
        got = torch.load(f"{tmp}/ranks.{rank}.pt")
        for key, (parent, layers) in want.items():
            assert torch.equal(got[key][0], parent) \
                and got[key][1] == layers, f"13c rank {rank} {key} differs"
    log(f"two ranks on one card over gloo (SCALE {DIST_SCALE}, roots "
        f"{roots16}): every merge's parents and layers equal the one-rank "
        f"NCCL run's on both ranks ({time.perf_counter() - t0:.1f} s with "
        f"start-up)")


def phase_distributed(g, roots, oracle, seed: int, reps: int):
    """Phase 13: the distributed BFS (`core.bfs_distributed`).  13b: one
    rank over NCCL on the main path's graph and roots — every merge's
    trees valid with the oracle's depths and ``layers == max depth + 1``,
    the three merges' parents bitwise equal, ``plan(mesh=).run`` equal to
    `run_bfs_distributed`, no plain rowsweep called; one counted run and
    one profiled root.  Then 13a (`phase_rowsweep`) and 13c
    (`phase_two_ranks`).  Returns (the kernels-line row, the counted
    run's launches)."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity
    import repro_torch.bfs as bfs
    from repro_torch.core import bfs_distributed as bd
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("x",))
            t0 = time.perf_counter()
            bd.local_shard(*bd.partition_csr(g, 1), mesh, ("x",))
            torch.cuda.synchronize()
            log(f"distributed: partition at D=1 (host split + copy of the "
                f"shard to the card): {time.perf_counter() - t0:.3f} s")
            def sweep(call, _):
                """A layer: its frontier count and words, its visited."""
                return dict(n=int(engine.row_popcounts(call["frontier"])),
                            frontier=call["frontier"],
                            visited=call["visited"])

            with Spy(ops, {"rowsweep_candidates": None}, each=sweep) as spy:
                bd.run_bfs_distributed(g, roots[0], mesh)
            sweeps = spy.calls
            torch.cuda.synchronize()
            parents, plans = {}, {}
            with CallCount(PLAIN_ROWSWEEP) as plain:
                for merge in DIST_MERGES:
                    t0 = time.perf_counter()
                    ct = plans[merge] = bfs.plan(
                        g, bfs.TraversalSpec(merge=merge), mesh=mesh)
                    assert ct.executable is None
                    ct.run(roots[0])
                    torch.cuda.synchronize()
                    first = time.perf_counter() - t0
                    walls, depths = [], []
                    for r in roots:
                        t1 = time.perf_counter()
                        p, layers = ct.run(r)
                        torch.cuda.synchronize()
                        walls.append(time.perf_counter() - t1)
                        tree_ok(g, p, r, oracle)
                        depth = int(oracle(r).max())
                        assert layers == depth + 1, (merge, r, layers, depth)
                        depths.append(layers)
                        if r not in parents:
                            parents[r] = p
                        assert torch.equal(p, parents[r]), \
                            f"merge {merge} root {r}: parents differ from " \
                            f"{DIST_MERGES[0]}'s"
                    p2, l2 = bd.run_bfs_distributed(g, roots[0], mesh,
                                                    merge=merge)
                    assert torch.equal(p2, parents[roots[0]]) \
                        and l2 == depths[0], f"merge {merge}: " \
                        "run_bfs_distributed != plan(mesh=).run"
                    log(json.dumps({
                        "distributed": merge, "shards": 1, "roots": len(roots),
                        "layers": depths,
                        "first_run_s": first,
                        "wall_s_per_root": walls,
                        "median_wall_s": statistics.median(walls)}))
                ops.reset_kernel_launches()
                p, layers = plans["allreduce"].run(roots[0])
                torch.cuda.synchronize()
                launches = dict(ops.KERNEL_LAUNCHES)
            assert not any(plain.counts.values()), plain.counts
            # the loop's count reads are the measure kernel's count arm
            assert launches["rowsweep"] == layers \
                and launches["popcount"] == layers + 1, (launches, layers)
            log(f"distributed: {len(roots)} roots x {len(DIST_MERGES)} "
                f"merges, trees "
                f"valid with the oracle's depths, the merges' parents "
                f"bitwise equal, plan(mesh=) == run_bfs_distributed; counted "
                f"run: {launches['rowsweep']} rowsweep launches and "
                f"{launches['popcount']} count launches for {layers} "
                f"layers, no call of "
                f"{', '.join(sorted(plain.counts))}")
            events, wall_us = traced_device_events(
                lambda: plans["allreduce"].run(roots[0]),
                [ProfilerActivity.CPU, ProfilerActivity.CUDA])
            events.sort(key=lambda e: e.self_device_time_total, reverse=True)
            busy_us = sum(e.self_device_time_total for e in events)
            log(f"profile distributed allreduce (root {roots[0]}): wall "
                f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} "
                f"ms, idle share {1 - busy_us / wall_us:.4f}, "
                f"{sum(e.count for e in events)} device events")
            for e in events[:10]:
                log(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
                    f"x{e.count:<5d} {e.key[:90]}")
            del plans, parents, p, p2
            # 13c's reference: the one-rank run at SCALE 16
            g16 = make_graph(DIST_SCALE, seed, "cuda")
            roots16 = pick_roots(g16, 3, seed + 3)
            want16 = {}
            for merge in DIST_MERGES:
                for r in roots16:
                    p16, l16 = bd.run_bfs_distributed(g16, r, mesh,
                                                      merge=merge)
                    want16[(merge, r)] = (p16.cpu(), l16)
        finally:
            dist.destroy_process_group()
        row = phase_rowsweep(g, sweeps, reps)
        phase_two_ranks(g16, roots16, want16, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return row, launches


def lm_inputs(cfg, seed: int, b: int = 2, t: int = 32) -> dict:
    """numpy inputs of one reduced arch: tokens, the decode tokens, the
    vlm prefix and the encoder's frames where the arch has them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)),
           "decode": rng.integers(0, cfg.vocab_size, (3, b))}
    if cfg.prefix_len:
        out["prefix"] = 0.02 * rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model))
    if cfg.encoder_layers:
        out["src_embeddings"] = 0.02 * rng.standard_normal(
            (b, 8, cfg.d_model))
    return out


def lm_outputs(params, cfg, inputs: dict, device) -> list:
    """(name, tensor) of one model's forward logits, prefill logits and 3
    decode steps' logits, all computed on ``device``."""
    import torch
    from repro_torch.models import lm
    x = {k: torch.from_numpy(v).to(device, torch.int32 if v.dtype.kind == "i"
                                   else torch.float32)
         for k, v in inputs.items()}
    out = []
    with torch.no_grad():
        memory = (lm.encode(params, cfg, x["src_embeddings"])
                  if cfg.encoder_layers else None)
        hidden, _ = lm.forward_hidden(params, cfg, x["tokens"],
                                      prefix=x.get("prefix"), memory=memory)
        out.append(("forward", lm.logits_fn(params, cfg, hidden)))
        out.append(("prefill", lm.prefill(params, cfg, x["tokens"][:, :8],
                                          prefix=x.get("prefix"))[1]))
        b = x["tokens"].shape[0]
        states = lm.init_decode_state(params, cfg, b, 64)
        for i in range(3):
            pos = torch.full((b,), i, dtype=torch.int32, device=device)
            states, logits = lm.decode_step(params, cfg, states,
                                            x["decode"][i], pos, memory)
            out.append((f"decode{i}", logits))
    return out


def lm_parity(seed: int) -> None:
    """14a: each reduced arch (float32) on the card equals the port's CPU
    run of the same weights."""
    import copy
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    for name in registry.ARCHS:
        cfg = registry.get(name, reduced=True).with_(dtype="float32")
        cpu = lm.init_params(cfg, seed, device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        inputs = lm_inputs(cfg, seed)
        errs = {}
        for (what, want), (_, got) in zip(
                lm_outputs(cpu, cfg, inputs, "cpu"),
                lm_outputs(gpu, cfg, inputs, "cuda"), strict=True):
            assert got.is_cuda and bool(torch.isfinite(got).all()), \
                f"{name} {what}: not finite on the card"
            torch.testing.assert_close(
                got.cpu(), want, rtol=LM_PARITY_TOL, atol=LM_PARITY_TOL,
                msg=lambda m, w=what: f"{name} {w}: GPU != CPU: {m}")
            errs[what] = float((got.cpu() - want).abs().max())
        log(json.dumps({"lm_parity": name, "tol": LM_PARITY_TOL,
                        "max_abs_err": errs}))


def standalone_greedy(params, cfg, prompt, n_gen: int, cache_len: int):
    """The reference test's standalone greedy decode, at batch 1."""
    import torch
    from repro_torch.models import lm
    states = lm.init_decode_state(params, cfg, 1, cache_len)
    out = []
    for i in range(len(prompt) + n_gen - 1):
        tok = prompt[i] if i < len(prompt) else out[-1]
        states, logits = lm.decode_step(
            params, cfg, states,
            torch.tensor([tok], dtype=torch.int32, device="cuda"),
            torch.tensor([i], dtype=torch.int32, device="cuda"))
        if i >= len(prompt) - 1:
            out.append(int(logits.argmax(-1)[0]))
    return out


def lm_serve(seed: int) -> None:
    """14b: `ServeEngine` on `LM_ARCH` at full width and depth, bf16
    weights initialised on the card from ``seed``."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.models.config import param_count
    from repro_torch.serve.engine import Request, ServeEngine

    class Engine(ServeEngine):
        """Every tick's logits of the active slots must be finite; each
        tick's wall (to the host read of its tokens) is kept."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.tick_s = []

        def _next_tokens(self, logits):
            active = [i for i, r in enumerate(self.slots)
                      if r is not None and not r.done]
            assert bool(torch.isfinite(logits[active]).all()), \
                "non-finite logits in a served slot"
            return super()._next_tokens(logits)

        def step(self):
            t0 = time.perf_counter()
            super().step()
            self.tick_s.append(time.perf_counter() - t0)

    cfg = registry.get(LM_ARCH).with_(param_dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    assert all(p.dtype == torch.bfloat16 for p in params.parameters())
    assert len(params["layers"]) == cfg.n_layers
    log(f"lm init: {LM_ARCH} {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim "
        f"{cfg.resolved_head_dim()}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {n_params} parameters (param_count "
        f"{param_count(cfg)} + norms), {param_bytes / 1e9:.3f} GB bf16, "
        f"{init_s:.3f} s on the card")

    rng = np.random.default_rng(seed)
    reqs = [Request(uid, rng.integers(
                0, cfg.vocab_size, int(rng.integers(LM_PROMPT[0],
                                                    LM_PROMPT[1] + 1))
            ).tolist(), LM_MAX_TOKENS) for uid in range(LM_REQUESTS)]
    eng = Engine(cfg, params, batch_slots=LM_SLOTS, cache_len=LM_CACHE)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    ticks = eng.run_until_done()
    wall = time.perf_counter() - t0
    assert len(eng.finished) == LM_REQUESTS
    for r in eng.finished:
        assert len(r.generated) == LM_MAX_TOKENS, (r.uid, r.generated)
    fed = sum(len(r.prompt) + LM_MAX_TOKENS - 1 for r in reqs)
    tick_ms = [1e3 * t for t in eng.tick_s]
    # bound: the weights read once, the fp32 cast of the readout table
    # written and read once
    bound_bytes = param_bytes + 2 * 4 * cfg.vocab_size * cfg.d_model
    log(json.dumps({
        "lm_serve": LM_ARCH, "layers": cfg.n_layers, "slots": LM_SLOTS,
        "cache_len": LM_CACHE, "requests": LM_REQUESTS,
        "prompt_lens": [len(r.prompt) for r in reqs],
        "max_tokens": LM_MAX_TOKENS, "params": n_params,
        "param_bytes": param_bytes, "init_s": init_s,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "ticks": ticks, "wall_s": wall,
        "tokens_per_s": LM_REQUESTS * LM_MAX_TOKENS / wall,
        "fed_tokens_per_s": fed / wall,
        "first_tick_ms": tick_ms[0],
        "tick_ms_p50": float(np.percentile(tick_ms[1:], 50)),
        "tick_ms_p99": float(np.percentile(tick_ms[1:], 99)),
        "bound_tick_ms": 1e3 * bound_bytes / HBM_BYTES_PER_S}))

    # one profiled stretch of three ticks (4 busy slots)
    from torch.profiler import ProfilerActivity
    for uid in range(LM_SLOTS):
        eng.submit(Request(100 + uid, reqs[uid].prompt[:8], LM_MAX_TOKENS))
    eng.step()
    events, wall_us = traced_device_events(
        lambda: [eng.step() for _ in range(3)],
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if events:
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        busy_us = sum(e.self_device_time_total for e in events)
        log(f"profile lm_serve (3 ticks): wall {wall_us / 1e3:.3f} ms, "
            f"device busy {busy_us / 1e3:.3f} ms, idle share "
            f"{1 - busy_us / wall_us:.4f}, "
            f"{sum(e.count for e in events)} device events")
        for e in events[:8]:
            log(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
                f"x{e.count:<5d} {e.key[:90]}")
    else:
        log("profile lm_serve: not measured (no device event traced)")

    # slot reuse at batch 1 == a standalone greedy decode on the card
    target = reqs[0]
    want = standalone_greedy(params, cfg, target.prompt, LM_MAX_TOKENS,
                             LM_CACHE)
    eng1 = Engine(cfg, params, batch_slots=1, cache_len=LM_CACHE)
    eng1.submit(Request(0, reqs[1].prompt[:4], 4))
    eng1.submit(Request(1, list(target.prompt), LM_MAX_TOKENS))
    eng1.run_until_done()
    got = next(r for r in eng1.finished if r.uid == 1).generated
    assert got == want, f"slot reuse at batch 1: {got} != standalone {want}"
    log(f"lm_serve slot reuse: a {len(target.prompt)}-token prompt served "
        f"after another request in the one slot gives the standalone "
        f"greedy decode's {LM_MAX_TOKENS} tokens exactly")


def lm_decode_exact(seed: int) -> None:
    """14c: `LM_ARCH` widths at `LM_EXACT_LAYERS` layers in float32: decode
    logits equal forward logits at every position."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = registry.get(LM_ARCH).with_(n_layers=LM_EXACT_LAYERS,
                                      dtype="float32")
    torch.cuda.empty_cache()
    params = lm.init_params(cfg, seed + 1, device="cuda")
    b, t = 2, LM_EXACT_T
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t))).to("cuda", torch.int32)
    with torch.no_grad():
        hidden, _ = lm.forward_hidden(params, cfg, tokens)
        full = lm.logits_fn(params, cfg, hidden)
    states = lm.init_decode_state(params, cfg, b, t)
    err = 0.0
    for i in range(t):
        states, logits = lm.decode_step(
            params, cfg, states, tokens[:, i],
            torch.full((b,), i, dtype=torch.int32, device="cuda"))
        torch.testing.assert_close(
            logits, full[:, i], rtol=LM_EXACT_TOL, atol=LM_EXACT_TOL,
            msg=lambda m, i=i: f"decode != forward at position {i}: {m}")
        err = max(err, float((logits - full[:, i]).abs().max()))
    log(json.dumps({"lm_decode_vs_forward": LM_ARCH,
                    "layers": LM_EXACT_LAYERS, "dtype": "float32",
                    "batch": b, "positions": t, "tol": LM_EXACT_TOL,
                    "max_abs_err": err,
                    "logit_scale": float(full.abs().max())}))


def phase_lm(seed: int) -> None:
    """Phase 14: the LM serve path (14a parity, 14b serve, 14c exact)."""
    import torch
    assert not torch.backends.cuda.matmul.allow_tf32, \
        "TF32 matmuls would break the float32 tolerances"
    t0 = time.perf_counter()
    lm_parity(seed)
    t1 = time.perf_counter()
    lm_serve(seed)
    t2 = time.perf_counter()
    lm_decode_exact(seed)
    torch.cuda.empty_cache()
    log(f"phase 14: parity {t1 - t0:.1f} s, serve {t2 - t1:.1f} s, "
        f"decode == forward {time.perf_counter() - t2:.1f} s")


def on_card(tree) -> bool:
    """Every tensor of a dict/list tree (or of a module) lies on the
    card."""
    import torch
    if isinstance(tree, dict):
        return all(on_card(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(on_card(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return all(p.is_cuda for p in tree.parameters())
    return tree.is_cuda


def lm_train_parity(seed: int) -> None:
    """15a: one train step of each reduced arch (float32), both optimizer
    arms, on the card equals the port's CPU step."""
    import copy
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    for name in registry.ARCHS:
        cfg = registry.get(name, reduced=True).with_(dtype="float32")
        batch = batch_at(cfg, DataConfig(seed=seed, batch_size=2,
                                         seq_len=32), 0, "cpu")
        errs = {}
        for eight in (False, True):
            tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=1e-5,
                                                     warmup_steps=0),
                               opt_8bit=eight)
            init = opt.init_8bit if eight else opt.init
            cpu = lm.init_params(cfg, seed, device="cpu")
            gpu = copy.deepcopy(cpu).to("cuda")
            step = make_train_step(cfg, tcfg)
            _, _, want = step(cpu, init(cpu), batch)
            s_gpu = init(gpu)
            _, s_gpu, got = step(gpu, s_gpu, {k: v.cuda()
                                              for k, v in batch.items()})
            assert on_card(got) and on_card(s_gpu) and on_card(gpu)
            arm = "8bit" if eight else "fp32"
            err = {}
            for key in ("loss", "grad_norm"):
                assert bool(torch.isfinite(got[key])), f"{name} {key}"
                torch.testing.assert_close(
                    got[key].cpu(), want[key], rtol=TRAIN_PARITY_TOL,
                    atol=TRAIN_PARITY_TOL,
                    msg=lambda m, k=key: f"{name} {arm} {k}: GPU != CPU: {m}")
                err[key] = float((got[key].cpu() - want[key]).abs())
            worst = 0.0
            for (pname, a), b in zip(gpu.named_parameters(),
                                     cpu.parameters()):
                torch.testing.assert_close(
                    a.detach().cpu(), b.detach(), rtol=TRAIN_PARITY_TOL,
                    atol=TRAIN_PARITY_TOL,
                    msg=lambda m, n=pname: f"{name} {arm} {n}: GPU != CPU: "
                                           f"{m}")
                worst = max(worst, float((a.detach().cpu() - b.detach())
                                         .abs().max()))
            err["params"] = worst
            errs[arm] = err
        log(json.dumps({"lm_train_parity": name, "tol": TRAIN_PARITY_TOL,
                        "max_abs_err": errs}))


def model_flops(cfg, tokens: int) -> float:
    """A training step's model FLOPs: `roofline.analysis.model_flops_for`
    (6 (N - embedding) tokens), the embedding tables counted as the dry
    run counts them (both tables when untied)."""
    from repro_torch.models.config import param_count
    from repro_torch.roofline.analysis import (embedding_params,
                                               model_flops_for)
    return model_flops_for("train", param_count(cfg, active_only=True),
                           tokens, embedding_params(cfg))


def lm_train_arm(cfg, seed: int, eight: bool, tmp: str):
    """One arm of 15b: weights from ``seed``, a fresh optimizer state,
    `TRAIN_STEPS` steps of `train_loop`.  Returns (params, state,
    train_step, stats, the ``lm_train`` record)."""
    import math
    import numpy as np
    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.data.tokens import DataConfig, stream
    from repro_torch.models import lm
    from repro_torch.runtime.fault import train_loop
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed, device="cuda")
    state = (opt.init_8bit if eight else opt.init)(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tcfg = TrainConfig(adamw=opt.AdamWConfig(**TRAIN_ADAMW),
                       accum_steps=TRAIN_ACCUM, opt_8bit=eight)
    step_fn = make_train_step(cfg, tcfg)
    dcfg = DataConfig(seed=seed, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)

    def checked_step(p, s, batch):
        assert on_card(batch), "a batch off the card"
        p, s, metrics = step_fn(p, s, batch)
        assert on_card(metrics), "a metric off the card"
        return p, s, metrics

    # every > the steps run: no checkpoint at this width (29 GB each)
    stats = train_loop(
        train_step=checked_step, params=params, opt_state=state,
        data_stream_fn=lambda s: stream(cfg, dcfg, s, device="cuda"),
        ckpt=CheckpointManager(tmp, every=10 * TRAIN_STEPS),
        total_steps=TRAIN_STEPS)
    arm = "8bit" if eight else "fp32"
    losses = stats.losses
    assert stats.steps == TRAIN_STEPS and stats.restarts == 0
    assert all(math.isfinite(x) for x in losses), (arm, losses)
    assert sum(losses[-2:]) < sum(losses[:2]), \
        f"{arm}: the loss did not fall: {losses}"
    assert on_card(params) and on_card(state)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(cfg, tokens)
    p50 = float(np.percentile(stats.step_times, 50))
    record = {
        "lm_train": TRAIN_ARCH, "arm": arm, "layers": cfg.n_layers,
        "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
        "accum_steps": TRAIN_ACCUM, "steps": TRAIN_STEPS,
        "params": sum(p.numel() for p in params.parameters()),
        "init_s": init_s, "losses": losses,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "step_s": stats.step_times, "step_s_p50": p50,
        "step_s_max": max(stats.step_times),
        "tokens_per_s": tokens / p50, "model_flops_per_step": flops,
        "mfu": flops / p50 / BF16_PEAK_FLOPS}
    return params, state, checked_step, record


#: device-time classes of the training step's profile, first match wins
TRAIN_PROFILE_CLASSES = (
    ("fp32 gemm", ("f32f32_f32f32", "sgemm")),
    ("bf16 gemm", ("gemm", "nvjet", "xmma", "cutlass")),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def train_profile_split(events) -> dict:
    """Device ms of profiled events by `TRAIN_PROFILE_CLASSES` (the rest
    under "other")."""
    split = {name: 0.0 for name, _ in TRAIN_PROFILE_CLASSES}
    split["other"] = 0.0
    for e in events:
        key = e.key.lower()
        name = next((n for n, marks in TRAIN_PROFILE_CLASSES
                     if any(m in key for m in marks)), "other")
        split[name] += e.self_device_time_total / 1e3
    return split


def lm_train(seed: int, tmp: str) -> None:
    """15b: `TRAIN_ARCH` at its published widths and depth, fp32 AdamW then
    the 8-bit arm, one fp32 step profiled."""
    import gc
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig, batch_at
    cfg = registry.get(TRAIN_ARCH)
    assert (cfg.param_dtype, cfg.dtype, cfg.remat) == \
        ("float32", "bfloat16", True), cfg
    log(f"lm_train: {TRAIN_ARCH} {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim "
        f"{cfg.resolved_head_dim()}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, window {cfg.sliding_window}; seq {TRAIN_SEQ}, "
        f"global batch {TRAIN_BATCH} in {TRAIN_ACCUM} micro-batches. CUT: "
        f"random weights (no checkpoint offline), global batch "
        f"{TRAIN_BATCH} instead of 256, {TRAIN_STEPS} steps per arm, no "
        f"checkpoint written at this width")
    for eight in (False, True):
        params, state, step_fn, record = lm_train_arm(cfg, seed, eight, tmp)
        log(json.dumps(record))
        if not eight:
            # one more fp32 step under the profiler
            batch = batch_at(cfg, DataConfig(seed=seed,
                                             batch_size=TRAIN_BATCH,
                                             seq_len=TRAIN_SEQ),
                             TRAIN_STEPS, "cuda")
            events, wall_us = traced_device_events(
                lambda: float(step_fn(params, state, batch)[2]["loss"]),
                [ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if events:
                events.sort(key=lambda e: e.self_device_time_total,
                            reverse=True)
                busy_us = sum(e.self_device_time_total for e in events)
                log(f"profile lm_train (1 fp32 step): wall "
                    f"{wall_us / 1e3:.3f} ms, device busy "
                    f"{busy_us / 1e3:.3f} ms, idle share "
                    f"{1 - busy_us / wall_us:.4f}, "
                    f"{sum(e.count for e in events)} device events")
                log(json.dumps({"lm_train_profile_ms":
                                train_profile_split(events)}))
                for e in events[:10]:
                    log(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
                        f"x{e.count:<6d} {e.key[:160]}")
            else:
                log("profile lm_train: not measured (no device event "
                    "traced)")
            del batch
        del params, state, step_fn
        gc.collect()
        torch.cuda.empty_cache()


def lm_train_faults(seed: int, tmp: str) -> None:
    """15c: `train_loop` on the card at the reference test's tiny config,
    failures at steps 3 and 7, against an uninterrupted run."""
    import copy
    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig, stream
    from repro_torch.models import lm
    from repro_torch.runtime.fault import FailureInjector, train_loop
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    cfg = registry.get("qwen3", reduced=True).with_(dtype="float32",
                                                     n_layers=2)
    init = lm.init_params(cfg, seed, device="cuda")
    dcfg = DataConfig(batch_size=2, seq_len=32)

    def run(path, injector):
        params = copy.deepcopy(init)
        return train_loop(
            train_step=make_train_step(cfg, TrainConfig(
                adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=0))),
            params=params, opt_state=opt.init(params),
            data_stream_fn=lambda s: stream(cfg, dcfg, s, device="cuda"),
            ckpt=CheckpointManager(path, every=2, keep_n=2),
            total_steps=10, injector=injector)

    clean = run(f"{tmp}/clean", None)
    stats = run(f"{tmp}/faulty", FailureInjector(at_steps=(3, 7)))
    ran = [0, 1, 2, 2, 3, 4, 5, 6, 6, 7, 8, 9]     # resumed at 2 and 6
    assert stats.restarts == 2 and stats.steps == len(ran), stats
    assert sorted(set(ran)) == list(range(10))
    want = [clean.losses[s] for s in ran]
    torch.testing.assert_close(torch.tensor(stats.losses),
                               torch.tensor(want), rtol=TRAIN_LOOP_RTOL,
                               atol=0)
    rel = max(abs(a - b) / abs(b) for a, b in zip(stats.losses, want))
    log(json.dumps({"lm_train_faults": "qwen3-reduced", "layers": 2,
                    "failures_at": [3, 7], "restarts": stats.restarts,
                    "steps": stats.steps, "rtol": TRAIN_LOOP_RTOL,
                    "max_rel_err": rel,
                    "bitwise": stats.losses == want}))


def phase_train(seed: int) -> None:
    """Phase 15: the LM training path (15a parity, 15b full width, 15c
    the fault-tolerant loop)."""
    import gc
    import tempfile
    import torch
    assert not torch.backends.cuda.matmul.allow_tf32, \
        "TF32 matmuls would break the float32 tolerances"
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_train_parity(seed)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lm_train(seed, f"{tmp}/full")
        t2 = time.perf_counter()
        lm_train_faults(seed, f"{tmp}/faults")
    torch.cuda.empty_cache()
    log(f"phase 15: parity {t1 - t0:.1f} s, full width {t2 - t1:.1f} s, "
        f"fault loop {time.perf_counter() - t2:.1f} s")


def _mesh_card_setup(rank: int, world: int, store: str):
    """A spawned rank of phase 16: one intra-op thread, gloo over a file
    store, on cuda:0 like every other rank."""
    # the ranks share one card: segments that grow in place leave less
    # of it reserved and unused (read at the first allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def _mesh_steps(mesh, step_fn, params, state, batches) -> list:
    """`step_fn` on ``mesh`` over ``batches`` (plain, the same on every
    rank).  Returns one record per step: loss, seconds (every rank
    synchronised), `CommDebugMode` counts by kind and the bytes staged
    through the host (`launch.staging`)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch import mesh as lmesh, staging
    from repro_torch.models.sharding import logical_axis_rules
    out = []
    with logical_axis_rules(lmesh.rules_for(mesh)):
        for batch in batches:
            b = lmesh.distribute_batch(mesh, {k: v.cuda()
                                              for k, v in batch.items()})
            staging.reset()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            with CommDebugMode() as comm:
                _, _, m = step_fn(params, state, b)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            dist.barrier()
            out.append({"loss": loss, "s": time.perf_counter() - t0,
                        "comm": {str(k).rpartition(".")[2]: v for k, v in
                                 comm.get_comm_counts().items()},
                        "staged": dict(staging.STAGED)})
    return out


def mesh_contract_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of 16a: both contracts of ``test_multidevice_train.py``
    on cuda:0 (see `phase_mesh`); rank 0 writes ``<tmp>/16a.pt``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    _mesh_card_setup(rank, world, f"{tmp}/store16a")
    try:
        job = torch.load(f"{tmp}/16a_job.pt", weights_only=False)
        cfg, batches = job["cfg"], job["batches"]
        step_fn = make_train_step(cfg, TrainConfig(adamw=opt.AdamWConfig(
            **MESH_ADAMW)))

        def fresh():
            p = lm.init_params(cfg, job["seed"], device="cuda")
            return p, opt.init(p)

        mesh = lmesh.make_mesh(MESH_SHAPES[0], ("data", "model"))
        assert mesh.device_type == "cuda", mesh
        p, s = fresh()
        specs = lmesh.param_specs(p, model_divisor=MESH_SHAPES[0][1])
        places = lmesh.named_shardings(mesh, specs)
        rep = {k: (Replicate(),) * mesh.ndim for k in places}
        p, s = lmesh.place_on_mesh(mesh, p, places, s, rep)
        runs = {"mesh": _mesh_steps(mesh, step_fn, p, s, batches[:3])}
        zero1 = lmesh.named_shardings(mesh, opt.zero1_specs(
            specs, p, data_divisor=MESH_SHAPES[0][0]))
        pz, sz = fresh()
        pz, sz = lmesh.place_on_mesh(mesh, pz, places, sz, zero1)
        runs["zero1"] = _mesh_steps(mesh, step_fn, pz, sz, batches[:3])
        save(f"{tmp}/ckpt16a", 3, {"params": p, "opt": s}, host_id=rank)
        saved = {k: t.full_tensor() for k, t in p.named_parameters()}
        saved.update({f"m.{k}": t.full_tensor() for k, t in s["m"].items()})
        mesh2 = lmesh.make_mesh(MESH_SHAPES[1], ("data", "model"))
        p2, s2 = fresh()
        places2 = lmesh.named_shardings(mesh2, lmesh.param_specs(
            p2, model_divisor=MESH_SHAPES[1][1]))
        rep2 = {k: (Replicate(),) * mesh2.ndim for k in places2}
        tree, _, step_no = restore(
            f"{tmp}/ckpt16a", {"params": p2, "opt": s2},
            shardings=(mesh2, {"params": places2,
                               "opt": {"m": rep2, "v": rep2}}))
        p2, s2 = tree["params"], tree["opt"]
        got = {k: t.full_tensor() for k, t in p2.named_parameters()}
        got.update({f"m.{k}": t.full_tensor() for k, t in s2["m"].items()})
        bitwise = step_no == 3 and all(
            torch.equal(got[k], saved[k]) for k in saved) and all(
            tuple(t.placements) == places2[k]
            for k, t in p2.named_parameters())
        runs["elastic"] = _mesh_steps(mesh2, step_fn, p2, s2, batches[3:4])
        zero1_cut = sum(sz["m"][k].placements[0].is_shard() for k in sz["m"])
        if rank == 0:
            torch.save({"runs": runs, "bitwise": bitwise,
                        "zero1_cut": zero1_cut, "leaves": len(sz["m"])},
                       f"{tmp}/16a.pt")
    finally:
        dist.destroy_process_group()


def mesh_full_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of 16b: `MESH_FULL_ARCH` cut to `MESH_FULL_LAYERS` layers
    on a `MESH_FULL_SHAPE` mesh, fp32 AdamW with ZeRO-1 moments;
    writes ``<tmp>/16b.<rank>.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    _mesh_card_setup(rank, world, f"{tmp}/store16b")
    try:
        job = torch.load(f"{tmp}/16b_job.pt", weights_only=False)
        cfg = job["cfg"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mesh = lmesh.make_mesh(MESH_FULL_SHAPE, ("data", "model"))
        params = lm.init_params(cfg, job["seed"], device="cuda")
        specs = lmesh.param_specs(params, model_divisor=MESH_FULL_SHAPE[1])
        places = lmesh.named_shardings(mesh, specs)
        zero1 = lmesh.named_shardings(mesh, opt.zero1_specs(
            specs, params, data_divisor=MESH_FULL_SHAPE[0]))
        # the moments are made at the placed parameters' placements, then
        # cut over data: no rank ever holds the full-size state
        params, _ = lmesh.place_on_mesh(mesh, params, places)
        params, state = lmesh.place_on_mesh(mesh, params, places,
                                            opt.init(params), zero1)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        step_fn = make_train_step(cfg, TrainConfig(
            adamw=opt.AdamWConfig(**TRAIN_ADAMW)))
        steps = _mesh_steps(mesh, step_fn, params, state, job["batches"])
        local = sum(p.to_local().numel() for p in params.parameters())
        torch.save({"steps": steps, "init_s": init_s, "local_params": local,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
                    "card_free_gib": torch.cuda.mem_get_info()[0] / 2**30},
                   f"{tmp}/16b.{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, world: int, tmp: str, label: str,
                deadline_s: float = MESH_DEADLINE_S) -> float:
    """``world`` spawned processes running ``target(rank, world, tmp)``
    under ``deadline_s``; every one must exit 0.  Returns the seconds
    taken."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, world, tmp))
             for rank in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, \
        f"{label}: ranks {hung} still running after {deadline_s} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{label}: rank exit codes {codes}"
    return time.perf_counter() - t0


def one_rank_steps(cfg, seed: int, batches, adamw: dict,
                   eight: bool = False, snapshot: bool = False) -> tuple:
    """The one-rank card run phases 16 and 17d hold a mesh to: weights
    from ``seed``, fp32 AdamW (the 8-bit arm with ``eight``), one step
    per batch.  Returns (losses, step seconds, peak GiB, the final
    `optimizer.snapshot_8bit` with ``snapshot``, else None)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed, device="cuda")
    state = (opt.init_8bit if eight else opt.init)(params)
    step_fn = make_train_step(cfg, TrainConfig(
        adamw=opt.AdamWConfig(**adamw), opt_8bit=eight))
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # only the metrics are kept: a name bound to the returned state
        # would keep it on the card through the spawn that follows
        m = step_fn(params, state, {k: v.cuda() for k, v in b.items()})[2]
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    snap = opt.snapshot_8bit(params, state) if snapshot else None
    del params, state
    torch.cuda.empty_cache()
    return losses, times, peak, snap


def mesh_contracts(seed: int, tmp: str, smi: str) -> None:
    """16a: both contracts of ``test_multidevice_train.py`` with
    `MESH_RANKS` gloo ranks on cuda:0."""
    import math
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig, batch_at
    cfg = registry.get("qwen3", reduced=True).with_(
        dtype="float32", n_layers=2, n_heads=4, n_kv_heads=2)
    dcfg = DataConfig(batch_size=4, seq_len=32)
    batches = [batch_at(cfg, dcfg, i, "cpu") for i in range(4)]
    want, _, _, _ = one_rank_steps(cfg, seed, batches[:3], MESH_ADAMW)
    torch.save({"cfg": cfg, "seed": seed, "batches": batches},
               f"{tmp}/16a_job.pt")
    wall = spawn_ranks(mesh_contract_rank, MESH_RANKS, tmp, "16a")
    got = torch.load(f"{tmp}/16a.pt", weights_only=False)
    runs = got["runs"]
    for name in ("mesh", "zero1"):
        losses = [r["loss"] for r in runs[name]]
        torch.testing.assert_close(torch.tensor(losses), torch.tensor(want),
                                   rtol=MESH_RTOL, atol=MESH_ATOL,
                                   msg=f"16a {name}: {losses} vs {want}")
    assert got["bitwise"], "16a: the restore onto (4, 2) is not bitwise"
    assert got["zero1_cut"] > 0, "16a: ZeRO-1 cut no moment over data"
    elastic = runs["elastic"][0]["loss"]
    assert math.isfinite(elastic), elastic
    log(json.dumps({
        "lm_mesh_contracts": "qwen3-reduced", "card": smi, "ranks":
        MESH_RANKS, "backend": "gloo on cuda:0", "meshes": MESH_SHAPES,
        "one_rank_losses": want,
        "mesh_losses": [r["loss"] for r in runs["mesh"]],
        "zero1_losses": [r["loss"] for r in runs["zero1"]],
        "zero1_moments_cut_over_data": f"{got['zero1_cut']}/{got['leaves']}",
        "rtol": MESH_RTOL, "atol": MESH_ATOL, "restore_bitwise": True,
        "elastic_loss": elastic, "comm_per_step": runs["mesh"][0]["comm"],
        "staged_per_step": runs["mesh"][0]["staged"],
        "spawned_s": wall}))


def mesh_full(seed: int, tmp: str, smi: str) -> None:
    """16b: `MESH_FULL_ARCH` at its published widths on a
    `MESH_FULL_SHAPE` mesh, held to a one-rank run of the same cut."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig, batch_at
    full = registry.get(MESH_FULL_ARCH)
    cfg = full.with_(n_layers=MESH_FULL_LAYERS)
    assert (cfg.param_dtype, cfg.dtype, cfg.remat) == \
        ("float32", "bfloat16", True), cfg
    dcfg = DataConfig(seed=seed, batch_size=MESH_FULL_BATCH,
                      seq_len=TRAIN_SEQ)
    batches = [batch_at(cfg, dcfg, i, "cpu") for i in range(MESH_FULL_STEPS)]
    want, one_s, one_peak, _ = one_rank_steps(cfg, seed, batches,
                                              TRAIN_ADAMW)
    torch.save({"cfg": cfg, "seed": seed, "batches": batches},
               f"{tmp}/16b_job.pt")
    world = math.prod(MESH_FULL_SHAPE)
    wall = spawn_ranks(mesh_full_rank, world, tmp, "16b",
                       MESH_FULL_DEADLINE_S)
    ranks = [torch.load(f"{tmp}/16b.{r}.pt", weights_only=False) for r in range(world)]
    steps = ranks[0]["steps"]
    losses = [s["loss"] for s in steps]
    assert all(math.isfinite(x) for x in losses), losses
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    assert rel <= MESH_FULL_RTOL, \
        f"16b: mesh losses {losses} vs one rank {want} (rel {rel})"
    times = [s["s"] for s in steps]
    later = times[1:] or times
    tokens = MESH_FULL_BATCH * TRAIN_SEQ
    p50 = float(np.percentile(later, 50))
    log(json.dumps({
        "lm_train_mesh": MESH_FULL_ARCH, "card": smi,
        "mesh": {"data": MESH_FULL_SHAPE[0], "model": MESH_FULL_SHAPE[1]},
        "ranks": world, "backend": "gloo on cuda:0, collectives staged "
        "through host memory", "layers": cfg.n_layers,
        "layers_published": full.n_layers, "seq_len": TRAIN_SEQ,
        "global_batch": MESH_FULL_BATCH, "steps": MESH_FULL_STEPS,
        "optimizer": "fp32 AdamW, m and v under zero1_specs",
        "losses": losses, "one_rank_losses": want, "max_rel_err": rel,
        "rtol": MESH_FULL_RTOL, "step_s": times,
        "step_s_p50_after_first": p50, "step_s_max": max(times),
        "tokens_per_s": tokens / p50,
        "model_flops_per_step": model_flops(cfg, tokens),
        "mfu": model_flops(cfg, tokens) / p50 / BF16_PEAK_FLOPS,
        "one_rank_step_s": one_s,
        "one_rank_peak_gib": one_peak,
        "init_s": max(r["init_s"] for r in ranks),
        "local_params_per_rank": [r["local_params"] for r in ranks],
        "peak_gib_per_rank": [r["peak_gib"] for r in ranks],
        "reserved_gib_per_rank": [r["reserved_gib"] for r in ranks],
        "card_free_gib_after": min(r["card_free_gib"] for r in ranks),
        "comm_per_step": steps[-1]["comm"],
        "staged_per_step": steps[-1]["staged"],
        "staged_s_per_rank": [r["steps"][-1]["staged"].get("staged s", 0.0)
                              for r in ranks],
        "device_wait_s_per_rank": [
            r["steps"][-1]["staged"].get("device wait s", 0.0)
            for r in ranks],
        "spawned_s": wall}))


def phase_mesh(seed: int, smi: str | None = None) -> None:
    """Phase 16: the sharding and launch slice on DeviceMesh + DTensor
    (16a the reference's two mesh contracts, 16b the full-width mesh
    run)."""
    import gc
    import tempfile
    import torch
    assert not torch.backends.cuda.matmul.allow_tf32, \
        "TF32 matmuls would break the float32 tolerances"
    smi = smi or card_line()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh_contracts(seed, tmp, smi)
        t1 = time.perf_counter()
        mesh_full(seed, tmp, smi)
    log(f"phase 16: contracts {t1 - t0:.1f} s, full width "
        f"{time.perf_counter() - t1:.1f} s")


def mesh_8bit_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of 17d: the 8-bit arm on each mesh of `MESH_SHAPES`, q and
    v under `zero1_specs`, the scales under `optimizer.qs_specs`; rank 0
    writes ``<tmp>/17d.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.dryrun import qs_axis_size
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    _mesh_card_setup(rank, world, f"{tmp}/store17d")
    try:
        job = torch.load(f"{tmp}/17d_job.pt", weights_only=False)
        cfg, batches = job["cfg"], job["batches"]
        step_fn = make_train_step(cfg, TrainConfig(
            adamw=opt.AdamWConfig(**MESH_ADAMW), opt_8bit=True))
        runs, cut, snaps = {}, {}, {}
        for shape in MESH_SHAPES:
            mesh = lmesh.make_mesh(shape, ("data", "model"))
            p = lm.init_params(cfg, job["seed"], device="cuda")
            specs = lmesh.param_specs(p, model_divisor=shape[1])
            qs = opt.qs_specs(opt.zero1_specs(specs, p, shape[0]), p,
                              qs_axis_size(mesh))
            p, s = lmesh.place_on_mesh(
                mesh, p, lmesh.named_shardings(mesh, specs),
                opt.init_8bit(p), lmesh.named_shardings(mesh, qs))
            key = "x".join(map(str, shape))
            runs[key] = _mesh_steps(mesh, step_fn, p, s, batches)
            snaps[key] = opt.snapshot_8bit(p, s)
            cut[key] = sum(any(pl.is_shard() for pl in mq["s"].placements)
                           for mq in s["m"].values())
        if rank == 0:
            torch.save({"runs": runs, "scales_cut": cut, "snaps": snaps,
                        "leaves": len(s["m"])}, f"{tmp}/17d.pt")
    finally:
        dist.destroy_process_group()


def roofline_step(seed: int, smi: str) -> None:
    """17a: phase 15's one-rank fp32 step of `TRAIN_ARCH` analysed on the
    card and on meta tensors on the host: flops, bytes and op counts
    equal; the predicted peak beside the measured one, the roofline
    terms, the measured step against ``t_bound`` and the mfu."""
    import gc
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.launch import inputs
    from repro_torch.models import lm
    from repro_torch.roofline.analysis import Roofline
    from repro_torch.roofline.hlo_analyze import Analyzer, nbytes, tensors_in
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    cfg = registry.get(TRAIN_ARCH)
    tcfg = TrainConfig(adamw=opt.AdamWConfig(**TRAIN_ADAMW),
                       accum_steps=TRAIN_ACCUM)
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def analysed(params, state, batch):
        args = (params, state, batch)
        arg_bytes = sum(map(nbytes, tensors_in(args)))
        t0 = time.perf_counter()
        with Analyzer() as an:
            make_train_step(cfg, tcfg)(*args)
        torch.cuda.synchronize()
        return an.cost, arg_bytes, time.perf_counter() - t0

    params = inputs.params_specs(cfg)
    meta = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                           device="meta") for k in ("tokens", "labels")}
    on_meta, meta_args, meta_s = analysed(params, opt.init(params), meta)
    del params
    params = lm.init_params(cfg, seed, device="cuda")
    state = opt.init(params)
    batch = batch_at(cfg, DataConfig(seed=seed, batch_size=TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ), 0, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(make_train_step(cfg, tcfg)(params, state, batch)[2]["loss"])
    step_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    on_card, card_args, card_s = analysed(params, state, batch)
    measured_peak = torch.cuda.max_memory_allocated()
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    for key in ("flops", "bytes", "ops"):
        a, b = getattr(on_card, key), getattr(on_meta, key)
        assert a == b, f"17a: {key} on the card {a} != on meta {b}"
    assert card_args == meta_args, (card_args, meta_args)
    roof = Roofline(flops=on_card.flops, bytes_accessed=on_card.bytes,
                    wire_bytes=0.0, n_chips=1,
                    model_flops=model_flops(cfg, tokens))
    log(json.dumps({
        "roofline_step": TRAIN_ARCH, "card": smi, "layers": cfg.n_layers,
        "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
        "accum_steps": TRAIN_ACCUM, "arm": "fp32",
        "equal_on_card_and_meta": ["flops", "bytes", "ops"],
        "flops": on_card.flops, "bytes": on_card.bytes, "ops": on_card.ops,
        "distinct_bytes": [on_card.distinct_bytes, on_meta.distinct_bytes],
        "predicted_peak_gib": (card_args + on_card.peak_bytes) / 2**30,
        "predicted_peak_on_meta_gib": (meta_args + on_meta.peak_bytes)
        / 2**30,
        "measured_peak_gib": measured_peak / 2**30,
        "roofline": roof.to_dict(), "t_bound_s": roof.t_bound,
        "step_s": step_s, "step_over_t_bound": step_s / roof.t_bound,
        "mfu": roof.model_flops / step_s / BF16_PEAK_FLOPS,
        "analysed_s": {"card": card_s, "meta": meta_s}}))


def dryrun_cells(tmp: str, smi: str) -> None:
    """17b: ``python -m repro_torch.launch.dryrun`` as a child per cell,
    each under `DRYRUN_CELLS`' deadline: ``status`` ok, the per-rank
    terms printed; the BFS cell's rowsweep launched on the card."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "DRYRUN_RESULTS": f"{tmp}/dryrun"}
    for argv, deadline_s in DRYRUN_CELLS:
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--force"], env=env, capture_output=True, text=True,
            timeout=deadline_s, cwd=tmp)
        wall = time.perf_counter() - t0
        assert done.returncode == 0, \
            f"17b {argv}: exit {done.returncode}: {done.stderr[-2000:]}"
        (path,) = Path(f"{tmp}/dryrun").glob(
            "bfs-*" if "--bfs" in argv else
            f"*__{argv[argv.index('--shape') + 1]}__*")
        res = json.loads(path.read_text())
        path.unlink()
        assert res["status"] == "ok", f"17b {argv}: {res['status']}: " \
            f"{res.get('traceback', '')[-2000:]}"
        if "--bfs" in argv:
            assert res["kernel_launches"]["rowsweep"] > 0, res
        log(json.dumps({"dryrun": " ".join(argv), "card": smi,
                        "wall_s": wall, **res}))


def mesh_8bit(seed: int, tmp: str, smi: str) -> None:
    """17d: the 8-bit arm on 16a's meshes, held to one rank's 8-bit run:
    losses within `MESH_RTOL`, `MESH_ATOL`, parameters and state within
    `GATE_8BIT`, which one rank's fp32 run must fail."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.train import optimizer as opt
    cfg = registry.get("qwen3", reduced=True).with_(
        dtype="float32", n_layers=2, n_heads=4, n_kv_heads=2)
    dcfg = DataConfig(batch_size=4, seq_len=32)
    batches = [batch_at(cfg, dcfg, i, "cpu") for i in range(3)]
    want, _, _, one = one_rank_steps(cfg, seed, batches, MESH_ADAMW,
                                     eight=True, snapshot=True)
    fp32 = opt.gap_8bit(one, one_rank_steps(cfg, seed, batches, MESH_ADAMW,
                                            snapshot=True)[3])
    over = {k for k, limit in GATE_8BIT.items() if fp32[k] > limit}
    assert over >= {"q_share", "s_rel", "p_share"}, \
        f"17d: the fp32 arm's state passes the 8-bit gate: {fp32}"
    torch.save({"cfg": cfg, "seed": seed, "batches": batches},
               f"{tmp}/17d_job.pt")
    wall = spawn_ranks(mesh_8bit_rank, MESH_RANKS, tmp, "17d")
    got = torch.load(f"{tmp}/17d.pt", weights_only=False)
    for key, run in got["runs"].items():
        losses = [r["loss"] for r in run]
        torch.testing.assert_close(torch.tensor(losses), torch.tensor(want),
                                   rtol=MESH_RTOL, atol=MESH_ATOL,
                                   msg=f"17d {key}: {losses} vs {want}")
    gaps = {k: opt.gap_8bit(one, snap) for k, snap in got["snaps"].items()}
    for key, gap in gaps.items():
        over = {k: gap[k] for k, limit in GATE_8BIT.items()
                if gap[k] > limit}
        assert not over, f"17d {key}: state off one rank's 8-bit: {gap}"
    log(json.dumps({
        "lm_mesh_8bit": "qwen3-reduced", "card": smi, "ranks": MESH_RANKS,
        "backend": "gloo on cuda:0", "one_rank_losses": want,
        "mesh_losses": {k: [r["loss"] for r in run]
                        for k, run in got["runs"].items()},
        "rtol": MESH_RTOL, "atol": MESH_ATOL, "state_gate": GATE_8BIT,
        "state_gap": gaps, "fp32_arm_state_gap": fp32,
        "scales_cut_over_a_mesh_dim": got["scales_cut"],
        "leaves": got["leaves"],
        "comm_per_step": {k: run[0]["comm"]
                          for k, run in got["runs"].items()},
        "spawned_s": wall}))


def drift_gate(g12, g12_cpu) -> None:
    """17c's gate: `measure_drift` of the same SCALE-12 graph gives the
    same rows on the card and on the CPU."""
    from repro_torch import formats
    from repro_torch.obs.cost_drift import measure_drift
    for label, (gg, gc) in (
            ("csr", (g12, g12_cpu)),
            ("sell", (formats.SellFormat.from_csr(g12),
                      formats.SellFormat.from_csr(g12_cpu)))):
        pipes = DRIFT_PIPELINES[label]
        a = measure_drift(gg, pipelines=pipes)
        c = measure_drift(gc, pipelines=pipes, device="cpu")
        assert a == c, f"17c {label} @ SCALE 12: card {a} != CPU {c}"
    log("drift @ SCALE 12: card == CPU (analytic, compiled and distinct "
        "bytes) for " + ", ".join(f"{k} {'/'.join(v)}"
                                  for k, v in DRIFT_PIPELINES.items()))


def drift_cells(seed: int, smi: str) -> None:
    """17c: `measure_drift`'s rows on the main path's graph (made from
    ``seed``), CSR and SELL, and `drift_gate` at SCALE 12."""
    from repro_torch import formats
    from repro_torch.obs.cost_drift import measure_drift
    g = make_graph(MAIN.scale, seed, "cuda")
    for label, fmt in (("csr", g), ("sell", formats.SellFormat.from_csr(g))):
        for d in measure_drift(fmt, pipelines=DRIFT_PIPELINES[label]):
            log(json.dumps({"drift": d._asdict(),
                            "n_vertices": g.n_vertices, "ratio": d.ratio,
                            "hlo_ratio": d.hlo_ratio, "card": smi}))
    g12 = make_graph(12, seed, "cuda")
    drift_gate(g12, type(g12)(g12.rows.cpu(), g12.colstarts.cpu(),
                              g12.n_vertices, g12.n_edges))


def phase_roofline(seed: int, smi: str | None = None) -> None:
    """Phase 17: the roofline and the dry run (17a the analyzer on the
    card against meta, 17b the dry run's cells, 17c `measure_drift`,
    17d the 8-bit arm on a mesh)."""
    import gc
    import tempfile
    import torch
    smi = smi or card_line()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    roofline_step(seed, smi)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dryrun_cells(tmp, smi)
    t2 = time.perf_counter()
    drift_cells(seed, smi)
    t3 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh_8bit(seed, tmp, smi)
    log(f"phase 17: analyzer {t1 - t0:.1f} s, dry run {t2 - t1:.1f} s, "
        f"drift {t3 - t2:.1f} s, 8-bit mesh {time.perf_counter() - t3:.1f} "
        f"s; whole {time.perf_counter() - t0:.1f} s")


def table_choices(table: dict, fmt_name: str, geom: str) -> dict:
    """{knob token: value} of the rows under ``affinity.<fmt>.<geom>.``,
    the lowest ``us_per_call`` of each knob group, read from the table
    as written (not through `affinity`)."""
    import re
    best = {}
    prefix = f"affinity.{fmt_name}.{geom}."
    for key, rec in table.items():
        if not key.startswith(prefix):
            continue
        tail = key[len(prefix):]
        m = re.fullmatch(r"(pipeline|policy|algorithm|merge)_(.+)", tail) \
            or re.fullmatch(r"([a-z_]+?)(\d+)", tail)
        knob, value = m.group(1), m.group(2)
        value = value if knob in ("pipeline", "policy", "algorithm",
                                  "merge") else int(value)
        us = float(rec["us_per_call"])
        if knob not in best or us < best[knob][1]:
            best[knob] = (value, us)
    return {k: v for k, (v, _) in best.items()}


def expected_spec(choices: dict, fmt, skew: float) -> dict:
    """The all-auto spec's fields that ``choices`` (a `table_choices`)
    decide for ``fmt``, with the built-in default where no row
    exists; the CSR tile under its cap (``e_pad / 8``, the edge
    stream)."""
    import repro_torch.bfs as bfs
    from repro_torch.formats.autotune import SKEW_THRESHOLD
    want = dict(pipeline=choices.get("pipeline", "fused_gather"),
                prefetch_depth=choices.get("prefetch", 0),
                algorithm=choices.get("algorithm", "simd"),
                packed=bool(choices.get("packed", True)),
                max_layers=choices.get("maxlayers", 64),
                merge=choices.get("merge", "packed"),
                policy=type(bfs.POLICIES[choices["policy"]]())
                if "policy" in choices else
                (bfs.BeamerHybrid if skew >= SKEW_THRESHOLD
                 else bfs.ThresholdSimd))
    if fmt.name == "csr":
        e_pad = fmt.n_edges_padded
        tile = max(128, min(choices.get("tile", BUILTIN_CSR_TILE),
                            max(e_pad // 8, 128)))
        want["tile"] = min(tile, max(e_pad, 128))
    return want


def has_kernel(kernels: dict, name: str) -> bool:
    """Whether a device kernel named exactly ``name`` (not a name that
    merely contains it) is among the profiler's ``kernels``."""
    import re
    pat = re.compile(rf"(?<![A-Za-z0-9_]){name}(?![A-Za-z0-9_])")
    return any(pat.search(k) for k in kernels)


def phase_affinity(g, roots, oracle, seed: int, smi: str) -> None:
    """Phase 18: the affinity table on the card, on the main path's
    graph (phase 2's roots) and on the reference sweep's torus.  a. the
    geometry class on the card equals the class of a CPU copy made with
    `interop`; b. the all-auto `TraversalSpec()` resolves field by field
    to the committed table's lowest rows, on CSR and on
    `SellFormat.from_csr` (whose σ comes from the table); c. the resolved
    plan's batch equals the ``fused_gather`` depth-0 plan of the same
    layout and tile in visited sets, depths, direction log and stats
    columns 0-6 (column 7 counts launches, which differ by pipeline;
    column 5 as in `tests/test_torch_traversal_union.py`), with valid
    trees and no degrade; d. the profiler lists the kernels
    its pipeline launches (`PIPELINE_KERNELS`), and none that marks
    another pipeline; one wall per resolved plan beside the
    ``fused_gather`` depth-0 wall on the same roots (a record, not a
    claim)."""
    import numpy as np
    import torch
    import repro_torch.bfs as bfs
    from repro_torch import interop
    from repro_torch.api.spec import as_format
    from repro_torch.core.engine import MODE_SCALAR
    from repro_torch.formats import SellFormat, affinity, autotune
    from repro_torch.obs.metrics import clear_degrade_log, degrade_log
    t0 = time.perf_counter()
    path = affinity._table_path()
    table = json.loads(path.read_text())
    log(f"affinity table: {path.name}, {len(table) - 1} rows, "
        f"swept on {table['card']}")
    dev = str(g.device)
    torus = torus_graph(TORUS_SIDE, dev)
    torus_roots = pick_roots(torus, BATCH, seed + 5)
    rows_np = torus.rows.cpu().numpy()
    cs_np = torus.colstarts.cpu().numpy()

    def torus_oracle(root):
        from repro_torch.core import bfs_serial
        return bfs_serial.bfs_serial(rows_np, cs_np, torus.n_vertices,
                                     root)[1]

    walls = []
    with affinity.table_at(path):
        for label, graph, rts, orc in (
                (f"rmat-{MAIN.scale}", g, roots, oracle),
                (f"torus{TORUS_SIDE}", torus, torus_roots, torus_oracle)):
            # a. the class on the card equals the class on the CPU
            cpu = interop.csr_from_arrays(
                graph.rows.cpu().numpy(), graph.colstarts.cpu().numpy(),
                graph.n_vertices, graph.n_edges, device="cpu")
            affinity.clear_cache()
            geom_cpu = affinity.geometry_class(cpu)
            del cpu
            affinity.clear_cache()
            geom = affinity.geometry_class(graph)
            assert geom == geom_cpu, (label, geom, geom_cpu)
            skew = autotune.measure(graph).degree_skew
            sell_sigma = table_choices(table, "sell", geom).get(
                "sigma", SellFormat.DEFAULT_SIGMA)
            for fmt_name in ("csr", "sell"):
                fmt = (as_format(graph) if fmt_name == "csr"
                       else SellFormat.from_csr(graph))
                if fmt_name == "sell":
                    assert fmt.sigma == sell_sigma, (fmt.sigma, sell_sigma)
                # b. the all-auto spec resolves to the table's rows
                clear_degrade_log()
                ct = bfs.plan(fmt, bfs.TraversalSpec(), device=dev)
                r = ct.resolved
                want = expected_spec(table_choices(table, fmt_name, geom),
                                     fmt, skew)
                got = {k: getattr(r, k) for k in want}
                got["policy"] = type(r.policy)
                assert got == want, f"{label} {fmt_name}: {got} != {want}"
                assert not degrade_log(), degrade_log()
                # c. the resolved plan against fused_gather at depth 0
                base_ct = bfs.plan(fmt, r.replace(pipeline="fused_gather",
                                                  prefetch_depth=0),
                                   device=dev)
                res = ct.run_batched(rts)
                base = base_ct.run_batched(rts)
                # a scalar CSR layer of K6 reports its planned blocks in
                # column 5, fused_gather the full stream's (as in
                # tests/test_torch_traversal_union.py)
                tiles_rows = (base.stats[:, 3] != MODE_SCALAR) \
                    | (fmt_name != "csr" or r.pipeline != "persistent")
                for what, a, b in (
                        ("visited", res.state.visited, base.state.visited),
                        ("depths", res.depths, base.depths),
                        ("stats columns 0-4 and 6",
                         res.stats[:, [0, 1, 2, 3, 4, 6]],
                         base.stats[:, [0, 1, 2, 3, 4, 6]]),
                        ("stats column 5", res.stats[tiles_rows, 5],
                         base.stats[tiles_rows, 5])):
                    assert torch.equal(a, b), \
                        f"{label} {fmt_name} {r.pipeline}: {what} differ " \
                        f"from fused_gather at depth 0"
                assert bfs.direction_log(res) == bfs.direction_log(base)
                trees_ok(graph, res, rts, orc, r.max_layers)
                assert not degrade_log(), degrade_log()
                # d. the kernels it launched, and the walls
                kernels = device_kernels(lambda: ct.run_batched(rts))
                need = PIPELINE_KERNELS[(fmt_name, r.pipeline)]
                others = {k for (f, p), ks in PIPELINE_KERNELS.items()
                          if p != r.pipeline for k in ks[:1]}
                launched = sorted(k for k in set(need) | others
                                  if has_kernel(kernels, k))
                assert set(need) <= set(launched) \
                    and not others & set(launched), \
                    f"{label} {fmt_name} {r.pipeline}: launched {launched}"
                times = {"resolved": [], "fused_gather_d0": []}
                for which in ("fused_gather_d0", "resolved", "resolved",
                              "fused_gather_d0"):
                    c = ct if which == "resolved" else base_ct
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    c.run_batched(rts)
                    torch.cuda.synchronize()
                    times[which].append(time.perf_counter() - t1)
                wall = {k: float(np.mean(v)) * 1e3 for k, v in times.items()}
                walls.append(dict(
                    graph=label, format=fmt_name, geometry=geom,
                    pipeline=r.pipeline, prefetch_depth=r.prefetch_depth,
                    tile=r.tile, sigma=getattr(fmt, "sigma", None),
                    roots=len(rts), layers=int(res.state.layer),
                    kernels=launched, ms=wall["resolved"],
                    fused_gather_d0_ms=wall["fused_gather_d0"], card=smi))
                log(f"affinity {label} {fmt_name} ({geom}): resolves to "
                    f"{r.pipeline}, depth {r.prefetch_depth}, tile "
                    f"{r.tile}" + (f", sigma {fmt.sigma}"
                                   if fmt_name == "sell" else "")
                    + f" = the table's rows; equals fused_gather at depth "
                    f"0 (visited, depths, direction log, stats 0-4 and 6, "
                    f"5 on {int((tiles_rows & (base.stats[:, 4] != 0)).sum())}"
                    f" of {int(base.state.layer)} layers), trees valid, "
                    f"no degrade; launched {launched}")
                del ct, base_ct, res, base, fmt
                bfs.clear_plan_cache()
    affinity.clear_cache()
    for w in walls:
        log(json.dumps({"affinity_wall": w}))
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")


def phase_affinity_alone(seed: int = 0) -> None:
    """Phase 18 by itself: the main path's graph and phase 2's roots
    made anew, their depths from the level-synchronous oracle."""
    import torch
    g = make_graph(MAIN.scale, seed, "cuda")
    roots = pick_roots(g, BATCH, seed)
    src = torch.repeat_interleave(
        torch.arange(g.n_vertices, device="cuda"), g.degrees().long(),
        output_size=g.n_edges)
    dst = g.rows[:g.n_edges].long()
    depths = {r: level_bfs_depths(src, dst, g.n_vertices, r)
              for r in roots}
    del src, dst
    phase_affinity(g, roots, depths.__getitem__, seed, card_line())


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def make_graph(scale: int, seed: int, device: str):
    """The R-MAT graph of `GRAPHS` at ``scale`` (its edgefactor)."""
    from repro_torch.core import csr as csr_mod
    from repro_torch.core import rmat
    edges = rmat.generate(seed, scale, GRAPHS[f"rmat-{scale}"].edgefactor,
                          device=device)
    g = csr_mod.from_edges(edges, device=device)
    del edges
    return g


def torus_graph(side: int, device: str):
    """The reference sweep's uniform 4-regular 2-D torus, ``side`` x
    ``side`` vertices, symmetrized (the ``skew1`` geometry class)."""
    import torch
    from repro_torch.core import csr as csr_mod
    from repro_torch.core.rmat import EdgeList
    v = side * side
    idx = torch.arange(v, dtype=torch.int32, device=device)
    x, y = idx % side, idx // side
    right = (x + 1) % side + y * side
    down = x + (y + 1) % side * side
    src = torch.cat([idx, idx])
    dst = torch.cat([right, down])
    return csr_mod.from_edges(EdgeList(torch.cat([src, dst]),
                                       torch.cat([dst, src]), v),
                              device=device)


def pick_roots(g, n: int, seed: int):
    import torch
    deg = g.degrees().cpu()
    cands = torch.nonzero(deg > 0).flatten()
    gen = torch.Generator().manual_seed(seed)
    pick = torch.randperm(cands.numel(), generator=gen)[:n]
    return cands[pick].tolist()


def trees_ok(g, res, roots, oracle, max_layers: int | None = None):
    """Each root's tree is valid with the oracle's depths, and its layer
    count is the tree's depth + 1, or ``max_layers`` where the search
    reached its last vertices in its last allowed layer (the torus of
    phase 18: eccentricity 64 = the default 64 layers)."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.core.validate import validate
    parents = bfs.parents_graph500(res.state, g.n_vertices)
    for b, r in enumerate(roots):
        v = validate(g, parents[b], r, reference_depth=oracle(r))
        assert v.ok, f"root {r}: tree invalid {v[:7]}"
        want = int(v.depth.max()) + 1
        if max_layers is not None:
            want = min(want, max_layers)
        assert int(res.depths[b]) == want, \
            f"root {r}: engine depth {int(res.depths[b])} vs tree"
    return parents


def launch_column(per_layer: int, n_layers: int) -> list:
    """The stats launches column of a path: ``per_layer`` wrapper calls
    per layer, or 0 for one launch per traversal (charged to layer 0)."""
    if per_layer == 0:
        return [1] + [0] * (n_layers - 1)
    return [per_layer] * n_layers


def run_path(graph, g, roots, name: str, fields: dict, kernels, per_layer,
             base, oracle, edges: int, stat_cols):
    """Phases 5, 5b and 10: one path of ``graph`` (the main path's CSR ``g``
    or a SELL layout of it) at the main path's size, counted, timed over
    3 runs and held to the main path's result: visited, frontier,
    depths, layers, the stats columns ``stat_cols`` and the direction
    log; the launches column per `launch_column`; no degrade; each of
    ``kernels`` launched."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.obs.metrics import clear_degrade_log, degrade_log
    from repro_torch.kernels import ops
    ct = bfs.plan(graph, bfs.TraversalSpec(**fields))
    assert isinstance(ct.resolved.policy, bfs.BeamerHybrid), ct.resolved
    ct.run_batched(roots)                           # warm-up
    torch.cuda.synchronize()
    clear_degrade_log()
    ops.reset_kernel_launches()
    times = []
    with CallCount(PLAIN_COUNTERS) as plain:
        for _ in range(3):
            t0 = time.perf_counter()
            res = ct.run_batched(roots)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if len(times) == 1:
                launches = dict(ops.KERNEL_LAUNCHES)
    assert not degrade_log(), f"{name}: degraded: {degrade_log()}"
    assert not any(plain.counts.values()), \
        f"{name}: plain counters or apportionment ran: {plain.counts}"
    for kernel in kernels:
        assert launches[kernel] > 0, f"{name}: {kernel} was never launched"
    n_layers = int(base.state.layer)
    modes = base.stats[:n_layers, 3]
    assert bool((modes != 0).all()), "BeamerHybrid ran a scalar layer"
    cols = list(stat_cols)
    for what, a, b in (("visited", res.state.visited, base.state.visited),
                       ("frontier", res.state.frontier, base.state.frontier),
                       ("depths", res.depths, base.depths),
                       (f"stats columns {cols}", res.stats[:, cols],
                        base.stats[:, cols])):
        assert torch.equal(a, b), f"{name}: {what} differ from the main path"
    assert int(res.state.layer) == n_layers
    assert bfs.direction_log(res) == bfs.direction_log(base)
    col = res.stats[:n_layers, 7].tolist()
    want = launch_column(per_layer, n_layers)
    assert col == want, f"{name}: launches column {col}, expected {want}"
    trees_ok(g, res, roots, oracle)
    log(f"path {name}: {len(roots)} roots, {n_layers} layers, "
        f"{edges} traversed edges, runs {[round(t, 6) for t in times]} s "
        f"-> {edges / times[0]:.6e} TEPS (first run); launches "
        f"{ {k: launches[k] for k in kernels} }; trees valid, "
        f"visited/depths/stats {cols}/direction log equal the main path; "
        f"no degrade; no plain counters or apportionment")
    return ct, launches, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=MAIN.scale,
                    help="R-MAT scale of the main path (22, from "
                         "configs.bfs_graph500; 20 is the only allowed "
                         "cut)")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed repetitions per kernel")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one main-path run with "
                         "torch.profiler and print device time by kernel "
                         "and its split into planning and counters")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.formats import affinity
    # phases 1-17 hold every auto knob at its built-in default; phase 18
    # reads the committed table
    with affinity.table_at(None):
        return run_phases(args)


def run_phases(args) -> int:
    """Every phase, in order (see the module docstring)."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.obs.metrics import clear_degrade_log, degrade_log
    from repro_torch.core import bfs_serial
    from repro_torch.core.csr import traversed_edges
    from repro_torch.kernels import _build, ops

    # 1. device
    smi = card_line()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} x{torch.cuda.device_count()}")
    if args.scale != MAIN.scale:
        log(f"CUT: main path at SCALE {args.scale} instead of "
            f"{MAIN.scale}")

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.3f} s")
    for entry in _build.BUILD_LOG:
        full = entry.startswith(UNION_SOURCES)
        for line in entry.splitlines():
            if line.startswith("==") or "registers" in line \
                    or "spill" in line or (full and "ptxas" in line):
                log("  " + line.strip())
    sass = barrier_sass()

    # main-path graph and a capture run (warm-up) for phase 3
    t0 = time.perf_counter()
    g = make_graph(args.scale, args.seed, "cuda")
    torch.cuda.synchronize()
    log(f"graph: SCALE {args.scale} V={g.n_vertices} E={g.n_edges} "
        f"(generated + CSR in {time.perf_counter() - t0:.3f} s)")
    ct = bfs.plan(g, bfs.TraversalSpec(**BUILTIN_KNOBS,
                                       tile=BUILTIN_CSR_TILE))
    r = ct.resolved
    log(f"resolved spec: {r}")
    assert isinstance(r.policy, bfs.BeamerHybrid), r.policy
    assert r.pipeline == "fused_gather" and r.packed \
        and r.prefetch_depth == 0, r
    roots = pick_roots(g, BATCH, args.seed)
    log(f"roots: {roots}")
    dirs = direction_spies(ops, "gather_expand_batched")
    with plan_layers_spy(ops) as plan_layers, \
            Spy(ops, {"plan_union": None,
                      "gather_expand_batched": listed}) as spy, \
            MeasureCapture(ops) as measured, \
            contextlib.ExitStack() as stack:
        for d in dirs.values():
            stack.enter_context(d)
        ct.run_batched(roots)
    cap = spy.best["gather_expand_batched"]
    torch.cuda.synchronize()
    # 3a. the measure kernel on every layer of the main path
    measure_gates(measured.calls, "")
    kres = {"measure": measure_row(measured.calls, args.reps)}
    measure_wide_row(measured.calls[0]["deg"], g.n_vertices_padded // 32,
                     args.seed, args.reps)
    del measured

    # 3. kernels vs plain versions (the planner on every layer); 3b K4;
    # 3c K5 and 3d K9 (both directions, depths 0 and 2);
    # the planner, K2 and K3 at B = 1
    plan_gates(plan_layers.calls, {"csr": None})
    kres.update(phase_kernels(cap, g.n_vertices, g.n_vertices_padded,
                              args.reps))
    kres["gather_expand_prefetch"] = phase_prefetch(
        cap, args.reps, kres["gather_expand_batched"])
    kres["layer_fused_batched"] = layer_kernel_both_ways(
        "csr", cap, dirs, args.reps)
    del cap, spy, dirs
    kres["sell_layer_fused_batched"] = phase_sell_layer(g, roots, args.reps)
    bfs.clear_plan_cache()
    torch.cuda.empty_cache()
    with Spy(ops, {"plan_union": None,
                   "gather_expand_batched": listed}) as cap1:
        ct.run(roots[0])
    torch.cuda.synchronize()
    phase_kernels(cap1.best["gather_expand_batched"], g.n_vertices,
                  g.n_vertices_padded,
                  max(5, args.reps // 4), label="_b1")
    del cap1
    torch.cuda.empty_cache()

    # 4. main path (the counted run)
    ops.reset_kernel_launches()
    torch.cuda.synchronize()
    with CallCount(PLAIN_PLANNING) as plain, \
            CallCount(PLAIN_COUNTERS) as plain_counters:
        t0 = time.perf_counter()
        res = ct.run_batched(roots)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = dict(ops.KERNEL_LAUNCHES)
    n_layers = int(res.state.layer)
    assert launches["plan_union"] == launches["gather_expand_batched"] \
        == n_layers and launches["frontier_compact_batched"] == 0 \
        and not any(plain.counts.values()), (launches, plain.counts)
    log(f"main path planning: {n_layers} plan_union launches for "
        f"{n_layers} layers; no frontier_compact_batched launch, no call "
        f"of {', '.join(sorted(plain.counts))}")
    assert launches["measure"] == n_layers + 1 \
        and launches["popcount"] == 0 \
        and not any(plain_counters.counts.values()), \
        (launches, plain_counters.counts)
    log(f"main path counters: {launches['measure']} measure launches for "
        f"{n_layers} layers (the last finds every frontier empty); no call "
        f"of {', '.join(sorted(plain_counters.counts))}")
    same_as_parent_planning(ct, roots, res)
    more = []
    for _ in range(2):
        t1 = time.perf_counter()
        ct.run_batched(roots)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t1)
    for s in bfs.layer_stats(res):
        log(f"  {s}")
    log(f"direction_log: {bfs.direction_log(res)}")
    src = torch.repeat_interleave(
        torch.arange(g.n_vertices, device="cuda"), g.degrees().long(),
        output_size=g.n_edges)
    dst = g.rows[:g.n_edges].long()
    oracle_depths = {r: level_bfs_depths(src, dst, g.n_vertices, r)
                     for r in roots}
    parents = trees_ok(g, res, roots, oracle_depths.__getitem__)
    del src, dst
    edges = sum(int(traversed_edges(g, parents[b] >= 0))
                for b in range(len(roots)))
    log(f"main path: {len(roots)} roots, {edges} traversed edges, "
        f"{elapsed:.6f} s -> {edges / elapsed:.6e} TEPS "
        f"(repeat runs {[round(x, 6) for x in more]} s); trees valid, "
        f"depths equal the level-synchronous oracle")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if args.profile:
        profile_run(ct, roots)
    split = planning_split(ct, roots, required=args.profile)
    if split is not None:
        assert split["counters"] == 0, \
            f"plain counter kernels ran: {split['counters']} ms"
        log(f"main path counters: {split['measure (K13)']:.6f} ms of device "
            f"time in the measure kernel, none in plain-torch counters")

    # 5. the fusion paths at the main path's size
    path_launches = {}
    csr_per_layer = {"fused_gather_d2": 3, "persistent": 0}
    for name in PATHS:
        fields, kernel = PATHS[name]
        ct_path, launched, _ = run_path(
            g, g, roots, name, fields, (kernel,),
            csr_per_layer.get(name, 1), res, oracle_depths.__getitem__,
            edges, range(7))
        path_launches[kernel] = launched[kernel]
        if name == "megakernel":
            kernels = profile_run(ct_path, roots, "megakernel", top=8)
            n_layers = int(res.state.layer)
            assert launches_of(kernels, "layer_fused_kernel") == n_layers, \
                "K5 must be one CUDA launch per layer"
            log(f"megakernel: {n_layers} K5 launches for {n_layers} layers")
            with layer_spy(ops, "layer_fused_batched") as fused_layers:
                ct_path.run_batched(roots)
        if name == "persistent":
            kernels = profile_run(ct_path, roots, "persistent", top=8)
            assert launches_of(kernels, "traversal_fused_kernel") == 1, \
                "K6 must be one CUDA launch per traversal"
            log(f"persistent: 1 K6 launch per traversal; "
                f"{sum(kernels.values()) - 1} other device events "
                f"(initial state)")
            kres["traversal_fused_batched"] = phase_traversal_kernel(
                "csr", ct_path, roots, fused_layers.calls, 5)
        del ct_path
    del fused_layers
    launches.update(path_launches)

    # 5a. K6's bottom-up walk on hub lists that span rows-blocks
    phase_bottom_up_walk(args.seed)

    # 5b. SELL-C-σ at the main path's size
    sell_kres, sell_launches = phase_sell(g, roots, res,
                                          oracle_depths.__getitem__, edges,
                                          args.reps, plan_layers.calls,
                                          args.profile)
    del plan_layers
    kres.update(sell_kres)
    for name, n in sell_launches.items():
        if not launches.get(name):
            launches[name] = n

    # 9. the semiring portfolio at the main path's size
    port_kres, port_launches, sell_plan, portfolio = phase_portfolio(
        g, roots, oracle_depths.__getitem__, args.reps)
    kres.update(port_kres)
    kres["plan_union"]["sell"] = {k: sell_plan[k] for k in (
        "ms", "plain_ms", "replaced_ms", "bytes", "bound_ms")}
    launches.update(port_launches)

    # 10. the materialized pipeline at the main path's size
    mat_kres, mat_launches = phase_materialized(
        g, roots, res, oracle_depths.__getitem__, edges, args.reps,
        args.seed)
    kres.update(mat_kres)
    launches.update(mat_launches)

    # 11. rule 3: packed=False, layer_step, the legacy entry points and
    # the two repairs
    dense_launches = phase_dense(g, roots, res, oracle_depths.__getitem__,
                                 edges, args.profile)
    log(json.dumps({"dense_launches": dense_launches}))
    simd_stats = phase_ticks(g, roots, oracle_depths.__getitem__)
    phase_legacy(g, roots[0], oracle_depths.__getitem__)
    phase_repairs(args.seed, "cuda")

    # 12. the Graph500 harness, the query service and trace_run
    oracle, free_oracle = oracle_of(g, oracle_depths)
    roots64 = phase_harness(g, ct, oracle, args.seed)
    phase_serve(g, roots64, oracle, portfolio, roots)
    free_oracle()
    phase_trace(ct, roots, simd_stats)

    # 18. the affinity table: the all-auto spec on the main path's graph
    # and on the torus resolves to the committed rows and equals the
    # fused_gather depth-0 path
    phase_affinity(g, roots, oracle_depths.__getitem__, args.seed, smi)

    # 13. the distributed BFS: one rank over NCCL, the rowsweep kernel on
    # every shard at D = 1, 2, 4, two ranks on the card over gloo
    del ct
    bfs.clear_plan_cache()
    torch.cuda.empty_cache()
    kres["rowsweep"], dist_launches = phase_distributed(
        g, roots, oracle, args.seed, args.reps)
    launches["rowsweep"] = dist_launches["rowsweep"]
    del res, parents, g, oracle_depths, oracle, portfolio
    bfs.clear_plan_cache()
    torch.cuda.empty_cache()

    # 6. four policies at SCALE 16, every pipeline of CSR and SELL
    from repro_torch import formats
    g16 = make_graph(16, args.seed, "cuda")
    sell16 = formats.build(g16, "auto")
    assert isinstance(sell16, formats.SellFormat), type(sell16)
    roots16 = pick_roots(g16, BATCH, args.seed + 1)
    rows_np = g16.rows.cpu().numpy()
    cs_np = g16.colstarts.cpu().numpy()
    ref_depth = {}

    def serial(root):
        if root not in ref_depth:
            ref_depth[root] = bfs_serial.bfs_serial(
                rows_np, cs_np, g16.n_vertices, root)[1]
        return ref_depth[root] if root == roots16[0] else None

    for pol in (bfs.TopDown(), bfs.ThresholdSimd(), bfs.PaperLiteralLayers(),
                bfs.BeamerHybrid()):
        base16 = bfs.plan(g16, bfs.TraversalSpec(policy=pol)) \
            .run_batched(roots16)
        trees_ok(g16, base16, roots16, serial)
        clear_degrade_log()
        runs = [(g16, fields) for fields, _ in PATHS.values()]
        runs += [(sell16, fields) for fields, _, _ in SELL_PATHS.values()]
        runs += [(gr, dict(pipeline="materialized")) for gr in (g16, sell16)]
        for graph, fields in runs:
            res = bfs.plan(graph, bfs.TraversalSpec(policy=pol, **fields)) \
                .run_batched(roots16)
            trees_ok(g16, res, roots16, serial)
            for what, a, b in (
                    ("visited", res.state.visited, base16.state.visited),
                    ("depths", res.depths, base16.depths),
                    ("stats columns 0-4", res.stats[:, :5],
                     base16.stats[:, :5])):
                assert torch.equal(a, b), \
                    f"{type(pol).__name__} {type(graph).__name__} " \
                    f"{fields}: {what} differ"
            assert bfs.direction_log(res) == bfs.direction_log(base16)
        assert not degrade_log(), degrade_log()
        log(f"policy {type(pol).__name__} @ SCALE 16: trees valid, root 0 "
            f"depths equal bfs_serial, every CSR and SELL pipeline equals "
            f"fused_gather; {bfs.direction_log(base16)}")
    # 6b. two root-mask words: the planner, K3, K4, K5, K9, K11 and K12
    # at B = 33
    phase_wide_batch(g16, sell16, args.seed, max(3, args.reps // 4))
    del g16, sell16
    bfs.clear_plan_cache()

    # 7. GPU vs the port's CPU path at SCALE 12
    g12 = make_graph(12, args.seed, "cuda")
    roots12 = pick_roots(g12, BATCH, args.seed + 2)
    g12_cpu = type(g12)(g12.rows.cpu(), g12.colstarts.cpu(),
                        g12.n_vertices, g12.n_edges)
    sell12 = formats.SellFormat.from_csr(g12)
    sell12_cpu = formats.SellFormat.from_csr(g12_cpu)
    for name in ("cols", "slab_rows", "deg"):
        assert torch.equal(getattr(sell12, name).cpu(),
                           getattr(sell12_cpu, name)), \
            f"the SELL layout built on the card differs in {name}"
    log(f"sell layout @ SCALE 12: the card's build equals the CPU build "
        f"({sell12.n_slabs} slabs)")
    for pol in (bfs.TopDown(), bfs.ThresholdSimd(2048),
                bfs.PaperLiteralLayers(), bfs.BeamerHybrid()):
        for layout, (gg, gc) in (("csr", (g12, g12_cpu)),
                                 ("sell", (sell12, sell12_cpu))):
            for pipeline in ("fused_gather", "megakernel", "persistent",
                             "materialized"):
                spec = bfs.TraversalSpec(policy=pol, pipeline=pipeline)
                a = bfs.plan(gg, spec).run_batched(roots12)
                c = bfs.plan(gc, spec, device="cpu").run_batched(roots12)
                for name, x, y in (("visited", a.state.visited,
                                    c.state.visited),
                                   ("depths", a.depths, c.depths),
                                   ("stats", a.stats, c.stats)):
                    assert torch.equal(x.cpu(), y), \
                        f"{type(pol).__name__} {layout} {pipeline}: GPU " \
                        f"and CPU {name} differ"
                assert bfs.direction_log(a) == bfs.direction_log(c)
        log(f"parity {type(pol).__name__} @ SCALE 12: GPU == CPU "
            f"(visited, depths, stats, direction_log) on fused_gather, "
            f"megakernel, persistent and materialized, for CSR and SELL")
    for alg in ("ksource_bfs", "sssp", "cc"):
        for layout, (gg, gc) in (("csr", (g12, g12_cpu)),
                                 ("sell", (sell12, sell12_cpu))):
            spec = bfs.TraversalSpec(algorithm=alg, max_layers=512)
            a = bfs.plan(gg, spec).run_batched(roots12)
            c = bfs.plan(gc, spec, device="cpu").run_batched(roots12)
            for name, x, y in (
                    ("values", a.values.view(torch.int32),
                     c.values.view(torch.int32)),
                    ("parents", a.state.parent, c.state.parent),
                    ("depths", a.depths, c.depths),
                    ("stats", a.stats, c.stats)):
                assert torch.equal(x.cpu(), y), \
                    f"{alg} {layout}: GPU and CPU {name} differ"
        log(f"parity {alg} @ SCALE 12: GPU == CPU (values, parents, "
            f"depths, stats) for CSR and SELL")

    # 14. the LM serve path: every reduced arch GPU == CPU, qwen3-14b
    # served at full width, decode == forward at its widths
    phase_lm(args.seed)

    # 15. the LM training path: every reduced arch's step GPU == CPU,
    # h2o-danube-1.8b trained at full width, the fault-tolerant loop
    phase_train(args.seed)

    # 16. the sharding and launch slice: the reference's mesh contracts
    # with 8 ranks on the card, h2o-danube-1.8b on a (2 x 2) mesh
    phase_mesh(args.seed, smi)

    # 17. the roofline and the dry run: the analyzer on the card against
    # meta tensors, the dry run's cells, measure_drift (on the main
    # path's graph, made again: phase 14 freed it), the 8-bit arm on a
    # mesh
    phase_roofline(args.seed, smi)

    # 8. launch counts of the paths' runs
    log("launch counts (main path, fusion and SELL paths): " + ", ".join(
        f"{k}={v}" for k, v in launches.items()))
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    for kernel in ("traversal_fused_kernel", "sell_traversal_fused_kernel"):
        assert sass[kernel]["CCTL.IVALL"] > 0, \
            f"{kernel}: no L1 invalidation in its SASS, but its walk reads " \
            f"state rewritten between layers by plain loads"
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    assert not leaked, f"imported the JAX package: {leaked[:5]}"

    rows = []
    for name in SOURCES:
        k = kres[name]
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by="bytes",
            # no kernel has one PyTorch call computing its function; the
            # K11/K12 phase-0 fold is printed on their own lines
            library_ms=None, method=k.get("method", EVENTS),
            **{key: k[key] for key in ("union_blocks", "timing",
                                        "replaced_ms", "sell", "event_ms")
               if key in k}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
