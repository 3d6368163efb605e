#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``lapgnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]
                          [--phases build,compare,device,times,stream,train,eval,dual_train,front_ends,parallel,parallel_train,dual_edge,graph_features,predict_graph]

``--phases`` runs a subset (for a first look at a changed kernel,
``build,device`` after a change to the device solver or its kernels S1-S3,
``build,stream`` after a change to the transfer layer, ``build,train`` after
one to the training path, ``build,eval`` after one to the evaluation path,
``build,dual_train`` after one to DualGNN training, ``build,front_ends``
after one to the solver front ends or the benchmark CLIs, ``build,parallel``
after one to the parallel package's serving, ``build,parallel_train`` after
one to its training, ``build,dual_edge`` after one to the DualGNN edge
kernel, ``build,graph_features`` after one to DualGNN's graph-feature
kernels, ``build,predict_graph`` after one to the predict's CUDA graphs)
and then prints no ``ok`` line; with no arguments every phase runs.

Phases; any failure exits non-zero without the final ``ok`` line:
  1. Device and build: the card's name and power limit, then every kernel
     (one ``nvcc`` per ``csrc/*.cu``) and the native host solver (``g++``),
     built together from the checkout into ``build/``; each kernel's
     registers, shared memory and spills (a spill fails the phase), S1's,
     S2's and S3's static shared memory against what their layouts' limits
     assume (more fails it), and how many of K1 / K2's thread block clusters the
     card holds at once (none fails it).
  2. Kernels against their plain PyTorch versions at n = 1000, 2048 and 8192
     on a (uniform, tie) batch of two: K1 column min, K2 min-trick and K4
     two-min must match bit for bit (K4 also on rows with +-inf and NaN; K1
     and K2 on every path and geometry they can take, also on columns with
     NaN, +-inf, equal values, a NaN in u, and mixed +-0.0, where the sign of
     a zero minimum is free and the values must compare equal; again at
     ragged and rectangular shapes down to one row or one column, batches of
     2 and 5, and a batch whose offsets pass 2^31),
     K3 row-feature statistics within rtol 2e-5 / atol 2e-6 with its
     selection channels (min, max, MAD, second-best gap, near-best,
     is-col-best) bit-equal, also on all-equal rows, rows of mixed +-0.0 and
     rows with +-inf.  K3 and K4 again at the ragged shapes their tiling
     must survive: m in {1, 7, 10, 11, 33, 1001}, m = 16384 (eight warps a
     row), m = 20000 (K3's shared-memory path), and a view that starts 4
     bytes into its buffer.  A row of 60,000 columns, past K3's limit on
     the card, goes to the sort-based row features (held to them within
     K3's tolerance, K3 not launched).  The training loss's greedy bound
     kernel bit for bit against its plain loop and against the CPU, at n in
     {1, 7, 512, 1024, 2048, 4097} on tie-heavy rows, a row of +inf, rows
     with +inf tails, a row with a NaN, with and without a row mask.  The
     seed policy's Sinkhorn ladder kernel against the eager loop on the
     same card at n = 2048 and 8192 (resident and streamed layouts) and on
     the unaligned view: within ``ops/cuda/sinkhorn.py``'s tolerance, the
     projected pair exactly feasible.
  3. Hybrid end to end: ``WarmStartPipeline(mode="hybrid", seed_mode="auto",
     normalize_costs=True)`` with ``artifacts/one_gnn_default`` (OneGNN,
     hidden 192, 4 layers, top-k 16) solves one instance of each of four
     families at n = 2048 with ``certify=True``; each optimal cost must equal
     SciPy's (float64, 1e-12 relative) and the launch counters, zeroed just
     before, must show K3 and K1 at least once and K2 at least twice per
     instance.  Then the predict's stages and the device's busy share.
  4. Device end to end: the default ``WarmStartPipeline(mode="device", ...)``
     solves the same four families at n = 2048 in float32 on the card and
     certifies each against the float64 matrix on the host; each cost must
     equal SciPy's (1e-12 relative), be certified and not routed to the host;
     the solve must read nothing back on the host (``host_syncs`` 0 in
     every solve), S1, S2 and S3 must each launch in every instance besides
     K1-K3 and the Sinkhorn ladder, and one uncertified ``solve`` must make exactly one
     device-to-host copy (torch.profiler).  Per instance: the certificate's
     route (raw, repair or polish), predict, device-solve and certify times,
     and the solver's loop counts.
  5. The port's device solver from the same matrix and seeds four ways: on
     the card through S1-S3 (S1 in its default layout: resident at n = 512
     and 2048 in float32 and at 1024 in float64; S2 resident), again with S1
     forced to its staged layout, at n = 2048 once more with S2 forced to
     its global layout, on the card through their plain versions (the
     eager loops), and on the CPU (a spawned pool that starts first), at
     n = 512 and 2048 on the four families and on uniform with a NaN row
     and with an all-+inf row (float32, min-trick seeds), on uniform and tie
     in float64 (n = 1024, and uniform at 2048) and on uniform seeded by the
     pipeline's predicted duals: x, y and v bit for bit (every NaN one
     class), the fallback flag and every loop count equal.  Meanwhile S1's
     unstaged layout (its row vectors read through L2) against its plain
     loop: forced at n = 2048, and in float64 at n = 12288, past what the
     staged one holds, where S2 runs in each of its layouts against its
     plain loop too.
  6. Where one device solve's time goes (uniform): its stages by CUDA
     events, and the device's idle share and S1-S3's device times under
     torch.profiler.
  7. Stream: ``solve_stream(certify=True)`` in the postures of the JAX
     package's bench (``STREAM_POSTURES``: float32, topk16, bfloat16, float16
     and uint16 at n = 2048, with a noisy_linear instance for topk16 and a
     sparse one for uint16; topk16 with ``microbatch=8`` at n = 512 and
     1024), each timed as one stream and then as serial ``solve`` calls:
     every instance certified and equal to SciPy's optimum (1e-12 relative)
     and to its per-call result, K1-K3 and S1-S3 launched in the stream; per posture
     the payload's bytes, host pack, upload (copy stream) and decode times.
     Then the card's decode against the CPU's, bit for bit, at n = 2048 and
     8193 (past the ramp fill's gate).
  8. Train: ``train_progressive`` with ``artifacts/one_gnn_default``'s own
     config (hidden 192, 4 layers, top-k 16, cost refinement, normalised
     costs and gap), warm-started from its weights (every leaf restored),
     one epoch over labelled synthetic instances from ``--seed`` (n = 512:
     32 train + 8 val; n = 1024: 8; n = 2048: 2; labelled by SciPy in a
     process pool while the compare phase runs): every step's loss finite, the parameters moved, ``best/``
     and ``last/`` written, the greedy kernel launched once a train step and
     once a validation batch.  ``last/`` then serves one uniform n = 2048
     instance in the default device mode to a certified optimum equal to
     SciPy's (1e-12 relative).  One step at n = 512, B = 4, dropout 0 on the
     card against the CPU: loss within 1e-5 relative, each gradient within
     1e-4 max|g| + 1e-7, greedy bound bit-equal.  Then ms a step at (B, n) =
     (32, 512), (32, 1024), (16, 2048), each step cut at its stages (features,
     forward, loss with the greedy kernel, backward, optimizer) by CUDA
     events recorded around the functions the real step calls, the peak
     memory at (16, 2048), and, on the arguments the real step hands it at
     each of those shapes, the greedy kernel bit for bit against its plain
     loop, with both times, the loop's launches and the kernel's bound.
  9. Eval: the accuracy ladder (``cli.accuracy_ladder.ladder``, one
     ``evaluation.evaluate_pipeline`` a family and model) of OneGNN
     (``artifacts/one_gnn_default``, hybrid mode) against DualGNN
     (``artifacts/dual_gnn_r5``: hidden 256, 6 layers, 4 heads, its full
     width, through ``DualGNNPredictor``), both ``seed_mode="auto"``, on 4
     labelled instances of each of the 8 families at n = 512 (labelled in
     the train phase's pool while ``compare`` runs): a JSON line a (model,
     family) with the published r5 gap beside it, every metric finite,
     every instance feasible and assisted, the launch counters, zeroed just
     before, showing K1, K2, K3, the greedy kernel and the Sinkhorn ladder,
     and each of those kernels' calls there held against its plain version
     on the arguments the path gave it (K1, K2 and the greedy bound bit for
     bit, K3 within rtol 2e-5 / atol 2e-6 with its selection channels
     bit-equal, the ladder within its tolerance and exactly feasible).  The
     timing branch (``time_solvers=True``) on 2 uniform instances;
     ``graph_features`` and
     the r5 forward on the card against the port on the CPU at n = 512
     (rank, gap and tie channels bit-equal; u and v_hint within
     1e-4·max(1, max|u|)); ``graph_features`` and forward ms at n = 512 and
     2048 beside the forward's bound, and the peak memory of the forward.
     At most 60 s.
 10. Dual train: ``train_dual_gnn`` at dual_gnn_r5's full width and
     schedule (hidden 256, 6 layers, 4 heads, dropout 0.1, lr 1e-3, batch 4,
     the clipped, normalised and supervised loss), warm-started from r5's
     weights (every leaf restored), one epoch over the train phase's n = 512
     records (8 steps, 2 validation batches): every loss finite, the
     parameters moved, the validation gap median finite, the greedy kernel
     launched 10 times and each call bit-equal to its plain loop on its own
     arguments.  The trained tree saved with the CLI's meta, rebuilt from it
     and served on one n = 512 instance through ``DualGNNPredictor`` and
     ``evaluate_pipeline``: feasible and assisted.  One step at (B, n) =
     (2, 64), dropout 0, from r5's weights on the card against the CPU: loss
     within 1e-5 relative, each gradient within 1e-4 max|g| + 1e-7, greedy
     bound bit-equal.  Then ms a step at (4, 512) and (2, 1024) (host clock),
     its stages by CUDA events (graph features, forward, loss with the
     greedy kernel, backward, optimizer), its peak memory, its bound
     (3 x the forward's matrix FLOPs over the float32 rate), TFLOP/s and the
     device's idle share over one step (torch.profiler); the greedy kernel
     timed beside its plain loop on the first step's arguments.  At most
     60 s.
 11. Front ends: the benchmark and profiling CLIs in process on
     ``artifacts/one_gnn_default`` at its full width (``cli.benchmark``
     device mode at n = 2048 on uniform and sparse, ``cli.profile_pipeline``
     at 2048, ``cli.benchmark_by_type`` at 512, ``cli.comprehensive_benchmark``
     at 512 and 1024, ``cli.large_scale_benchmark`` device mode at 4096,
     ``cli.main_benchmark --quick``, ``bench.regression --device`` at 1024),
     every assignment the pipeline returned there equal in float64 to
     SciPy's optimum (1e-12 relative); ``TorchSolver`` and
     ``SeededTorchSolver`` in float32 at n = 2048 (within n 2^-23 max|C| of
     the optimum), ``verify_solver_correctness`` with all seven solver
     classes at n = 1024 on uniform and sparse, ``LAPMODSolver`` on sparse at
     2048 and the route that answered; K1-K3 and S1-S3 launched (the solver
     classes' solves run S1-S3 in float32 and float64), each K1-K3 call
     held against its plain version as in the eval phase.  At most 60 s.
 12. Parallel: row-sharded serving at one_gnn_default's full width, n = 2048.
     World 1 under NCCL (a TCP store on 127.0.0.1), on uniform and sparse:
     ``make_sharded_pipeline`` equal in assignment and cost to the same
     steps unsharded on the card and optimal against SciPy's float64 optimum
     (1e-5 relative), ``make_sharded_seeded_solve`` from rank-1 seeds
     bit-equal to ``lapjv_seeded_single``.  Two gloo ranks spawned on the one
     card: the sharded solve on uniform bit-equal (x, y, v, cost) to the
     unsharded solve on the card, ``make_sharded_predict`` (data 1 x model 2)
     within atol 1e-5 of the same steps unsharded, ``shmap_col_min`` /
     ``shmap_min_trick`` bit-equal to K1 / K2 on the whole matrix.  Every
     K1, K2 and K4 call of both held against its plain version bit for bit
     (K4 at world 2 only: a block of several ranks keeps the eager loops),
     every rank's collective log held to ``assert_no_matrix_allgather``; the
     ms per sharded solve and each rank's largest collective.  Then
     ``cli.scaling_benchmark`` (mesh 1, n = 2048, the roofline block at 2048,
     ``--solve``; its results in the phase's JSON line, its launches apart
     from the sharded path's) and the Dijkstra
     augmenters on the card at n = 128 against the CPU.  At most 45 s.
 13. Parallel train: training under a mesh at full width.  World 1 under
     NCCL: the unsharded references (one_gnn_default's trainer step at
     (32, 512); dual_gnn_r5's step, its dense features, model, surrogate
     loss and update, at (2, 1024), with its peak memory; r5's dense forward
     and min-trick at n = 2048), then ``make_dp_train_step`` and
     ``make_sharded_dual_train_step`` on 1 x 1 meshes held to them.  Two
     gloo ranks on the one card: the DP step at data 2 x model 1 and 1 x 2,
     the dual step on 2 x 1 and 1 x 2 meshes, ``make_sharded_dual_predict``
     on 2 x 1; losses within 1e-5 relative, gradients within
     1e-4 max|g| + 1e-7, parameters within 1e-4 max|dp| + 1e-7 (entries whose
     gradient is at rounding level held to one AdamW step), the ranks'
     parameters bit-equal, u and v within 1e-5 max|ref| + 1e-6.  Every K1,
     K2 and greedy call held against its plain version; every dual step's
     collective log held to ``assert_no_edge_tensor_gather``; ms a step,
     each rank's peak memory at (2, 1024) beside the unsharded step's, the
     collectives a step and the largest.  At most 60 s.
 14. Times: each kernel and its plain version at n = 2048 and 8192 beside
     its bound (the larger of the bytes it must move over the HBM rate and
     the float32 operations over the card's float32 rate).  Median of
     CUDA-event timings, all reps queued behind a spin kernel so the host's
     launch latency stays out of the event windows, L2 flushed before each
     launch.  At n = 2048 the kernels are also timed with a loop that
     synchronises before every rep, for comparison.  K1, K2 and K4 are read
     in four states (L2 flushed by ``zero_``, flushed by a read, C left in
     L2, device time a launch under torch.profiler) beside ``torch.amin``
     over the same matrix, K1 and K2 on every path and geometry, also at
     n = 4096 and on narrow matrices; at n = 2048 a call of K1 or K2 must be
     one kernel.  S1-S3 at n = 2048 and 8192 on the arguments a seeded solve
     of a uniform matrix hands them (CUDA events, L2 flushed) beside their
     plain loops (host clock) and their bounds from this run's loop counts
     (a matrix that fits in L2 read once from device memory, the rest by
     its operations; ``_solver_bound_ms``; S1's from the rows its sweeps
     must read, counted by its plain loop run over the changed rows, and
     beside it the bound over every row of every sweep,
     ``bound_every_row_ms``).  S1 at 2048 also with its staged layout
     forced and its resident tile loaded without TMA, beside its sync
     floor: the sweeps times one grid barrier of ``csrc/grid_barrier.cuh``,
     timed alone on S1's grid (with and without the stop test's words).  S2
     and S3 at both sizes with their grids (blocks, shared memory), S2's
     layout and its other layout forced, and each one's sync floor: its
     barriers on that state times one barrier timed alone on its own grid.
     The Sinkhorn ladder kernel at both sizes (L2 flushed and left in L2)
     beside the eager loop on the card and its bound (``_sinkhorn_bound_ms``:
     every half-pass's read of the matrix from device memory); no single
     PyTorch call computes the ladder, so ``library_ms`` is null.  At 2048
     also the seed policy with the kernel and with the eager loop, and its
     pieces alone (host clock).
 15. Dual edge: DualGNN's edge MLP kernel (``ops/cuda/dual_edge.py``,
     ``csrc/dual_edge.cu``, dual_gnn_r5's first layer folded) against its
     plain version on the same card at edge counts that are no multiple of
     its tile ((B, n) = (1, 1), (1, 3), (3, 33), (1, 257), (3, 257) and the
     timed shapes), on the sparse family's -1e15 channel, on features with
     NaN and +-inf (NaN and infinities where the plain version has them) and
     on an unaligned view: within ``RTOL`` of each instance's largest term.
     dual_gnn_r5's whole inference forward on a noisy_linear instance at
     n = 2048 against its unfolded eager forward: one launch a layer, u
     within 2e-5 relative.  The serving call of the DualGNN cell
     (``WarmStartPipeline(r5, mode="device", normalize_costs=False).solve``)
     on each family at n = 2048: one launch a layer (the kernels line's
     ``launches``), the cost within 1e-5 of SciPy's.  Then the kernel at the serving cell's (1, 2048)
     and the training cell's (4, 512), L2 flushed, queued behind the spin
     kernel, beside its bound (``_dual_edge_bound_ms``), the plain version
     and the unfolded eager chain it replaces.
 16. Graph features: DualGNN's graph-feature kernels (``ops/cuda/
     graph_features.py``, ``csrc/graph_features.cu``) against
     ``graph_features_plain`` on the same card, on the uniform,
     noisy_linear, sparse and tie families, on mixed -0.0 / +0.0 and on a
     row holding NaNs, at (B, n, m) from (1, 1, 1) to (1, 2048, 2048), by
     the wrapper's ``check_against_plain``: every exact channel bit for bit
     (a zero of either sign equal, NaN for NaN), mean, std and entropy
     within its ``ULPS``, their largest ulps reported.  Their launches and the host syncs of cell D's call
     (r5's serving ``solve(C)`` at n = 2048) and of cell C's step (r5's
     train step at (4, 512)): two launches each.  Then their times at (1,
     2048) and (4, 512), L2 flushed, queued behind the spin kernel, beside
     the bound (``_graph_features_bound_ms``: C read once; with the sorts'
     compare-exchanges and the design's own traffic) and the plain version.
 17. Predict graph: cell A's predict (``artifacts/one_gnn_default``,
     normalised costs) and cell D's (``artifacts/dual_gnn_r5``, whose
     predict runs eagerly: its ``predict.graphs`` called directly) at
     (1, 2048) served eagerly and from the CUDA graphs
     ``pipeline.predict_duals_fn`` captures: the replay bit for bit against
     the eager chain on the four families; the capture's ``launch.*`` rises
     (which each replay adds again) those of an eager call, and no host
     sync; the memory the capture reserved (its graphs' pool); then each
     way's time on the host clock (each call synchronised), its CUDA-event
     time queued back to back, and its host enqueue time, in turns (eager,
     replay, replay, eager); the replay's spans' CUDA-event times, and A's
     rank-1 fit alone, captured and replayed.  Then A's predict, as served,
     at every (1, n) that the eval and front-ends phases drive
     (``PREDICT_GRAPH_SHAPES``; there its graphs are held eager, so that
     their kernel wrappers see every call): replay against eager, bit for
     bit, on the four families.

Output: a JSON line per phase, then the kernels' JSON line, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

# H100 SXM data-sheet peaks (dense, no sparsity), at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20  # an H100's L2
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12  # float64 outside the tensor cores (NVIDIA's H100 SXM data sheet)

K3_RTOL, K3_ATOL = 2e-5, 2e-6
N_E2E = 2048
FAMILIES_E2E = ("uniform", "noisy_linear", "sparse", "tie")
COMPARE_SIZES = (1000, 2048, 8192)
# The device path's certificate tolerance.  The default 1e-6 admits a
# per-row dual violation of 1e-6, a gap of up to n * 1e-6, which on the tie
# family (optimum ~1e-5, 1e-6 jitter) is larger than the optimum; at 1e-12
# only the float64 dual repair or the host polish can certify, and both are
# exact.
CERTIFY_TOL = 1e-12
# Spin before a queue of timed reps: ~25-35 ms at the H100's clocks.
SPIN_CYCLES = 50_000_000

KERNELS = {
    "col_min": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/colmin.cu",
        "replaces": "lapgnn_tpu/ops/pallas/colmin.py:75",
    },
    "min_trick": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/colmin.cu",
        "replaces": "lapgnn_tpu/ops/pallas/colmin.py:94",
    },
    "row_features_stats": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/features.cu",
        "replaces": "lapgnn_tpu/ops/pallas/features.py:193",
    },
    "two_min": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/twomin.cu",
        "replaces": "lapgnn_tpu/ops/pallas/twomin.py:40",
    },
    # no Pallas kernel: the training loss's lax.scan, which XLA compiles into
    # one device loop
    "greedy_total": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/greedy.cu",
        "replaces": "lapgnn_tpu/train/loss.py:79",
    },
    # no Pallas kernel: the device solver's lax.while_loops, which XLA runs
    # on the device
    "augment_sweep": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/augment.cu",
        "replaces": "lapgnn_tpu/solver/jv.py:533",
    },
    "arr_auction": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/arr.cu",
        "replaces": "lapgnn_tpu/solver/seeded.py:163",
    },
    "greedy_match": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/greedy_match.cu",
        "replaces": "lapgnn_tpu/solver/seeded.py:99",
    },
    # no Pallas kernel: the seed policy's Sinkhorn loop, jnp.logsumexp passes
    # that XLA fuses
    "sinkhorn_ladder": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/sinkhorn.cu",
        "replaces": "lapgnn_tpu/ops/sinkhorn.py:91",
    },
    # no Pallas kernel: DualGNN's edge MLP, an nn.Dense chain XLA compiles
    "dual_edge_terms": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/dual_edge.cu",
        "replaces": "lapgnn_tpu/models/dual_gnn.py:107",
    },
    # no Pallas kernel: DualGNN's graph features, jnp sorts XLA compiles
    "graph_features": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/graph_features.cu",
        "replaces": "lapgnn_tpu/ops/features.py:graph_features",
    },
}
SOLVER_KERNELS = ("augment_sweep", "arr_auction", "greedy_match")
# The train phase: the sizes of one_gnn_default's config.
TRAIN_SIZES = ((512, 32, 8), (1024, 8, 0), (2048, 2, 0))  # (n, train, val)
TRAIN_TIMED = ((32, 512), (32, 1024), (16, 2048))  # (B, n) of the step times
GREEDY_SIZES = (1, 7, 512, 1024, 2048, 4097)
# The eval phase: the accuracy ladder at the size dual_gnn_r5 was trained and
# evaluated at, the forward timed there and at the reference's DualGNN cap.
DUAL_CHECKPOINT = Path(__file__).resolve().parent / "artifacts" / "dual_gnn_r5"
EVAL_N = 512
EVAL_PER_FAMILY = 4
EVAL_TIMED_N = (512, 2048)
EVAL_PHASE_LIMIT_S = 60.0
# The dual_train phase: dual_gnn_r5's own schedule (docs/ACCURACY_LADDER.md:
# AdamW lr 1e-3, batch 4 at hidden 256, n = 512), one epoch over the train
# phase's n = 512 records; one step card against CPU at (2, 64); step times
# at (B, n) = (4, 512) and (2, 1024).
DUAL_TRAIN_BATCH = 4
DUAL_TRAIN_LR = 1e-3
DUAL_VS_CPU = (2, 64)
DUAL_TRAIN_TIMED = ((4, 512), (2, 1024))
DUAL_TRAIN_PHASE_LIMIT_S = 60.0
# docs/ACCURACY_LADDER.md, round 5, served posture (--seed-mode auto), the
# h=256/L=6 column (dual_gnn_r5): clipped pre-solve gap medians over 36
# instances a family at n = 512 from another seed.  Printed beside this
# run's as a sanity check, not a limit.
PUBLISHED_R5_CLIPPED_GAP_MEDIAN = {
    "block": 2.08, "clustered": 1.99, "low_rank": 0.68, "metric": 0.00,
    "noisy_linear": 5.88, "sparse": 6.09, "tie": 1.20, "uniform": 2.41,
}


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _bound_ms(name: str, B: int, n: int, m: int, itemsize: int = 4):
    """Least time for the function on these inputs: each input read once and
    each output written once over the HBM rate, against its float32
    operations over the float32 rate.  K1 does one compare per element, K2 a
    subtract and a compare.  K3's float32 work (moments, entropy) is a few
    operations per element, far below its bytes time; its exact selections
    are integer compares whose count depends on the selection algorithm and
    which the rate table does not cover, so K3 is held to the bytes bound.
    K4 reads C and v and writes min1, min2 and the int32 argmin; it does a
    subtract and two compares per element (``itemsize`` 8: its float64
    form, against the float64 rate).  The greedy bound reads the
    reduced costs once, one chosen cost a row and the int64 order, writes a
    total an instance, and compares each entry once a step it is read; its
    scan is sequential, so its real floor, n steps of latency, is reported
    beside this bound (``serial_floor_ms``)."""
    f32 = 4
    if name == "col_min":
        nbytes, ops = B * n * m * f32 + B * m * f32, B * n * m
    elif name == "min_trick":
        nbytes, ops = B * n * m * f32 + B * n * f32 + B * m * f32, 2 * B * n * m
    elif name == "two_min":
        f = itemsize
        nbytes = B * n * m * f + B * m * f + 2 * B * n * f + B * n * 4
        ops = 3 * B * n * m * (F32_OPS_PER_S / F64_OPS_PER_S if f == 8 else 1)
    elif name == "greedy_total":
        # red read once, the n chosen costs, the int64 order, the totals
        nbytes, ops = B * n * m * f32 + B * n * f32 + B * n * 8 + B * f32, B * n * m
    else:
        nbytes, ops = B * n * m * f32 + B * n * 13 * f32, 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _solver_bound_ms(name: str, elements: int, n: int, itemsize: int = 4):
    """Least time for one call of a solver kernel on these inputs, from the
    matrix elements this run's data needs it to read: S1 reads C once a
    round and, each sweep, the rows whose e changed (``_s1_rows_read``),
    and does about five float operations an element (two subtracts, the
    clamp, the add, the compare); S2 reads the free
    rows of C each round (K4's subtract and two compares an element); S3
    reads the free rows of the bool tight matrix each round (integer work
    the rate table does not cover: bytes only).  While the (n, n) matrix
    fits in the card's L2, only its first read must come from device memory
    (at most n^2 elements): the later ones can be served on chip, at a rate
    the table does not give, so they count by their operations alone.
    Above L2 every read counts at the device-memory rate.  Returns the
    bound, what bounds it, and the device-memory time of every read (the
    bound above L2, an upper estimate below)."""
    every_read = elements * itemsize / HBM_BYTES_PER_S * 1e3
    from_hbm = min(elements, n * n) if n * n * itemsize <= L2_BYTES else elements
    ops = elements * {"augment_sweep": 5, "arr_auction": 3, "greedy_match": 0}[name]
    rate = F64_OPS_PER_S if itemsize == 8 else F32_OPS_PER_S
    t_bytes = from_hbm * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), every_read


def _sinkhorn_bound_ms(B: int, n: int, half_passes: int):
    """Least time for one ladder launch: every half-pass reads the (B, n, n)
    float32 matrix and the two projections read the true one, each read
    counted from device memory (the kernel's resident layout reads it once
    there), against five float32 operations an element a half-pass (a
    subtract, a divide, the subtract of the running maximum, an exp, an add)
    and two a projection's element.  Returns (bound, what bounds it, the
    one-read device-memory time)."""
    elements = B * n * n
    t_bytes = (half_passes + 2) * elements * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = (5 * half_passes + 4) * elements / F32_OPS_PER_S * 1e3
    one_read = 2 * elements * 4 / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), one_read


def _sinkhorn_inputs(torch, C, seed):
    """What ``sinkhorn_refine`` hands the ladder for a (B, n, n) card batch:
    the clipped matrix, float32 row duals, the scale and the rungs."""
    from lapgnn_tpu_torch.ops import sinkhorn as sink
    from lapgnn_tpu_torch.ops.sentinels import clip_cost_sentinels

    g = torch.Generator(device="cuda").manual_seed(seed)
    u0 = torch.randn(C.shape[:2], generator=g, device="cuda") * 0.1
    cost_r = clip_cost_sentinels(C).contiguous()
    rungs = sink.DEFAULT_EPS_SCHEDULE
    if C.shape[-1] >= sink.COLD_FINISH_MIN_N:
        rungs = rungs + (sink.COLD_FINISH_EPS,)
    eps_rel = torch.tensor(rungs, dtype=torch.float32).tolist()
    return cost_r, u0, sink._robust_scale(cost_r), eps_rel, sink.DEFAULT_ITERS_PER_EPS


def _hold_sinkhorn(torch, args, got, what):
    """The ladder kernel's (u, v) on ``args`` against the eager loop on the
    same card: within the module's tolerance (NaN where NaN) and exactly
    feasible for the true matrix.  Returns the largest difference."""
    from lapgnn_tpu_torch.ops.cuda import sinkhorn as ksink

    cost_r, cost = args[0], args[1]
    want = ksink.sinkhorn_ladder_plain(*args)
    tol = ksink.tolerance(torch.nan_to_num(cost_r, nan=0.0, posinf=0.0, neginf=0.0))
    err = 0.0
    for a, b in zip(got, want):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"sinkhorn_ladder: NaN where the loop has none ({what})")
        fin = torch.isfinite(b)
        d = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
        if not bool((d <= tol).all()) or not torch.equal(a[~fin], b[~fin]):
            raise AssertionError(f"sinkhorn_ladder: {float(d.max())} from the eager loop, "
                                 f"tolerance {float(tol.max())} ({what})")
        err = max(err, float(d.max()))
    red = cost - got[0][..., :, None] - got[1][..., None, :]
    if bool((red < 0).any()):
        raise AssertionError(f"sinkhorn_ladder: the projected pair is not feasible ({what})")
    return err


def _check_sinkhorn(torch, C, seed, what):
    from lapgnn_tpu_torch.ops.cuda.sinkhorn import sinkhorn_ladder_kernel

    cost_r, *rest = _sinkhorn_inputs(torch, C, seed)
    args = (cost_r, C, *rest)
    return _hold_sinkhorn(torch, args, sinkhorn_ladder_kernel(*args), what)


def phase_build(torch, strict=True):
    """Build every library at once, one compiler process each, and print
    what ``nvcc -Xptxas -v`` said of every kernel.  A kernel that spills
    registers fails the phase (``strict``)."""
    from concurrent.futures import ThreadPoolExecutor

    from lapgnn_tpu_torch.ops.cuda._lib import KERNEL_LIBS
    from lapgnn_tpu_torch.solver.native import LIBRARY

    libs = dict(KERNEL_LIBS, native=LIBRARY)

    def timed_load(lib):
        t = time.perf_counter()
        lib.load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        seconds = dict(zip(libs, pool.map(timed_load, libs.values())))
    spills = []
    for name in KERNEL_LIBS:
        log = KERNEL_LIBS[name].path.with_suffix(".log")
        for line in (log.read_text() if log.exists() else "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                spills.append(f"{name}: {line.strip()}")
    if spills and strict:
        raise AssertionError(f"kernels spill registers: {spills}")
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "per_library_seconds": seconds,
           "augment_static_smem": _augment_static_smem(strict),
           "auction_static_smem": _auction_static_smem(strict),
           "colmin_max_active_clusters": _colmin_cluster_occupancy(strict)})


def _augment_static_smem(strict):
    """S1's static shared memory a block in each layout and type, which its
    resident layout's limit (``augment_resident``) must not undercount."""
    from lapgnn_tpu_torch.ops.cuda._lib import KERNEL_LIBS
    from lapgnn_tpu_torch.ops.cuda.augment import LAYOUTS, resident_static_smem

    lib = KERNEL_LIBS["augment"].load()
    out = {}
    for f64, itemsize in ((0, 4), (1, 8)):
        for code, layout in enumerate(LAYOUTS):
            got = lib.lapgnn_augment_static_smem(f64, code)
            out[f"{layout}_{'float64' if f64 else 'float32'}"] = got
            if strict and not 0 < got <= resident_static_smem(itemsize):
                raise AssertionError(f"augment {layout} f64={f64}: {got} B of static shared "
                                     f"memory, above the {resident_static_smem(itemsize)} "
                                     "the resident limit assumes")
    return out


def _auction_static_smem(strict):
    """S2's static shared memory a block in each layout and type, and S3's,
    which their layouts' limits (``arr.STATIC_SMEM``,
    ``greedy_match.STATIC_SMEM``) must not undercount."""
    import importlib

    from lapgnn_tpu_torch.ops.cuda import arr as arr_mod
    from lapgnn_tpu_torch.ops.cuda._lib import KERNEL_LIBS

    gm_mod = importlib.import_module("lapgnn_tpu_torch.ops.cuda.greedy_match")
    lib = KERNEL_LIBS["arr"].load()
    out = {}
    for f64 in (0, 1):
        for code, layout in enumerate(arr_mod.LAYOUTS):
            out[f"arr_{layout}_{'float64' if f64 else 'float32'}"] = (
                lib.lapgnn_arr_static_smem(f64, code), arr_mod.STATIC_SMEM)
    out["greedy_match"] = (KERNEL_LIBS["greedy_match"].load().lapgnn_greedy_match_static_smem(),
                           gm_mod.STATIC_SMEM)
    bad = {k: v for k, v in out.items() if not 0 < v[0] <= v[1]}
    if bad and strict:
        raise AssertionError(f"static shared memory above what the layouts assume: {bad}")
    return {k: v[0] for k, v in out.items()}


def _colmin_cluster_occupancy(strict):
    """How many clusters of K1 / K2 the card holds at once, for the main
    path's geometry and the largest the geometry picks at other sizes; 0
    would mean a launch refused at run time."""
    from lapgnn_tpu_torch.ops.cuda._lib import KERNEL_LIBS
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_geometry

    lib = KERNEL_LIBS["colmin"].load()
    g = col_min_geometry(N_E2E, N_E2E, True)
    out = {}
    for cluster, ahead in sorted({(g.cluster, g.ahead), (8, 4), (8, 8), (4, 4)}):
        for has_u in (0, 1):
            got = lib.lapgnn_colmin_max_active_clusters(has_u, 1, ahead, cluster, g.warps)
            out[f"cluster{cluster}_ahead{ahead}_{'k2' if has_u else 'k1'}"] = got
            if got <= 0 and strict:
                raise AssertionError(
                    f"no cluster of {cluster} x {g.warps} warps fits the card ({got})")
    print(f"colmin cluster path at n = {N_E2E}: {g}")
    return out


def _batch(torch, n, seed, fams=("uniform", "tie")):
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES

    rng = np.random.default_rng(seed)
    C = np.stack([FAMILIES[f](n, rng).astype(np.float32) for f in fams])
    return torch.from_numpy(C).cuda()


def _check_two_min(torch, got, want, what):
    """K4 against its plain version (float32 or float64): argmin equal, min1
    and min2 bit-equal (NaN where the plain version has NaN).  Returns the
    largest absolute difference over the finite entries."""
    if not torch.equal(got[2], want[2]):
        raise AssertionError(f"two_min argmin differs from its plain version ({what})")
    err = 0.0
    for g, w in zip(got[:2], want[:2]):
        nan = torch.isnan(w)
        if g.dtype != w.dtype or not torch.equal(torch.isnan(g), nan):
            raise AssertionError(f"two_min dtype or NaN pattern differs ({what})")
        bits = torch.int64 if w.dtype == torch.float64 else torch.int32
        if not torch.equal(g[~nan].view(bits), w[~nan].view(bits)):
            raise AssertionError(f"two_min values differ from its plain version ({what})")
        fin = torch.isfinite(w)
        if fin.any():
            err = max(err, float((g[fin] - w[fin]).abs().max()))
    return err


# K3's channels that are selections or counts: bit-equal to the plain version.
K3_EXACT_CHANNELS = (0, 1, 4, 6, 11, 12)
# (rows, m) beyond the square sizes, for K3 and K4: odd m, m < k = 10, m not a
# multiple of 4 or 32, eight warps a row, and K3's shared-memory path.
RAGGED_SHAPES = ((37, 1), (37, 7), (37, 10), (37, 11), (37, 33), (50, 1001),
                 (40, 16384), (12, 20000))


def _check_k3(torch, C, what, finite=False):
    """K3 against its plain version on the same input: every channel within
    K3_RTOL / K3_ATOL, the selection channels bit-equal.  Entries where the
    plain version is NaN (inf - inf inside a float sum of a row with +-inf)
    are not compared: there the kernel keeps what it always gave (its
    ``fmaxf`` / ``fminf`` drop a NaN operand where torch propagates it).
    Returns the kernel's result and the largest absolute difference over
    the finite entries."""
    from lapgnn_tpu_torch.ops.cuda import row_features_stats

    got = row_features_stats(C)
    return got, _hold_k3(torch, got, C, what, finite)


def _hold_k3(torch, got, C, what, finite=False):
    """``_check_k3`` on a result ``got`` the kernel gave for C; returns the
    largest absolute difference over the finite entries."""
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_plain
    from lapgnn_tpu_torch.ops.cuda.features import row_features_stats_plain

    want = row_features_stats_plain(C, col_min_plain(C))
    torch.cuda.synchronize()
    if finite and not torch.isfinite(got).all():
        raise AssertionError(f"row_features_stats is not finite ({what})")
    known = ~torch.isnan(want)
    torch.testing.assert_close(got[known], want[known], rtol=K3_RTOL, atol=K3_ATOL,
                               msg=lambda m: f"row_features_stats ({what}): {m}")
    for ch in K3_EXACT_CHANNELS:
        if not torch.equal(got[..., ch].view(torch.int32), want[..., ch].view(torch.int32)):
            raise AssertionError(
                f"row_features_stats channel {ch} is not bit-equal to its plain version ({what})")
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def _special_rows(torch, C):
    """A copy of the (2, n, m >= 7) batch with rows that try the selections:
    all equal, +-0.0 mixed between -1 and 1, +inf, -inf, and both."""
    S = C.clone()
    m = S.shape[-1]
    S[0, 1, :] = 0.25
    S[0, 2, :] = 0.0
    S[0, 2, ::2] = -0.0
    S[0, 2, 0], S[0, 2, m - 1] = -1.0, 1.0
    S[1, 1, :] = S[0, 2, :]
    S[1, 1, m // 2] = 0.5
    S[0, 3, 5] = float("inf")
    S[0, 4, 2] = float("-inf")
    S[1, 2, 1], S[1, 2, m - 2] = float("-inf"), float("inf")
    return S


def _nan_inf_rows(torch, C):
    """+-inf in one row, NaN in three others (one NaN, two NaNs, and a NaN
    with its sign bit set)."""
    S = C.clone()
    m = S.shape[-1]
    S[1, 9, 3] = torch.tensor([-4194303], dtype=torch.int32).view(torch.float32).item()
    S[0, 3, 5] = float("inf")
    S[0, 4, 2] = S[0, 4, m - 1] = float("-inf")
    S[1, 7, m - 2] = float("nan")
    S[1, 8, 1] = S[1, 8, m // 2] = float("nan")
    return S


# Every geometry K1 / K2 pick or can be forced to (``col_min_geometry``).
COLMIN_FORCED = (
    {}, {"path": "two_launch"}, {"path": "cluster"}, {"path": "cluster", "ahead": 4},
    {"path": "cluster", "ahead": 8}, {"path": "cluster", "cluster": 1},
    {"path": "cluster", "cluster": 2, "ahead": 8}, {"path": "cluster", "cluster": 4},
    {"path": "cluster", "cluster": 8, "ahead": 4},
)
# (rows, m) for K1 / K2 beside RAGGED_SHAPES: few rows, few columns, one row,
# one column, and rows that leave the last blocks of a cluster short or empty.
COLMIN_SHAPES = ((7, 16384), (16384, 7), (1, 5000), (3000, 1), (1001, 2048), (100, 4096))


def _check_col_min(torch, C, u, what, forced=COLMIN_FORCED):
    """K1 on C and K2 on (C, u), on every geometry of ``forced``, against
    the plain versions: the same NaN pattern, bit-equal elsewhere, except
    that a zero minimum of a column holding both -0.0 and +0.0 need only
    compare equal.  Returns the largest absolute differences, and how many
    such zeros were compared and how many came out with the other sign."""
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_kernel

    errs, mixed_zeros, other_sign = {}, 0, 0
    for name, uu in (("col_min", None), ("min_trick", u)):
        want = _colmin_want(torch, C, uu)
        errs[name] = 0.0
        for force in forced:
            got = col_min_kernel(C, uu, **force)
            torch.cuda.synchronize()
            e, mixed, other = _hold_colmin(torch, name, got, want, f"{what}, {force}")
            errs[name] = max(errs[name], e)
            mixed_zeros += mixed
            other_sign += other
    return errs, mixed_zeros, other_sign


def _colmin_want(torch, C, u):
    """K1's (``u`` None) or K2's plain result on (C, u), with the columns
    whose zero minimum comes from both -0.0 and +0.0 (there the sign is
    free): (want, mixed)."""
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_plain, min_trick_plain

    X = C if u is None else C - u[..., :, None]
    want = col_min_plain(C) if u is None else min_trick_plain(C, u)
    zero, neg = X == 0, torch.signbit(X)
    return want, (zero & neg).any(-2) & (zero & ~neg).any(-2) & (want == 0)


def _hold_colmin(torch, name, got, want_mixed, what):
    """K1 / K2's result ``got`` against ``_colmin_want``'s: the same NaN
    pattern, bit-equal elsewhere but for mixed-zero minima, which need only
    be zero.  Returns (largest absolute difference over the finite entries,
    mixed zeros compared, mixed zeros with the other sign)."""
    want, mixed = want_mixed
    nan = torch.isnan(want)
    exact = ~nan & ~mixed
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{name} NaN pattern differs ({what})")
    if not torch.equal(got[exact].view(torch.int32), want[exact].view(torch.int32)):
        raise AssertionError(f"{name} differs from its plain version ({what})")
    if not bool((got[mixed] == 0).all()):
        raise AssertionError(f"{name} mixed-zero minimum is not zero ({what})")
    other = int((torch.signbit(got[mixed]) != torch.signbit(want[mixed])).sum())
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    return err, int(mixed.sum()), other


def _colmin_special_inputs(torch, C, u):
    """Copies of a (B, n, m) batch and its (B, n) u that try K1 / K2's merge
    levels: columns with a NaN, all +inf, a -inf, all equal; a NaN in u
    (every column of that matrix NaN); and columns whose minimum is a zero
    of both signs, for K1 in C itself and for K2 through C == u, in either
    order of the signs.  Indices wrap, so any shape takes them."""
    B, n, m = C.shape
    V = C.clone()
    V[0, n // 2, 0] = float("nan")
    V[0, :, 1 % m] = float("inf")
    V[-1, n - 1, 2 % m] = float("-inf")
    V[-1, :, 3 % m] = 0.25
    V[0, 0, 4 % m] = float("inf")
    nan_u = u.clone()
    nan_u[0, n // 3] = float("nan")
    Z, zu = C.clone(), u.clone()
    j1, j2 = 5 % m, 6 % m
    Z[..., j1] = 1.0  # K1: zeros of both signs under ones
    for b in range(B):
        plus, minus = (0, n - 1) if b % 2 == 0 else (n - 1, 0)
        zu[b, minus] = 0.0
        Z[b, :, j2] = zu[b] + 1.0  # K2: C - u is about 1 ...
        Z[b, plus, j2] = zu[b, plus]  # ... but +0.0 where C == u
        Z[b, minus, j2] = -0.0  # ... and -0.0 - 0.0 = -0.0
        Z[b, plus, j1], Z[b, minus, j1] = 0.0, -0.0
    return {"special values": (V, u), "NaN in u": (C, nan_u), "mixed zeros": (Z, zu)}


def phase_compare(torch, seed):
    from lapgnn_tpu_torch.ops import features
    from lapgnn_tpu_torch.ops.cuda import col_min, min_trick, two_min
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_geometry, col_min_plain, min_trick_plain
    from lapgnn_tpu_torch.ops.cuda.features import row_features_geometry
    from lapgnn_tpu_torch.ops.cuda.twomin import two_min_geometry, two_min_kernel, two_min_plain

    errs = {name: 0.0 for name in KERNELS}
    detail = []
    zero_signs = {"mixed_zero_minima": 0, "other_sign_than_amin": 0}
    gc = torch.Generator(device="cuda").manual_seed(seed + 29)  # K1 / K2's own draws

    def hold_col_min(C, u, what, forced=COLMIN_FORCED, special=True):
        inputs = {"as drawn": (C, u)}
        if special:
            inputs.update(_colmin_special_inputs(torch, C, u))
        for label, (Cs, us) in inputs.items():
            e, mixed, other = _check_col_min(torch, Cs, us, f"{label}, {what}", forced)
            for name in e:
                errs[name] = max(errs[name], e[name])
            zero_signs["mixed_zero_minima"] += mixed
            zero_signs["other_sign_than_amin"] += other

    for n in COMPARE_SIZES:
        C = _batch(torch, n, seed + n)
        g = torch.Generator(device="cuda").manual_seed(seed + n)
        u = torch.randn((2, n), generator=g, device="cuda") * 0.3
        k1, p1 = col_min(C), col_min_plain(C)
        k2, p2 = min_trick(C, u), min_trick_plain(C, u)
        sort_path = features.row_features(C)[..., :13]
        torch.cuda.synchronize()
        if not torch.equal(k1.view(torch.int32), p1.view(torch.int32)):
            raise AssertionError(f"col_min differs from amin at n={n}")
        if not torch.equal(k2.view(torch.int32), p2.view(torch.int32)):
            raise AssertionError(f"min_trick differs from its plain version at n={n}")
        k3, e3 = _check_k3(torch, C, f"n={n}", finite=True)
        _check_k3(torch, _special_rows(torch, C), f"special rows, n={n}")
        errs["col_min"] = max(errs["col_min"], float((k1 - p1).abs().max()))
        errs["min_trick"] = max(errs["min_trick"], float((k2 - p2).abs().max()))
        hold_col_min(C, u, f"n={n}")
        errs["row_features_stats"] = max(errs["row_features_stats"], e3)
        v = torch.randn((2, n), generator=g, device="cuda") * 0.3
        errs["two_min"] = max(errs["two_min"], _check_two_min(
            torch, two_min(C, v), two_min_plain(C, v), f"n={n}"))
        S = _nan_inf_rows(torch, C)
        _check_two_min(torch, two_min(S, v), two_min_plain(S, v), f"inf/NaN rows, n={n}")
        # every geometry the wrapper can be forced to
        for force in ({"state": s, "unroll": r} for s in ("keys", "floats") for r in (4, 1)):
            _check_two_min(torch, two_min_kernel(S, v, **force), two_min_plain(S, v),
                           f"inf/NaN rows, n={n}, {force}")
        # float64 (the device solver's float64 solves), both of its unrolls
        C64, v64, S64 = C.double(), v.double(), S.double()
        errs["two_min"] = max(errs["two_min"], _check_two_min(
            torch, two_min(C64, v64), two_min_plain(C64, v64), f"float64, n={n}"))
        for r in (4, 1):
            _check_two_min(torch, two_min_kernel(S64, v64, unroll=r), two_min_plain(S64, v64),
                           f"float64 inf/NaN rows, n={n}, unroll {r}")
        del C64, S64
        if n in (N_E2E, 8192):
            errs["sinkhorn_ladder"] = max(errs["sinkhorn_ladder"],
                                          _check_sinkhorn(torch, C, seed + n, f"n={n}"))
        rel = ((k3 - sort_path).abs() / (sort_path.abs() + K3_ATOL / K3_RTOL)).amax((0, 1))
        detail.append({"n": n, "k3_max_abs_err": e3,
                       "k3_vs_sort_path_max_rel_per_channel": [float(x) for x in rel]})

    # Ragged and long rows: batch 0 continuous, batch 1 heavy with ties.
    ragged = []
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    for rows, m in RAGGED_SHAPES:
        C = torch.rand((2, rows, m), generator=g, device="cuda")
        C[1] = torch.floor(C[1] * 8.0) / 8.0
        v = torch.randn((2, m), generator=g, device="cuda") * 0.3
        what = f"rows={rows}, m={m}"
        _, e3 = _check_k3(torch, C, what, finite=True)
        if m >= 7:
            _check_k3(torch, _special_rows(torch, C), f"special rows, {what}")
        errs["row_features_stats"] = max(errs["row_features_stats"], e3)
        errs["two_min"] = max(errs["two_min"], _check_two_min(
            torch, two_min(C, v), two_min_plain(C, v), what))
        _check_two_min(torch, two_min(C.double(), v.double()),
                       two_min_plain(C.double(), v.double()), f"float64, {what}")
        if m >= 7:
            S = _nan_inf_rows(torch, C)
            _check_two_min(torch, two_min(S, v), two_min_plain(S, v), f"inf/NaN rows, {what}")
            _check_two_min(torch, two_min(S.double(), v.double()),
                           two_min_plain(S.double(), v.double()), f"float64 inf/NaN rows, {what}")
        hold_col_min(C, torch.randn((2, rows), generator=gc, device="cuda") * 0.3, what)
        ragged.append({"rows": rows, "m": m, "k3_max_abs_err": e3,
                       "k3_path": row_features_geometry(m, True).path,
                       "k3_warps_per_row": row_features_geometry(m, True).warps_per_row,
                       "k4_vector_loads": two_min_geometry(rows, m, True, batch=2).vector,
                       "k1_k2_path": col_min_geometry(rows, m, True, batch=2).path})

    # K1 / K2 at rectangular shapes, batch 2, then batch 5, then a batch whose
    # element offsets pass 2^31 (8 x 16384 x 16384, default paths only).
    colmin_shapes = []
    for batch, shapes in ((2, COLMIN_SHAPES), (5, ((257, 1001), (N_E2E, N_E2E)))):
        for rows, m in shapes:
            C = torch.rand((batch, rows, m), generator=gc, device="cuda")
            C[-1] = torch.floor(C[-1] * 8.0) / 8.0
            u = torch.randn((batch, rows), generator=gc, device="cuda") * 0.3
            hold_col_min(C, u, f"batch={batch}, rows={rows}, m={m}")
            geo = col_min_geometry(rows, m, True, batch=batch)
            colmin_shapes.append({"batch": batch, "rows": rows, "m": m, "path": geo.path,
                                  "cluster": geo.cluster, "rows_per_block": geo.rows_per_block})
    C = torch.rand((8, 16384, 16384), generator=gc, device="cuda")
    u = torch.randn((8, 16384), generator=gc, device="cuda") * 0.3
    hold_col_min(C, u, "batch=8, n=16384", forced=({}, {"path": "two_launch"}), special=False)
    del C, u
    torch.cuda.empty_cache()

    # A view that starts 4 bytes into its buffer: contiguous, not 16-byte aligned.
    n = COMPARE_SIZES[0]
    C = _batch(torch, n, seed + n)
    buf = torch.empty(C.numel() + 1, dtype=torch.float32, device="cuda")
    Cu = buf[1:].view(C.shape).copy_(C)
    vbuf = torch.empty(2 * n + 1, dtype=torch.float32, device="cuda")
    vu = vbuf[1:].view(2, n).copy_(torch.randn((2, n), generator=g, device="cuda") * 0.3)
    if Cu.data_ptr() % 16 == 0 or vu.data_ptr() % 16 == 0:
        raise AssertionError("the unaligned views came out aligned")
    _, e3 = _check_k3(torch, Cu, "unaligned view", finite=True)
    _check_k3(torch, _special_rows(torch, Cu), "special rows, unaligned view")
    errs["row_features_stats"] = max(errs["row_features_stats"], e3)
    errs["two_min"] = max(errs["two_min"], _check_two_min(
        torch, two_min(Cu, vu), two_min_plain(Cu, vu), "unaligned view"))
    if col_min_geometry(n, n, Cu.data_ptr() % 16 == 0, batch=2, path="cluster").vector:
        raise AssertionError("the unaligned view would take 16-byte loads")
    hold_col_min(Cu, vu, "unaligned view")
    errs["sinkhorn_ladder"] = max(errs["sinkhorn_ladder"],
                                  _check_sinkhorn(torch, Cu, seed, "unaligned view"))
    _check_two_min(torch, two_min(_nan_inf_rows(torch, Cu), vu),
                   two_min_plain(_nan_inf_rows(torch, Cu), vu), "inf/NaN rows, unaligned view")

    long_row = _check_long_row(torch, seed)
    greedy, errs["greedy_total"] = _check_greedy(torch, seed)
    _emit({"phase": "compare", "max_abs_err": errs, "detail": detail, "ragged": ragged,
           "k1_k2_shapes": colmin_shapes, "k1_k2_mixed_zero_signs": zero_signs,
           "unaligned_view": {"n": n, "k3_max_abs_err": e3},
           "k3_long_row": long_row, "greedy": greedy})
    return errs


def _check_long_row(torch, seed):
    """A row longer than K3 takes on this card (about 58K columns) goes to
    the sort-based row features, not to the kernel: held against
    ``row_features`` within K3's tolerance, with K3's counter unmoved."""
    from lapgnn_tpu_torch.ops import features
    from lapgnn_tpu_torch.ops.cuda.features import row_features_max_m

    limit = row_features_max_m(torch.device("cuda"))
    m = 60_000
    if m <= limit:
        raise AssertionError(f"K3 takes rows of {limit} columns; the long-row check needs more")
    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    C = torch.rand((1, 2, m), generator=g, device="cuda")
    since = _launches()
    got = features.fast_row_features(C)
    want = features.row_features(C)
    torch.cuda.synchronize()
    if _launches(since)["row_features_stats"]:
        raise AssertionError("a row past K3's limit launched K3")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=K3_RTOL, atol=K3_ATOL):
        raise AssertionError(f"long row: fast_row_features differs from row_features by {err}")
    return {"m": m, "k3_max_m": limit, "max_abs_err": err}


def _max_abs_err(torch, got, want):
    """Largest |got - want| over the entries where it is a number (equal
    infinities and NaNs, held bit for bit by the caller, give none)."""
    d = (got.float() - want.float()).abs()
    d = d[torch.isfinite(d)]
    return float(d.max()) if d.numel() else 0.0


def _check_greedy(torch, seed):
    """The greedy kernel against its plain loop, bit for bit: n in
    ``GREEDY_SIZES`` on the tie family (rows of equal values), a row of +inf,
    rows with +inf tails, a row with a NaN (the first NaN wins the argmin),
    and with and without a row mask.  Returns (detail, max abs error)."""
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES
    from lapgnn_tpu_torch.ops.cuda.greedy import greedy_total, greedy_total_plain
    from lapgnn_tpu_torch.train.loss import greedy_primal_upper

    out, err = [], 0.0
    for n in GREEDY_SIZES:
        B = 2 if n > 2048 else 4
        rng = np.random.default_rng(seed + n)
        fams = ("tie", "uniform", "tie", "sparse")[:B]
        C = torch.from_numpy(np.stack([FAMILIES[f](n, rng).astype(np.float32) for f in fams])).cuda()
        red = C - C.amin(-2, keepdim=True) - 0.05 * torch.arange(n, device="cuda")[:, None] / n
        red[0, n // 2, :] = torch.inf
        red[1 % B, :, n // 3:] = torch.inf
        red[B - 1, n // 4, (n - 1) // 5 :: 7] = torch.nan
        mask = torch.ones((B, n), dtype=torch.bool, device="cuda")
        mask[B - 1, ::3] = False
        for m in (None, mask):
            got = greedy_primal_upper(C, red, m).cpu()
            want = greedy_primal_upper(C.cpu(), red.cpu(), None if m is None else m.cpu())
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"greedy kernel differs from the CPU at n={n}, mask={m is not None}")
            order = torch.argsort(red.amin(-1), dim=-1, stable=True)
            k = greedy_total(red, C, order, m)
            pl = greedy_total_plain(red, C, order, m)
            torch.cuda.synchronize()
            if not torch.equal(k.view(torch.int32), pl.view(torch.int32)):
                raise AssertionError(f"greedy kernel differs from its plain loop at n={n}")
            err = max(err, _max_abs_err(torch, got, want), _max_abs_err(torch, k, pl))
        out.append({"n": n, "batch": B, "bit_equal": True})
    return out, err


CHECKPOINT = Path(__file__).resolve().parent / "artifacts" / "one_gnn_default"


def _e2e_costs(seed):
    """One float32 instance of each family at n = N_E2E, drawn from ``seed``."""
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES

    rng = np.random.default_rng(seed)
    return {f: FAMILIES[f](N_E2E, rng).astype(np.float32) for f in FAMILIES_E2E}


def _scipy_opt(C64) -> float:
    import scipy.optimize

    r, c = scipy.optimize.linear_sum_assignment(C64)
    return float(C64[r, c].sum())


def _launches(since=None):
    """Each kernel wrapper's launches by name: the tracer's counters
    ``launch.<wrapper>``, or their rise since ``since``, an earlier
    ``_launches()``."""
    from lapgnn_tpu_torch import tracing
    from lapgnn_tpu_torch.ops import cuda

    now, since = tracing.counters(), since or {}
    return {w: now.get(f"launch.{w}", 0) - since.get(w, 0) for w in cuda.__all__}


def phase_e2e(torch, seed):
    import numpy as np

    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.solver.native import lapjv_native, lapjv_seeded_native
    from lapgnn_tpu_torch.solver.verification import certify_assignment
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint

    params, meta, _ = load_checkpoint(CHECKPOINT)
    pipe = WarmStartPipeline(
        build_model_from_meta(meta), params, mode="hybrid", seed_mode="auto",
        normalize_costs=True,
    )
    n = N_E2E
    costs = _e2e_costs(seed)

    since = _launches()
    results = {f: pipe.solve(C, certify=True) for f, C in costs.items()}
    torch.cuda.synchronize()
    launches = _launches(since)

    per = len(costs)
    if (launches["row_features_stats"] < per or launches["col_min"] < per
            or launches["min_trick"] < 2 * per):
        raise AssertionError(f"the hybrid path skipped a kernel: launches {launches}")
    report = {}
    for f, C in costs.items():
        out = results[f]
        C64 = C.astype(np.float64)
        opt = _scipy_opt(C64)
        got = float(out["cost"][0])
        if not abs(got - opt) <= 1e-12 * max(1.0, abs(opt)):
            raise AssertionError(f"{f}: cost {got!r} != SciPy {opt!r}")
        _, _, _, _, v_opt = lapjv_native(C64, return_duals=True)
        ok, viol, _ = certify_assignment(C64, out["col_of_row"][0], v_opt)
        if not (ok and out["certified"].all()):
            raise AssertionError(f"{f}: certificate failed (violation {viol})")

        # times per instance, outside the counted run: predict on the card
        # (host clock around work ending in a synchronize), then the host solve
        predict_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u, v = pipe.predict_duals(C)
            torch.cuda.synchronize()
            predict_ms.append((time.perf_counter() - t0) * 1e3)
        uv = torch.stack([u, v], 1).cpu().numpy().astype(np.float64)
        t0 = time.perf_counter()
        x, _, c_host, info = lapjv_seeded_native(
            C64, uv[0, 0], uv[0, 1], eps=pipe.eps, gate=pipe.gate, return_info=True
        )
        host_ms = (time.perf_counter() - t0) * 1e3
        if c_host != got:
            raise AssertionError(f"{f}: the timed host solve gave another cost")
        report[f] = {"cost": got, "scipy_cost": opt, "used_fallback": bool(out["used_fallback"][0]),
                     "predict_ms_median": statistics.median(predict_ms),
                     "host_solve_ms": host_ms}
    _emit({"phase": "e2e", "n": n, "launches": launches, "instances": report})
    return pipe, costs["uniform"]


# The stream phase's postures (bench.py's streamed postures, on the card).
# Each: (label, transfer_dtype, n, instance families, microbatch).
STREAM_POSTURES = (
    ("float32", "float32", N_E2E, ("uniform",) * 6, 1),
    ("topk16", "topk16", N_E2E, ("uniform",) * 8, 1),
    ("topk16_noisy_linear", "topk16", N_E2E, ("noisy_linear",), 1),
    ("bfloat16", "bfloat16", N_E2E, ("uniform",) * 6, 1),
    ("float16", "float16", N_E2E, ("uniform",) * 6, 1),
    ("uint16", "uint16", N_E2E, ("uniform",) * 6, 1),
    ("uint16_sparse", "uint16", N_E2E, ("sparse",), 1),
    ("topk16_microbatch8_n512", "topk16", 512, ("uniform",) * 16, 8),
    ("topk16_microbatch8_n1024", "topk16", 1024, ("uniform",) * 16, 8),
)
# Past 8192 rows the topk16 decode fills with a constant instead of the ramp.
DECODE_SIZES = (N_E2E, 8193)


def _stream_instances(n, fams, seed):
    """float64 instances (what a caller holds; the certificate reads them)."""
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES

    rng = np.random.default_rng(seed)
    return [FAMILIES[f](n, rng) for f in fams]


def _payload_bytes(payload) -> int:
    tensors = payload.values() if isinstance(payload, dict) else [payload]
    return sum(t.numel() * t.element_size() for t in tensors)


def _stream_stage_times(torch, pipe, chunks):
    """For the first three chunks: the host pack (encode, then the copy into
    pinned memory) on the host clock, the upload on a copy stream and the
    decode on the current stream by CUDA events; medians in ms, and the
    payload's bytes."""
    from lapgnn_tpu_torch.pipeline import _decode_transfer, _host_array

    stream = torch.cuda.Stream(pipe.device)
    encode, pack, upload, decode, nbytes = [], [], [], [], []
    for C in chunks[:1] + chunks[:3]:  # the first pass warms the copy path, and is dropped
        t0 = time.perf_counter()
        pipe._to_xfer(_host_array(C))
        encode.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        host = pipe._pack(C)
        pack.append((time.perf_counter() - t0) * 1e3)
        nbytes.append(_payload_bytes(host))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        dev, _ = pipe._upload(host, stream)
        end.record(stream)
        end.synchronize()
        upload.append(start.elapsed_time(end))
        torch.cuda.current_stream().wait_stream(stream)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _decode_transfer(dev)
        end.record()
        end.synchronize()
        decode.append(start.elapsed_time(end))
    def med(xs):
        return statistics.median(xs[1:])

    return {"payload_bytes": med(nbytes), "encode_ms": med(encode), "pack_ms": med(pack),
            "upload_ms": med(upload), "decode_ms": med(decode)}


def _stream_seed(seed, n, fam):
    """Instances of one family and size are the same in every posture."""
    return seed + 100 + n + FAMILIES_E2E.index(fam)


class _TimedParts:
    """Times, while in use, each call of this pipeline's ``_e2e`` (decode,
    predict, solve; host clock between synchronizes of the current stream) and
    ``_certify_and_polish`` (host clock, in whichever thread runs it), by
    shims on the pipeline object that are removed afterwards."""

    def __init__(self, torch, pipe):
        self.torch, self.pipe = torch, pipe
        self.ms = {"e2e": [], "certify": []}

    def __enter__(self):
        torch, pipe, ms = self.torch, self.pipe, self.ms
        e2e, certify = pipe._e2e, pipe._certify_and_polish

        def timed_e2e(payload):
            # the current stream only: uploads in flight on the copy stream go on
            torch.cuda.current_stream().synchronize()
            t0 = time.perf_counter()
            out = e2e(payload)
            torch.cuda.current_stream().synchronize()
            ms["e2e"].append((time.perf_counter() - t0) * 1e3)
            return out

        def timed_certify(*args):
            t0 = time.perf_counter()
            certify(*args)
            ms["certify"].append((time.perf_counter() - t0) * 1e3)

        pipe._e2e, pipe._certify_and_polish = timed_e2e, timed_certify
        return self.ms

    def __exit__(self, *exc):
        del self.pipe._e2e, self.pipe._certify_and_polish


def phase_stream(torch, seed):
    """``solve_stream(certify=True)`` in the postures of ``STREAM_POSTURES``
    at the full width of the checkpoint, ``certify_tol=1e-12``.  Each posture
    is warmed by a one-instance stream, then timed as one stream (launch
    counters zeroed just before and read just after), then solved call by
    call with ``solve(certify=True)`` (the same chunks where microbatched),
    with the device part and the certificate timed in both runs.
    Every instance must be certified and equal SciPy's float64 optimum to
    1e-12 relative; the stream's results must equal the calls' (assignment,
    cost, flags); K1-K3 and S1-S3 must have launched in the stream.  Then the decode on
    the card against the CPU decode of the same payloads, bit for bit."""
    import numpy as np

    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint

    params, meta, _ = load_checkpoint(CHECKPOINT)
    opt_cache = {}  # SciPy's optimum by (n, family, index)
    for label, dtype, n, fams, mb in STREAM_POSTURES:
        pipe = WarmStartPipeline(
            build_model_from_meta(meta), params, seed_mode="auto", normalize_costs=True,
            certify_tol=CERTIFY_TOL, transfer_dtype=dtype,
            route="device" if n < N_E2E else "auto",
        )
        costs = _stream_instances(n, fams, _stream_seed(seed, n, fams[0]))
        chunks = [np.stack(costs[i : i + mb]) for i in range(0, len(costs), mb)] if mb > 1 else costs
        t_phase = time.perf_counter()
        # warm the stream's code path on small instances (the kernels are built)
        pipe.solve_stream(_stream_instances(64, fams[:mb], seed + 1), certify=True,
                          microbatch=mb)
        since = _launches()
        torch.cuda.synchronize()
        with _TimedParts(torch, pipe) as in_stream:
            t0 = time.perf_counter()
            streamed = pipe.solve_stream(costs, certify=True, microbatch=mb)
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = _launches(since)
        if (launches["row_features_stats"] < len(chunks) or launches["col_min"] < len(chunks)
                or launches["min_trick"] < 2 * len(chunks)
                or min(launches[k] for k in ("augment_sweep", "arr_auction", "greedy_match")) < 1):
            raise AssertionError(f"{label}: the stream skipped a kernel: launches {launches}")

        serial, serial_ms = [], []
        with _TimedParts(torch, pipe) as parts:
            for C in chunks:
                t0 = time.perf_counter()
                serial.append(pipe.solve(C, certify=True))
                serial_ms.append((time.perf_counter() - t0) * 1e3)
        per_call = [{k: v[b : b + 1] for k, v in out.items()}
                    for out in serial for b in range(out["col_of_row"].shape[0])]
        for i, (C, got, want) in enumerate(zip(costs, streamed, per_call)):
            for key in ("col_of_row", "cost", "certified", "repaired", "polished", "used_fallback"):
                if not np.array_equal(got[key], want[key]):
                    raise AssertionError(f"{label}[{i}]: the stream's {key} differs from solve's")
            key = (n, fams[i], i)
            if key not in opt_cache:
                opt_cache[key] = _scipy_opt(C)
            opt, cost = opt_cache[key], float(got["cost"][0])
            if not (got["certified"].all() and abs(cost - opt) <= 1e-12 * max(1.0, abs(opt))):
                raise AssertionError(f"{label}[{i}]: cost {cost!r} vs SciPy {opt!r}, "
                                     f"certified {got['certified']}")
        # per instance (a microbatched chunk's time shared by its instances)
        per_inst = len(costs) / len(chunks)
        stages = {f"{k}_per_instance": v / per_inst
                  for k, v in _stream_stage_times(torch, pipe, chunks).items()}
        med = statistics.median
        e2e, cert = med(parts["e2e"]) / per_inst, med(parts["certify"]) / per_inst
        pack, upload = stages["pack_ms_per_instance"], stages["upload_ms_per_instance"]
        _emit({
            "phase": "stream", "posture": label, "transfer_dtype": dtype, "n": n,
            "instances": len(costs), "families": sorted(set(fams)), "microbatch": mb,
            "certify_tol": CERTIFY_TOL, **stages,
            "stream_wall_ms": wall_ms, "stream_ms_per_instance": wall_ms / len(costs),
            "serial_solve_ms_sum": sum(serial_ms), "serial_solve_ms": serial_ms,
            "serial_ms_per_instance": sum(serial_ms) / len(costs),
            "e2e_ms_per_instance": e2e, "certify_ms_per_instance": cert,
            # the same parts inside the stream, beside the other threads
            "stream_e2e_ms_per_instance": med(in_stream["e2e"]) / per_inst,
            "stream_certify_ms_per_instance": med(in_stream["certify"]) / per_inst,
            # the stream's stages run side by side: pack, upload, solve, and two certificates
            "stage_max_ms_per_instance": max(pack, upload, e2e, cert / 2),
            "stage_sum_ms_per_instance": pack + upload + e2e + cert,
            "certified": sum(int(o["certified"][0]) for o in streamed),
            "repaired": sum(int(o["repaired"][0]) for o in streamed),
            "polished": sum(int(o["polished"][0]) for o in streamed),
            "polish_ms": [float(o["polish_ms"][0]) for o in streamed if o["polished"][0]],
            "launches": launches, "posture_seconds": time.perf_counter() - t_phase,
        })
    _check_decode_on_card(torch, seed)


def _check_decode_on_card(torch, seed):
    """The decode on the card against the CPU decode of the same payload, bit
    for bit: topk16 (k = 64) and uint16 of a uniform matrix with 1e6
    sentinels at n = 2048 (the ramp fill) and 8193 (the constant fill), and
    the 16-bit floats at n = 2048."""
    import numpy as np

    from lapgnn_tpu_torch.pipeline import _decode_transfer, quantize_topk16, quantize_u16

    def same(payload, what):
        on_card = _decode_transfer(
            {k: v.cuda() for k, v in payload.items()} if isinstance(payload, dict)
            else payload.cuda()).cpu()
        on_cpu = _decode_transfer(payload)
        if not torch.equal(on_card.view(torch.int32), on_cpu.view(torch.int32)):
            raise AssertionError(f"the card's decode differs from the CPU's ({what})")

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 77)
    checked = []
    for n in DECODE_SIZES:
        C = rng.uniform(0.0, 1.0, (1, n, n)).astype(np.float32)
        C[0, :, ::3][rng.uniform(0.0, 1.0, (n, (n + 2) // 3)) < 0.5] = 1e6
        for name, enc in (("topk16", quantize_topk16(C, 64)), ("uint16", quantize_u16(C))):
            same({k: torch.from_numpy(v) for k, v in enc.items()}, f"{name}, n={n}")
            checked.append(f"{name}_n{n}")
        del C
    D = torch.from_numpy(rng.uniform(-1e3, 1e3, (1, N_E2E, N_E2E)))
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        same(D.to(dtype), f"{dtype}, n={N_E2E}")
        checked.append(f"{str(dtype).split('.')[-1]}_n{N_E2E}")
    _emit({"phase": "stream_decode", "bit_equal_card_vs_cpu": checked,
           "seconds": time.perf_counter() - t0})


def _ms_host(torch, fn, reps):
    """Median host-clock ms of ``fn`` over work that ends in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _copies(torch, fn):
    """The copies in one call of ``fn`` under torch.profiler, by kind
    ({"Memcpy HtoD (Pageable -> Device)": 1, ...}), or None where the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not rows:
        return None
    return {e.key: e.count for e in rows if e.key.startswith("Memcpy")}


def phase_device_e2e(torch, seed):
    """The default serving call on the card: predict, the float32 seeded
    solve on the device (S3, S2, S1: no host read from the seed to the
    result), the float64 certificate on the host."""
    import numpy as np

    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.solver.jv import DEVICE_COUNTS, SolveStats
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint

    params, meta, _ = load_checkpoint(CHECKPOINT)
    pipe = WarmStartPipeline(
        build_model_from_meta(meta), params, mode="device", seed_mode="auto",
        normalize_costs=True, certify_tol=CERTIFY_TOL,
    )
    if pipe.mode != "device" or pipe.device.type != "cuda":
        raise AssertionError("the default pipeline is not the device mode on the card")
    n = N_E2E
    costs = _e2e_costs(seed)
    solver = ("augment_sweep", "arr_auction", "greedy_match")

    since = _launches()
    results, stats, per_instance = {}, {}, {}
    for f, C in costs.items():
        before = _launches()
        results[f] = pipe.solve(C, certify=True)
        stats[f] = pipe.last_solve_stats[0]
        per_instance[f] = {k: _launches(before)[k] for k in solver}
    torch.cuda.synchronize()
    launches = _launches(since)

    per = len(costs)
    if (launches["row_features_stats"] < per or launches["col_min"] < per
            or launches["min_trick"] < 2 * per or launches["sinkhorn_ladder"] < per
            or min(min(p.values()) for p in per_instance.values()) < 1):
        raise AssertionError(
            f"the device path skipped a kernel: launches {launches}, "
            f"S1-S3 per instance {per_instance}"
        )
    syncs = {f: st.host_syncs for f, st in stats.items()}
    if any(syncs.values()):
        raise AssertionError(f"the device solve read back on the host: host syncs {syncs}")
    report = {}
    for f, C in costs.items():
        out = results[f]
        C64 = C.astype(np.float64)
        opt = _scipy_opt(C64)
        got = float(out["cost"][0])
        if not abs(got - opt) <= 1e-12 * max(1.0, abs(opt)):
            raise AssertionError(f"{f}: device cost {got!r} != SciPy {opt!r}")
        if not out["certified"].all():
            raise AssertionError(f"{f}: not certified (gap bound {out['gap_bound']})")
        if "routed_host" in out:
            raise AssertionError(f"{f}: routed to the host")
        how = ("polish" if out["polished"][0] else "repair" if out["repaired"][0] else "raw")

        # outside the counted run: the copies back of one uncertified solve,
        # then times
        copies = _copies(torch, lambda: pipe.solve(C))
        d2h = None if copies is None else sum(c for k, c in copies.items() if "DtoH" in k)
        if d2h is not None and d2h != 1:
            raise AssertionError(f"{f}: a device-mode solve made {d2h} device-to-host "
                                 f"copies: {copies}")
        Ct = torch.from_numpy(C).cuda()[None]
        predict_ms = _ms_host(torch, lambda: pipe.predict_duals(Ct), 3)
        u, v = pipe.predict_duals(Ct)
        with torch.inference_mode():
            solve_ms = _ms_host(torch, lambda: lapjv_seeded_single(
                Ct[0], u[0], v[0], eps=pipe.eps, gate=pipe.gate, stats=SolveStats()), 3)
        packed = pipe._e2e(Ct).cpu().numpy()
        again = pipe._unpack(packed, n)
        t0 = time.perf_counter()
        pipe._certify_and_polish(C64[None], packed, again)
        certify_ms = (time.perf_counter() - t0) * 1e3
        st = stats[f]
        report[f] = {
            "cost": got, "scipy_cost": opt, "certificate": how,
            "used_fallback": bool(out["used_fallback"][0]),
            "repaired": bool(out["repaired"][0]), "polished": bool(out["polished"][0]),
            "polish_ms": float(out["polish_ms"][0]),
            "predict_ms_median": predict_ms, "device_solve_ms_median": solve_ms,
            "certify_ms": certify_ms, "solver_kernel_launches": per_instance[f],
            "device_to_host_copies_a_solve": d2h if d2h is not None else "not measured",
            "copies_a_solve": copies if copies is not None else "not measured",
            "loops": {**{k: getattr(st, k) for k in DEVICE_COUNTS},
                      "host_syncs": st.host_syncs},
        }
    _emit({"phase": "device_e2e", "n": n, "certify_tol": CERTIFY_TOL,
           "launches": launches, "instances": report})
    return launches, pipe, costs


# device_vs_cpu: the sizes, and the cases at each (the four families, and
# uniform with a NaN row or an all-+inf row).
DEVICE_VS_CPU_N = (512, 2048)
VS_CPU_CASES = ("uniform", "noisy_linear", "sparse", "tie", "nan_row", "inf_row")
# float64 (S1's and S2's float64 forms), and the pipeline's predicted seeds
VS_CPU_EXTRA = ((1024, "uniform_f64"), (1024, "tie_f64"), (2048, "uniform_f64"),
                (2048, "predicted"))
# S1's unstaged layout: forced where the staged one fits, and where it must
# run (float64 above 11,622 columns); S2 in both its layouts on the float64
# matrix
AUGMENT_UNSTAGED = ((2048, "float32", True), (12288, "float64", False))
# device_vs_cpu's size at which each solve also runs S2 in its global layout
S2_GLOBAL_N = 2048


def _vs_cpu_case(n, case, seed):
    """(C, u, v) of one device_vs_cpu case: the family's matrix in float32
    (a "_f64" case in float64; nan_row / inf_row: uniform with row 3 NaN /
    row 5 +inf) and the min-trick seed of the clean matrix (u its row
    minima)."""
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES

    dtype = np.float64 if case.endswith("_f64") else np.float32
    case = case.removesuffix("_f64")
    fam = case if case in FAMILIES else "uniform"
    C = FAMILIES[fam](n, np.random.default_rng(seed + 5 + n)).astype(dtype)
    u = C.min(1)
    v = (C - u[:, None]).min(0)
    if case == "nan_row":
        C[3] = np.nan
    elif case == "inf_row":
        C[5] = np.inf
    return C, u, v


def _s1_layout(n, C):
    """The layout S1 takes by default for C."""
    from lapgnn_tpu_torch.ops.cuda._lib import sm_count
    from lapgnn_tpu_torch.ops.cuda.augment import augment_layout

    return augment_layout(n, C.element_size(), sm_count(C.device))


def _cpu_solve(job):
    """(n, case, seed, threads, (C, u, v) or None) -> the port's seeded solve
    of the case (of the arrays given, else ``_vs_cpu_case``'s) on the CPU: a
    worker of device_vs_cpu's process pool."""
    import torch

    from lapgnn_tpu_torch.solver.jv import DEVICE_COUNTS, SolveStats
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single

    n, case, seed, threads, given = job
    torch.set_num_threads(threads)
    st = SolveStats()
    arrays = _vs_cpu_case(n, case, seed) if given is None else given
    res = lapjv_seeded_single(*map(torch.from_numpy, arrays), gate="both", stats=st)
    return {"x": res.col_of_row, "y": res.row_of_col, "v": res.v,
            "used_fallback": bool(res.used_fallback),
            "counts": {k: getattr(st, k) for k in DEVICE_COUNTS}}


@contextlib.contextmanager
def _s1_staged():
    """The seeded solve's S1 in its staged layout, where the resident one
    would run."""
    import lapgnn_tpu_torch.solver.jv as jv_mod
    from lapgnn_tpu_torch.ops.cuda.augment import _augment

    def staged(C, x, y, v, counts):
        return _augment(C, x, y, v, counts, layout="staged")

    with _wrapped(jv_mod, "augment_sweep", lambda _: staged):
        yield


@contextlib.contextmanager
def _s2_global():
    """The seeded solve's S2 in its global layout, where the resident one
    would run."""
    import lapgnn_tpu_torch.solver.seeded as seeded_mod
    from lapgnn_tpu_torch.ops.cuda.arr import _arr

    def global_layout(C, x, y, v, max_rounds, min_delta, counts):
        return _arr(C, x, y, v, max_rounds, min_delta, counts, layout="global")

    with _wrapped(seeded_mod, "arr_auction", lambda _: global_layout):
        yield


@contextlib.contextmanager
def _plain_solver_loops():
    """The seeded solve's routers sent to S1-S3's plain versions: the eager
    loops, on the card."""
    import lapgnn_tpu_torch.solver.jv as jv_mod
    import lapgnn_tpu_torch.solver.seeded as seeded_mod
    from lapgnn_tpu_torch.ops.cuda.arr import arr_auction_plain
    from lapgnn_tpu_torch.ops.cuda.augment import augment_sweep_plain
    from lapgnn_tpu_torch.ops.cuda.greedy_match import greedy_match_plain

    with _wrapped(jv_mod, "augment_sweep", lambda _: augment_sweep_plain), \
            _wrapped(seeded_mod, "arr_auction", lambda _: arr_auction_plain), \
            _wrapped(seeded_mod, "greedy_match", lambda _: greedy_match_plain):
        yield


def _same_solve(torch, a, b):
    """Two solves' x, y, v (bits, every NaN one class), fallback flags and
    loop counts: the names of those that differ."""
    diff = [k for k in ("x", "y") if not torch.equal(a[k].cpu(), b[k].cpu())]
    va, vb = a["v"].cpu(), b["v"].cpu()
    nan = torch.isnan(va)
    bits = torch.int64 if va.dtype == torch.float64 else torch.int32
    if not (va.dtype == vb.dtype and torch.equal(nan, torch.isnan(vb))
            and torch.equal(va[~nan].view(bits), vb[~nan].view(bits))):
        diff.append("v")
    if a["used_fallback"] != b["used_fallback"]:
        diff.append("used_fallback")
    diff += [k for k in a["counts"] if a["counts"][k] != b["counts"][k]]
    return diff


def _augment_unstaged(torch, seed):
    """S1's unstaged layout (u, x and e read through L2) against its plain
    loop on the card, on the state a seeded solve of a uniform matrix hands
    S1, at each ``AUGMENT_UNSTAGED`` size: forced where the staged layout
    fits, and above float64's 11,622 columns, where the wrapper picks it.
    x, y, v and the counts bit for bit; each side's host-clock ms and the
    bound from this run's sweeps."""
    from lapgnn_tpu_torch.ops.cuda import augment as augment_mod
    from lapgnn_tpu_torch.ops.cuda._lib import sm_count
    from lapgnn_tpu_torch.ops.cuda.augment import _augment, augment_layout, augment_sweep_plain

    out = {}
    for n, dtype, forced in AUGMENT_UNSTAGED:
        dt = getattr(torch, dtype)
        C = _batch(torch, n, seed + 11 * n, fams=("uniform",))[0].to(dt)
        if (augment_layout(n, C.element_size(), sm_count(C.device)) != "unstaged") != forced:
            raise AssertionError(f"augment_unstaged: n = {n} {dtype} is not the case meant")
        _, start, after = _solver_inputs(torch, C)
        runs = {}
        for how in ("kernel", "plain"):
            counts = torch.zeros(3, dtype=torch.int64, device="cuda")
            torch.cuda.synchronize()
            since = _launches()
            t0 = time.perf_counter()
            if how == "kernel":
                got = (_augment(C, *after, counts, layout="unstaged") if forced
                       else augment_mod.augment_sweep(C, *after, counts))
            else:
                got = augment_sweep_plain(C, *after, counts)
            torch.cuda.synchronize()
            runs[how] = {"x": got[0], "y": got[1], "v": got[2], "used_fallback": False,
                         "counts": dict(zip(("aug_rounds", "sweeps", "flip_steps"),
                                            counts.tolist())),
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "launches": _launches(since)["augment_sweep"]}
        differ = _same_solve(torch, runs["kernel"], runs["plain"])
        if differ or runs["kernel"]["launches"] != 1:
            raise AssertionError(f"augment_unstaged n = {n} {dtype}: {differ}, "
                                 f"{runs['kernel']['launches']} launches")
        sweeps = runs["kernel"]["counts"]["sweeps"]
        bound, by, _ = _solver_bound_ms("augment_sweep", sweeps * n * n, n, C.element_size())
        out[f"{dtype}_{n}"] = {"forced": forced, "counts": runs["kernel"]["counts"],
                               "kernel_ms_host_clock": runs["kernel"]["ms"],
                               "plain_ms_host_clock": runs["plain"]["ms"],
                               "bound_ms": bound, "bound_by": by}
        if not forced:
            out[f"{dtype}_{n}"]["arr_layouts"] = _arr_layouts(torch, C, start)
        del C, start, after, runs
        torch.cuda.empty_cache()
    return out


def _arr_layouts(torch, C, start):
    """S2 on the state a seeded solve of C hands it, in each of its layouts
    against its plain loop on the card: x, y, v bit for bit and the rounds;
    each one's host-clock ms."""
    from lapgnn_tpu_torch.ops.cuda import arr as arr_mod

    n = C.shape[0]
    rounds = max(64, n // 32)
    runs = {}
    for how in ("plain", *arr_mod.LAYOUTS):
        counts = torch.zeros(1, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "plain":
            got = arr_mod.arr_auction_plain(C, *start, rounds, 0.0, counts)
        else:
            got = arr_mod._arr(C, *start, rounds, 0.0, counts, layout=how)
        torch.cuda.synchronize()
        runs[how] = {"x": got[0], "y": got[1], "v": got[2], "used_fallback": False,
                     "counts": {"arr_rounds": int(counts[0])},
                     "ms": (time.perf_counter() - t0) * 1e3}
    out = {"default_layout": arr_mod.arr_layout(n, C.element_size(),
                                                 torch.cuda.get_device_properties(0)
                                                 .multi_processor_count),
           "rounds": runs["plain"]["counts"]["arr_rounds"],
           "plain_ms_host_clock": runs["plain"]["ms"]}
    for layout in arr_mod.LAYOUTS:
        differ = _same_solve(torch, runs[layout], runs["plain"])
        if differ:
            raise AssertionError(f"arr {layout} layout n = {n} {C.dtype}: {differ}")
        out[f"{layout}_ms_host_clock"] = runs[layout]["ms"]
    return out


def phase_device_vs_cpu(torch, pipe, seed):
    """The port's seeded solver from the same matrix and seeds three ways: on
    the card through S1-S3, on the card through their plain versions (the
    eager loops), and on the CPU (a spawned pool, started first), at n in
    ``DEVICE_VS_CPU_N`` on ``VS_CPU_CASES`` (float32, min-trick seeds), and on
    ``VS_CPU_EXTRA``: float64 cases, and a float32 uniform one seeded by
    ``pipe.predict_duals``.  x, y, v bit for bit (every NaN one class), the
    fallback flag and every loop count must agree.  While the CPU solves,
    the card holds S1's unstaged layout against its plain loop
    (``_augment_unstaged``).  Returns the largest |v| difference between the
    kernels and the plain loops over the finite entries."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES
    from lapgnn_tpu_torch.solver.jv import DEVICE_COUNTS, SolveStats
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single

    t_phase = time.perf_counter()
    cases = [(n, c) for n in DEVICE_VS_CPU_N for c in VS_CPU_CASES] + list(VS_CPU_EXTRA)
    given = {}
    for n, case in VS_CPU_EXTRA:
        if case == "predicted":
            C = FAMILIES["uniform"](n, np.random.default_rng(seed + 6 + n)).astype(np.float32)
            u, v = pipe.predict_duals(torch.from_numpy(C).cuda()[None])
            given[(n, case)] = (C, u[0].cpu().numpy(), v[0].cpu().numpy())
    # two workers, so that the two longest (the poisoned cases at the
    # largest n, n + 1 rounds each) run side by side on half the cores each
    workers = 2
    threads = max(1, (os.cpu_count() or 1) // workers)
    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        # the largest first: the poisoned cases run n + 1 rounds
        order = sorted(cases, key=lambda nc: (-nc[0], nc[1] not in ("nan_row", "inf_row")))
        futures = {nc: pool.submit(_cpu_solve, (*nc, seed, threads, given.get(nc)))
                   for nc in order}
        report, on_card, err = {}, {}, 0.0
        since = _launches()
        for n, case in cases:
            arrays = given.get((n, case)) or _vs_cpu_case(n, case, seed)
            C, u, v = (torch.from_numpy(a).cuda() for a in arrays)
            runs = {}
            ways = ("kernels", "kernels_s1_staged", "plain") + (
                ("kernels_s2_global",) if n == S2_GLOBAL_N else ())
            for how in ways:
                st = SolveStats()
                with contextlib.ExitStack() as stack:
                    if how == "plain":
                        stack.enter_context(_plain_solver_loops())
                    elif how == "kernels_s1_staged":
                        stack.enter_context(_s1_staged())
                    elif how == "kernels_s2_global":
                        stack.enter_context(_s2_global())
                    with torch.inference_mode():
                        res = lapjv_seeded_single(C, u, v, gate="both", stats=st)
                    torch.cuda.synchronize()
                runs[how] = {"x": res.col_of_row, "y": res.row_of_col, "v": res.v,
                             "used_fallback": bool(res.used_fallback),
                             "counts": {k: getattr(st, k) for k in DEVICE_COUNTS},
                             "host_syncs": st.host_syncs}
            if runs["kernels"]["host_syncs"] != 0:
                raise AssertionError(f"{case} n={n}: the kernels' solve read back on the host")
            on_card[(n, case)] = runs["kernels"]
            fin = torch.isfinite(runs["plain"]["v"])
            if fin.any():
                err = max(err, float((runs["kernels"]["v"] - runs["plain"]["v"])[fin].abs().max()))
            report[f"{case}_{n}"] = {"kernels_vs_plain_differ": _same_solve(torch, runs["kernels"],
                                                                             runs["plain"]),
                                     "s1_staged_vs_plain_differ": _same_solve(
                                         torch, runs["kernels_s1_staged"], runs["plain"]),
                                     "s2_global_vs_plain_differ": _same_solve(
                                         torch, runs["kernels_s2_global"], runs["plain"])
                                     if "kernels_s2_global" in runs else [],
                                     "s1_layout": _s1_layout(n, C),
                                     "counts": runs["kernels"]["counts"],
                                     "used_fallback": runs["kernels"]["used_fallback"]}
        launches = _launches(since)
        unstaged = _augment_unstaged(torch, seed)
        for n, case in cases:
            report[f"{case}_{n}"]["card_vs_cpu_differ"] = _same_solve(
                torch, on_card[(n, case)], futures[(n, case)].result())
    finally:
        pool.shutdown(cancel_futures=True)
    bad = {k: r for k, r in report.items()
           if r["kernels_vs_plain_differ"] or r["s1_staged_vs_plain_differ"]
           or r["s2_global_vs_plain_differ"] or r["card_vs_cpu_differ"]}
    if bad:
        raise AssertionError(f"device_vs_cpu: the solves disagree: {bad}")
    for k in SOLVER_KERNELS:
        if launches[k] < len(cases) * (2 if k == "augment_sweep" else 1):
            raise AssertionError(f"device_vs_cpu: {k} launched {launches[k]} times")
    _emit({"phase": "device_vs_cpu", "n": list(DEVICE_VS_CPU_N), "cases": report,
           "augment_unstaged": unstaged, "cpu_workers": workers,
           "kernels_vs_plain_max_abs_err_v": err,
           "phase_seconds": time.perf_counter() - t_phase})
    return {"max_abs_err": err}


def phase_device_breakdown(torch, pipe, C_np):
    """Where one device solve's time goes (uniform, n = N_E2E): its stages
    by CUDA events (``SolveStats(timed=True)``), then one whole solve under
    torch.profiler for the device's idle share and each kernel's device
    time."""
    from lapgnn_tpu_torch.solver.jv import SolveStats
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single

    Ct = torch.from_numpy(C_np).cuda()
    u, v = pipe.predict_duals(Ct[None])

    def solve(stats):
        with torch.inference_mode():
            lapjv_seeded_single(Ct, u[0], v[0], eps=pipe.eps, gate=pipe.gate, stats=stats)

    solve(SolveStats())  # warm
    timed = SolveStats(timed=True)
    solve(timed)
    stage_ms = dict(timed.stage_ms)
    rows, wall_ms = _profile(torch, lambda: solve(SolveStats()))
    busy_ms = sum(r[0] for r in rows) / 1e3
    by_kernel = {name: sum(d for d, k, _ in rows if key in k) / 1e3
                 for name, key in (("augment_sweep", "augment_kernel"),
                                   ("arr_auction", "arr_kernel"),
                                   ("greedy_match", "greedy_match_kernel"))}
    _emit({
        "phase": "device_breakdown", "n": C_np.shape[-1],
        "stage_ms_cuda_events": stage_ms, "host_syncs": timed.host_syncs,
        "loops": {k: getattr(timed, k) for k in ("greedy_rounds", "arr_rounds", "aug_rounds",
                                                   "sweeps", "flip_steps")},
        "kernel_device_ms": by_kernel if rows else "not measured",
        "profiled_solve_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if rows else "not measured",
        "device_idle_share": (1.0 - busy_ms / wall_ms) if rows else "not measured",
        "top_kernels": [{"name": k[:80], "device_ms": d / 1e3, "count": c} for d, k, c in rows[:8]],
    })
    return {"stage_ms": stage_ms, "kernel_device_ms": by_kernel if rows else None,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if rows else None}


def _labelled(job):
    """(family, n, seed) -> the record of one labelled synthetic instance; a
    worker of the train phase's process pool."""
    import numpy as np

    from lapgnn_tpu_torch.data.synthetic import generate_synthetic_instance, instance_record

    fam, n, seed = job
    return instance_record(generate_synthetic_instance(fam, n, np.random.default_rng(seed)))


def _train_jobs(seed):
    """The train phase's instances, ``TRAIN_SIZES`` of them, the families
    taken in turn from ``FAMILIES``: (family, n, seed) jobs."""
    from lapgnn_tpu_torch.data.generators import FAMILIES

    fams = list(FAMILIES)
    return [(fams[i % len(fams)], n, seed * 1_000_003 + n * 101 + i)
            for n, train, val in TRAIN_SIZES for i in range(train + val)]


def _eval_jobs(seed):
    """The eval phase's instances: ``EVAL_PER_FAMILY`` of each family at
    ``EVAL_N``, grouped by family."""
    from lapgnn_tpu_torch.data.generators import FAMILIES

    return [(fam, EVAL_N, seed * 1_000_003 + 7_919 + EVAL_PER_FAMILY * k + i)
            for k, fam in enumerate(FAMILIES) for i in range(EVAL_PER_FAMILY)]


def _train_split(records):
    """The train phase's records in ``_train_jobs`` order -> {n: (train, val)}."""
    data, k = {}, 0
    for n, train, val in TRAIN_SIZES:
        data[n] = (records[k : k + train], records[k + train : k + train + val])
        k += train + val
    return data


def _label_async(jobs):
    """Start labelling (family, n, seed) jobs by SciPy in a pool of spawned
    processes (largest first).  Returns ``collect()``, which waits for them,
    shuts the pool down and returns (records in job order, seconds from the
    start, workers)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    workers = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    futures = {k: pool.submit(_labelled, jobs[k])
               for k in sorted(range(len(jobs)), key=lambda k: -jobs[k][1])}

    def collect():
        try:
            records = [futures[k].result() for k in range(len(jobs))]
        finally:
            pool.shutdown(cancel_futures=True)
        return records, time.perf_counter() - t0, workers

    return collect


def _tiled(torch, records, B):
    """A (B, n, n) cost and (B, n) dual batch on the card, the records
    repeated in turn."""
    import numpy as np

    pick = [records[i % len(records)] for i in range(B)]
    cost = np.stack([r["cost"] for r in pick]).astype(np.float32)
    u = np.stack([r["u"] for r in pick]).astype(np.float32)
    return torch.from_numpy(cost).cuda(), torch.from_numpy(u).cuda()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _train_model(torch, config, init, device, dropout=None):
    """OneGNN at the config's width on ``device`` with ``init``'s weights,
    and an optimizer over it."""
    from lapgnn_tpu_torch.train import trainer
    from lapgnn_tpu_torch.train.schedule import make_optimizer, warmup_cosine

    mc = config["model"]
    model = trainer.build_one_gnn(
        int(mc["hidden"]), int(mc["layers"]), float(mc["dropout"] if dropout is None else dropout),
        int(mc["topk"]), bool(mc.get("context", False)), 0, device)
    trainer.load_params(model, init)
    refine = bool(mc.get("use_cost_refinement", False))
    oc = config["optimizer"]
    opt = make_optimizer(trainer.trainable_parameters(model, refine),
                         warmup_cosine(float(oc["lr"]), 1, 100), float(oc["weight_decay"]),
                         float(oc["grad_clip"]))
    return model, opt, refine


@contextlib.contextmanager
def _wrapped(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` inside the block: how the
    train phase counts the real step's calls, cuts it at its stages and
    keeps what it hands the greedy kernel, without a copy of the step."""
    real = getattr(owner, name)
    own = name in vars(owner)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        if own:
            setattr(owner, name, real)
        else:
            delattr(owner, name)


def _eager_predicts():
    """``_wrapped`` for the predict's CUDA graphs: inside the block every
    ``graphs.GraphedCall`` runs eagerly, so that the kernel wrappers a phase
    replaces see every call (a replay runs no Python)."""
    from lapgnn_tpu_torch.graphs import GraphedCall

    return _wrapped(GraphedCall, "__call__", lambda real: GraphedCall.eager)


def _capture(calls, clone=False):
    """For ``_wrapped``: keep each call's arguments and result in ``calls``
    (a copy of the result with ``clone``, safe from later in-place use)."""
    def make(real):
        def run(*args, **kwargs):
            out = real(*args, **kwargs)
            calls.append((args, out.clone() if clone else out))
            return out

        return run

    return make


def _capture_pair(calls):
    """``_capture`` for a wrapper that returns a pair of tensors (copies)."""
    def make(real):
        def run(*args, **kwargs):
            out = real(*args, **kwargs)
            calls.append((args, tuple(t.clone() for t in out)))
            return out

        return run

    return make


def _stage_ms(torch, step, model, opt, cost, u, gen, owner=None, features="row_features",
              loss="one_gnn_loss"):
    """One call of the real train step ``step`` cut at its stages by CUDA
    events recorded around the functions it calls, looked up in ``owner``
    (the OneGNN trainer's module unless given): normalisation and features
    (up to ``features``' return), forward, loss (``loss``, with the greedy
    kernel), backward (up to the optimizer's step), optimizer."""
    if owner is None:
        from lapgnn_tpu_torch.train import trainer as owner

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]

    def marks(after, before=None):
        def make(real):
            def run(*args, **kwargs):
                if before is not None:
                    ev[before].record()
                out = real(*args, **kwargs)
                ev[after].record()
                return out

            return run

        return make

    with _wrapped(owner, features, marks(1)), _wrapped(model, "forward", marks(2)), \
            _wrapped(owner, loss, marks(3)), _wrapped(opt, "step", marks(5, before=4)):
        ev[0].record()
        step(cost, u, gen)
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]


def _counting(record):
    """For ``_wrapped`` around a step factory: every step it makes appends
    (its batch's shape, its output) to ``record`` when called; the output
    stays a device tensor, so counting adds no sync."""
    def make(real):
        def made(*a, **k):
            step = real(*a, **k)

            def counted(cost, *rest):
                out = step(cost, *rest)
                record.append((tuple(cost.shape), out))
                return out

            return counted

        return made

    return make


def _greedy_against_plain(torch, args, got, what, flush, no_flush):
    """The greedy kernel's result ``got`` on ``args`` (red, cost, order,
    valid), as a training step handed them, held bit for bit to its plain
    loop; then the kernel's time (L2 flushed), the loop's time and launches,
    the bytes bound and the serial floor (one instance, L2 left warm)."""
    from lapgnn_tpu_torch.ops.cuda import greedy_total
    from lapgnn_tpu_torch.ops.cuda.greedy import greedy_total_plain

    red, c_n, order, valid = args
    B, n = red.shape[0], red.shape[1]
    bound, by = _bound_ms("greedy_total", B, n, red.shape[2])
    t0 = time.perf_counter()
    want = greedy_total_plain(red, c_n, order, valid)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"greedy kernel differs from its plain loop in {what}")
    rows, _ = _profile(torch, lambda: greedy_total_plain(red, c_n, order, valid))
    return {
        "batch": B, "n": n, "bit_equal": True, "max_abs_err": _max_abs_err(torch, got, want),
        "ms": _time_ms(torch, lambda: greedy_total(red, c_n, order, valid), 5, flush),
        "plain_ms": plain_ms,
        "plain_launches": sum(r[2] for r in rows) if rows else "not measured",
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "serial_floor_ms": _time_ms(
            torch, lambda: greedy_total(red[:1], c_n[:1], order[:1],
                                        None if valid is None else valid[:1]), 5, no_flush),
    }


def phase_train(torch, seed, train_data=None):
    """The OneGNN training path on the card: ``train_progressive`` with
    one_gnn_default's own config (hidden 192, 4 layers, top-k 16, cost
    refinement, normalised costs and gap), warm-started from its weights,
    one epoch over labelled synthetic instances at n = 512 / 1024 / 2048;
    then the trained checkpoint served to a certified optimum, one step on
    the card against the CPU, and the step's times.  ``train_data`` is
    ({n: (train, val)}, seconds, workers), labelled while an earlier phase
    ran; without it the phase labels its own."""
    import copy
    import math
    import tempfile

    import numpy as np

    from lapgnn_tpu_torch.ops.cuda import greedy_total
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.train import loss as loss_mod
    from lapgnn_tpu_torch.train import progressive, trainer
    from lapgnn_tpu_torch.train.checkpoint import build_model_from_meta, load_checkpoint

    t_phase = time.perf_counter()
    overlapped = train_data is not None
    if not overlapped:
        records, data_s, workers = _label_async(_train_jobs(seed))()
        train_data = (_train_split(records), data_s, workers)
    data, data_s, workers = train_data
    init, meta, _ = load_checkpoint(CHECKPOINT)
    config = copy.deepcopy(meta["config"])
    config["training"]["epochs"] = 1
    specs = [progressive.DatasetSpec(f"synthetic_{n}", n, tr, val_instances=va or None)
             for n, (tr, va) in data.items()]
    flags = (bool(config["model"].get("use_cost_refinement", False)),
             bool(config["loss"].get("normalize_gap", False)),
             bool(config["loss"].get("normalize_costs", False)))

    # count the steps and keep each step's batch shape and loss (a device
    # tensor: no sync), not its batch, which would add to the peak memory
    steps, evals = [], []
    logs = []
    with tempfile.TemporaryDirectory() as tmp:
        config["checkpointing"]["output_dir"] = tmp
        with _wrapped(progressive, "make_train_step", _counting(steps)), \
                _wrapped(progressive, "make_eval_step", _counting(evals)):
            since = _launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, history = progressive.train_progressive(config, specs, init_params=init,
                                                       log_fn=logs.append)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = _launches(since)
        out_dir = Path(tmp)
        for d in ("best", "last"):
            if not (out_dir / d / "params.msgpack").exists() or not (out_dir / d / "meta.json").exists():
                raise AssertionError(f"train_progressive wrote no {d}/ checkpoint")
        trained, trained_meta, opt_state = load_checkpoint(out_dir / "last", with_opt_state=True)

    warm = logs[0].split()
    loaded, total = (int(x) for x in warm[2].split("/"))
    if warm[:2] != ["warm", "init:"] or loaded != total or total != len(_flat(init)):
        raise AssertionError(f"warm start did not restore every leaf: {logs[0]!r}")
    losses = [float(m["loss"]) for _, m in steps]
    if not steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a train step's loss is not finite: {losses}")
    moved = sum(not np.array_equal(a, _flat(init)[k]) for k, a in _flat(trained).items())
    if moved == 0:
        raise AssertionError("training left every parameter where it started")
    if launches["greedy_total"] != len(steps) + len(evals):
        raise AssertionError(
            f"greedy kernel launched {launches['greedy_total']} times for {len(steps)} "
            f"train steps and {len(evals)} validation batches")
    if opt_state is None or opt_state["count"] != len(steps):
        raise AssertionError("last/ holds no optimizer state of this run")

    # serve what was trained: one uniform n = N_E2E instance, default device mode
    C = _e2e_costs(seed + 1)["uniform"]
    pipe = WarmStartPipeline(build_model_from_meta(trained_meta), trained, certify_tol=CERTIFY_TOL)
    if pipe.mode != "device" or pipe.device.type != "cuda":
        raise AssertionError("the default pipeline is not the device mode on the card")
    t0 = time.perf_counter()
    out = pipe.solve(C, certify=True)
    serve_ms = (time.perf_counter() - t0) * 1e3
    opt = _scipy_opt(C.astype(np.float64))
    if not out["certified"].all() or not abs(float(out["cost"][0]) - opt) <= 1e-12 * max(1.0, abs(opt)):
        raise AssertionError(f"the trained model's solve: {out['cost']} certified "
                             f"{out['certified']} against SciPy {opt!r}")
    serve = {"n": N_E2E, "cost": float(out["cost"][0]), "scipy": opt, "certified": True,
             "route": ("polish" if out["polished"][0] else "repair" if out["repaired"][0] else "raw"),
             "solve_ms_host_clock": serve_ms}

    # one step on the card against the CPU: the smallest n, B = 4, dropout 0
    n_small = TRAIN_SIZES[0][0]
    cost, u = _tiled(torch, data[n_small][0], 4)
    grads, vals, calls = {}, {}, []
    for dev in ("cuda", "cpu"):
        model, opt_, refine = _train_model(torch, config, init, dev, dropout=0.0)
        named = [k for k, _ in model.named_parameters()
                 if refine or not k.startswith(("edge_mlp.", "message_norm."))]
        with _wrapped(loss_mod, "greedy_total", _capture(calls)):
            loss, _, g = trainer.loss_and_grads(model, opt_.params, cost.to(dev), u.to(dev),
                                                refine, flags[1], True, flags[2])
        vals[dev] = float(loss.detach())
        grads[dev] = {k: x.detach().cpu() for k, x in zip(named, g)}
    rel = abs(vals["cuda"] - vals["cpu"]) / abs(vals["cpu"])
    g_max = max(float(x.abs().max()) for x in grads["cpu"].values())
    g_err = max(float((grads["cuda"][k] - grads["cpu"][k]).abs().max()) for k in grads["cpu"])
    if rel > 1e-5 or g_err > 1e-4 * g_max + 1e-7:
        raise AssertionError(f"card against CPU: loss rel {rel}, gradient err {g_err} (max |g| {g_max})")
    # the CPU step's greedy arguments through the kernel on the card
    cpu_args, gb_cpu = calls[-1]
    gb_card = greedy_total(*(None if a is None else a.cuda() for a in cpu_args)).cpu()
    del calls, cpu_args
    if not torch.equal(gb_card.view(torch.int32), gb_cpu.view(torch.int32)):
        raise AssertionError("greedy bound on the card differs from the CPU's")
    card_vs_cpu = {"batch": 4, "n": n_small, "loss_rel_err": rel, "grad_max_abs_err": g_err,
                   "grad_tol": 1e-4 * g_max + 1e-7, "greedy_bound_bit_equal": True}

    # times: a step, its stages; the greedy kernel against its plain loop on
    # the arguments the step hands it, bit for bit
    model, opt_, refine = _train_model(torch, config, init, "cuda")
    step = trainer.make_train_step(model, opt_, refine, flags[1], True, flags[2])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    no_flush = torch.empty(1, dtype=torch.float32, device="cuda")
    step_ms, stage_ms, greedy = {}, {}, {}
    stage_names = ("features", "forward", "loss_with_greedy", "backward", "optimizer")
    peak, greedy_err = None, 0.0
    for B, n in TRAIN_TIMED:
        key = f"{B}x{n}"
        cost, u = _tiled(torch, data[n][0], B)
        step(cost, u, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms[key] = _ms_host(torch, lambda: step(cost, u, gen), 3)
        if (B, n) == TRAIN_TIMED[-1]:
            peak = torch.cuda.max_memory_allocated()
        cuts = [_stage_ms(torch, step, model, opt_, cost, u, gen) for _ in range(3)]
        stage_ms[key] = {name: statistics.median(c[i] for c in cuts)
                         for i, name in enumerate(stage_names)}
        calls = []
        with _wrapped(loss_mod, "greedy_total", _capture(calls)):
            step(cost, u, gen)
        greedy[key] = _greedy_against_plain(torch, *calls[0], f"the step at {key}", flush,
                                            no_flush)
        greedy_err = max(greedy_err, greedy[key]["max_abs_err"])
        del cost, u, calls
        torch.cuda.empty_cache()

    report = {
        "phase": "train", "config_width": {k: config["model"][k] for k in ("hidden", "layers", "topk")},
        "data_seconds": data_s, "data_workers": workers, "data_labelled_during_compare": overlapped,
        "instances": {n: [len(tr), len(va)] for n, (tr, va) in data.items()},
        "train_seconds": train_s, "steps": len(steps),
        "step_shapes": [list(sh) for sh, _ in steps], "validation_batches": len(evals),
        "step_losses": losses, "history": history, "log": logs,
        "leaves_moved": moved, "launches": launches, "serve": serve, "card_vs_cpu": card_vs_cpu,
        "step_ms_host_clock": step_ms, "stage_ms": stage_ms,
        "max_memory_allocated_bytes": {f"{TRAIN_TIMED[-1][0]}x{TRAIN_TIMED[-1][1]}": peak},
        "greedy": greedy,
        "greedy_launches_per_train_step": (launches["greedy_total"] - len(evals)) / len(steps),
        "phase_seconds": time.perf_counter() - t_phase,
    }
    _emit(report)
    last = f"{TRAIN_TIMED[-1][0]}x{TRAIN_TIMED[-1][1]}"
    return {"launches": launches["greedy_total"], **greedy[last], "max_abs_err": greedy_err,
            **{f"at_{k}": v for k, v in greedy.items() if k != last}}


def _event_ms(torch, fn, reps):
    """Median CUDA-event ms of ``fn`` over ``reps`` runs after one warm-up
    (for work of a millisecond and more: no L2 flush, no queueing)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _dual_forward_bound_ms(n, hidden, layers, n_params, folded_heads=None):
    """Least time of one DualGNN forward at batch 1: its matrix-product
    FLOPs over the float32 rate against its bytes (edge features, node
    features and weights read once, u and v_hint written once) over the HBM
    rate.  FLOPs a layer: the edge MLP 2·n²·(10·128 + 128·128 + 128·hidden),
    the two edge terms and the two attention messages 8·n²·hidden, the four
    node projections and the two updates 16·n·hidden²; the encoders
    4·n·14·hidden.  With ``folded_heads`` (the inference forward, whose
    kernel folds fc3 into the edge terms) the edge MLP and the edge terms
    are 2·n²·(10·128 + 128·128 + 128·2·heads) and the messages 4·n²·hidden.
    Elementwise work (GELU, softmax, LayerNorm) is not counted."""
    if folded_heads is None:
        per_layer = 2 * n * n * (10 * 128 + 128 * 128 + 128 * hidden) + 8 * n * n * hidden
    else:
        per_layer = (2 * n * n * (10 * 128 + 128 * 128 + 128 * 2 * folded_heads)
                     + 4 * n * n * hidden)
    flops = layers * (per_layer + 16 * n * hidden * hidden) + 4 * n * 14 * hidden
    nbytes = 4 * (n * n * 10 + 2 * n * 14 + n_params + 2 * n)
    t_ops = flops / F32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def phase_eval(torch, seed, records=None):
    """The evaluation path on the card: the accuracy ladder
    (``cli.accuracy_ladder.ladder``, which runs ``evaluation.evaluate_pipeline``
    a family and model) of OneGNN (``artifacts/one_gnn_default``,
    ``WarmStartPipeline(mode="hybrid", seed_mode="auto")``) against DualGNN
    (``artifacts/dual_gnn_r5`` at its full width, ``DualGNNPredictor``,
    seed mode 'auto') on ``EVAL_PER_FAMILY`` labelled instances of each
    family at n = ``EVAL_N``, each kernel's every call there held against
    its plain version on the same arguments (the predicts run eagerly
    there, ``_eager_predicts``, so every call is seen); the timing branch on 2 uniform
    instances; the card against the CPU on one instance; then
    ``graph_features`` and the forward timed at ``EVAL_TIMED_N`` beside the
    forward's bound.  ``records`` are the labelled instances in
    ``_eval_jobs`` order, made while an earlier phase ran; without them the
    phase labels its own.  Returns the ladder's launch counts and each
    kernel's largest difference from its plain version there."""
    import math

    import numpy as np

    import lapgnn_tpu_torch.ops.cuda as cuda_ops
    import lapgnn_tpu_torch.ops.cuda.features as cuda_features
    import lapgnn_tpu_torch.ops.dual as dual_mod
    import lapgnn_tpu_torch.ops.features as features_mod
    import lapgnn_tpu_torch.train.loss as loss_mod
    from lapgnn_tpu_torch.cli.accuracy_ladder import group_by_family, ladder
    from lapgnn_tpu_torch.data.generators import FAMILIES
    from lapgnn_tpu_torch.evaluation import DualGNNPredictor, evaluate_pipeline
    from lapgnn_tpu_torch.ops.cuda.greedy import greedy_total_plain
    from lapgnn_tpu_torch.ops.dual import min_trick_v
    from lapgnn_tpu_torch.ops.features import graph_features
    from lapgnn_tpu_torch.ops.sinkhorn import auto_select_seed
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint, params_from_flax

    label_s = None
    if records is None:
        records, label_s, _ = _label_async(_eval_jobs(seed))()
    t_phase = time.perf_counter()
    dparams, dmeta, _ = load_checkpoint(DUAL_CHECKPOINT)
    oparams, ometa, _ = load_checkpoint(CHECKPOINT)
    models = {
        "one_gnn": WarmStartPipeline(
            build_model_from_meta(ometa), oparams, mode="hybrid",
            use_cost_refinement=bool(ometa.get("use_cost_refinement", True)), seed_mode="auto"),
        "dual_gnn": DualGNNPredictor(build_model_from_meta(dmeta), dparams, seed_mode="auto"),
    }
    dual_model = models["dual_gnn"].model
    by_family = group_by_family(records, EVAL_PER_FAMILY)
    n_inst = sum(len(v) for v in by_family.values())
    n_sentinel = sum(1 for r in records if (np.asarray(r["cost"]) >= 0.5e6).any())
    warm = records[0]["cost"].astype(np.float32)[None]
    for pipe in models.values():  # first use: cuBLAS, the kernels' libraries
        pipe.predict_duals(warm)
    torch.cuda.synchronize()

    # the ladder, counted: every (model, family) through evaluate_pipeline,
    # each kernel's arguments and result kept where the path calls it
    seen = {k: [] for k in ("col_min", "min_trick", "row_features_stats", "greedy_total",
                            "sinkhorn_ladder")}
    since = _launches()
    result, ms_per_instance = {}, {}
    with _eager_predicts(), \
            _wrapped(cuda_ops, "sinkhorn_ladder", _capture_pair(seen["sinkhorn_ladder"])), \
            _wrapped(cuda_features, "col_min", _capture(seen["col_min"], clone=True)), \
            _wrapped(dual_mod, "min_trick", _capture(seen["min_trick"], clone=True)), \
            _wrapped(features_mod, "row_features_stats",
                     _capture(seen["row_features_stats"], clone=True)), \
            _wrapped(loss_mod, "greedy_total", _capture(seen["greedy_total"], clone=True)):
        for name, pipe in models.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result.update(ladder({name: pipe}, by_family))
            torch.cuda.synchronize()
            ms_per_instance[name] = (time.perf_counter() - t0) * 1e3 / n_inst
    launches = _launches(since)
    want = {"row_features_stats": n_inst, "col_min": n_inst, "min_trick": 2 * n_inst,
            "greedy_total": 2 * (n_inst + n_sentinel), "sinkhorn_ladder": 2 * n_inst}
    if any(launches[k] < v for k, v in want.items()):
        raise AssertionError(f"the evaluation path skipped a kernel: launches {launches}, "
                             f"at least {want}")

    # every kernel call of the ladder against its plain version on the same
    # arguments: K1 and K2 bit for bit, K3 within K3_RTOL / K3_ATOL with its
    # selection channels bit-equal, the greedy bound bit for bit
    errs = {k: 0.0 for k in seen}
    for k, calls in seen.items():
        for i, (args, got) in enumerate(calls):
            what = f"eval ladder, call {i} of {len(calls)}, shape {tuple(args[0].shape)}"
            if k in ("col_min", "min_trick"):
                e, _, _ = _hold_colmin(torch, k, got,
                                       _colmin_want(torch, args[0], args[1] if k == "min_trick" else None),
                                       what)
            elif k == "row_features_stats":
                e = _hold_k3(torch, got, args[0], what, finite=bool(torch.isfinite(args[0]).all()))
            elif k == "sinkhorn_ladder":
                e = _hold_sinkhorn(torch, args, got, what)
            else:
                plain = greedy_total_plain(*args)
                if not torch.equal(got.view(torch.int32), plain.view(torch.int32)):
                    raise AssertionError(f"greedy kernel differs from its plain loop ({what})")
                e = _max_abs_err(torch, got, plain)
            errs[k] = max(errs[k], e)
    against_plain = {k: {"calls": len(calls), "shapes": sorted({tuple(a[0].shape) for a, _ in calls}),
                         "max_abs_err": errs[k]} for k, calls in seen.items()}
    if any(len(calls) < want[k] for k, calls in seen.items()):
        raise AssertionError(f"the ladder's kernel calls were not all seen: {against_plain}")
    del seen

    for name, r in result.items():
        for fam, m in r["per_family"].items():
            vals = [x for v in m.values() for x in (v if isinstance(v, list) else [v])]
            if not all(math.isfinite(float(x)) for x in vals):
                raise AssertionError(f"{name} {fam}: a metric is not finite: {m}")
            if m["feasible_rate"] != 1.0 or m["assist_rate"] != 1.0:
                raise AssertionError(f"{name} {fam}: feasible {m['feasible_rate']}, "
                                     f"assisted {m['assist_rate']}")
            row = {k: m[k] for k in ("num_instances", "u_mae_gauge", "presolve_gap_clipped_median",
                                     "presolve_gap_clipped_iqr", "feasible_rate", "assist_rate",
                                     "fallback_rate", "rank1_seed_win_rate")}
            if name == "dual_gnn":
                row["published_r5_clipped_gap_median"] = PUBLISHED_R5_CLIPPED_GAP_MEDIAN.get(fam)
            _emit({"phase": "eval_ladder", "model": name, "family": fam, "n": EVAL_N, **row})

    # the timing branch: host clocks of the native cold and seeded solves
    timed = evaluate_pipeline(models["one_gnn"], by_family["uniform"][:2],
                              time_solvers=True, repeats=3)
    speedup = {k: timed[k] for k in ("seeded_vs_cold_speedup_mean", "seeded_vs_cold_speedup_median")}
    if not all(math.isfinite(v) and v > 0 for v in speedup.values()):
        raise AssertionError(f"timing branch: {speedup}")

    # the card against the CPU on one instance: features, then the forward
    C = torch.from_numpy(by_family["uniform"][0]["cost"].astype(np.float32))[None]
    cpu_model = build_model_from_meta(dmeta)
    cpu_model.load_state_dict(params_from_flax(dparams))
    cpu_model.eval()
    with torch.inference_mode():
        g_card = graph_features(C.cuda())
        g_cpu = graph_features(C)
        out_card = dual_model(g_card.edge_feat, g_card.row_feat, g_card.col_feat)
        out_cpu = cpu_model(g_cpu.edge_feat, g_cpu.row_feat, g_cpu.col_feat)
    edge_card = g_card.edge_feat.cpu()
    exact = {ch: torch.equal(edge_card[..., ch], g_cpu.edge_feat[..., ch]) for ch in range(1, 7)}
    if not all(exact.values()):
        raise AssertionError(f"graph_features: rank / gap / tie channels differ: {exact}")
    feat_err = {name: float((a.cpu() - b).abs().max()) for name, a, b in
                zip(("row_feat", "col_feat", "edge_feat"), g_card, g_cpu)}
    card_vs_cpu = {"rank_gap_tie_bit_equal": True, "feature_max_abs_err": feat_err}
    for k in ("u", "v_hint"):
        ref = out_cpu[k]
        err = float((out_card[k].cpu() - ref).abs().max())
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        if not err <= tol:
            raise AssertionError(f"dual_gnn_r5 {k}: card and CPU {err} apart (tolerance {tol})")
        card_vs_cpu[f"{k}_max_abs_err"] = err
        card_vs_cpu[f"{k}_tolerance"] = tol
    del cpu_model, g_cpu, out_cpu

    # times and memory at batch 1
    n_params = sum(p.numel() for p in dual_model.parameters())
    rng = np.random.default_rng(seed + 77)
    times = {}
    for n in EVAL_TIMED_N:
        Cn = torch.from_numpy(FAMILIES["uniform"](n, rng).astype(np.float32)).cuda()[None]
        with torch.inference_mode():
            feats_ms = _event_ms(torch, lambda: graph_features(Cn), reps=5)
            gf = graph_features(Cn)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            fwd_ms = _event_ms(torch, lambda: dual_model(gf.edge_feat, gf.row_feat, gf.col_feat),
                               reps=3)
            peak = torch.cuda.max_memory_allocated()
        bound, by, flops = _dual_forward_bound_ms(n, dual_model.hidden_dim, dual_model.num_layers,
                                                  n_params, folded_heads=dual_model.heads)
        times[n] = {"graph_features_ms": feats_ms, "forward_ms": fwd_ms, "forward_bound_ms": bound,
                    "forward_bound_by": by, "forward_flops": flops,
                    "forward_tflops_per_s": flops / fwd_ms / 1e9,
                    "forward_max_memory_allocated_bytes": peak,
                    "memory_allocated_before_forward_bytes": before}
        del Cn, gf
        torch.cuda.empty_cache()
    # where an evaluated instance's time goes, a family at a time: one
    # instance through evaluate_pipeline and through predict_duals alone
    per_family_ms = {name: {} for name in models}
    for fam, insts in sorted(by_family.items()):
        Cf = torch.from_numpy(insts[0]["cost"].astype(np.float32)).cuda()[None]
        for name, pipe in models.items():
            eval_ms = _ms_host(torch, lambda p=pipe: evaluate_pipeline(p, insts[:1], time_solvers=False), 3)
            pred_ms = _ms_host(torch, lambda p=pipe: p.predict_duals(Cf), 3)
            per_family_ms[name][fam] = {"evaluate_one_ms": eval_ms, "predict_ms": pred_ms}
        del Cf

    # one predict of each model at EVAL_N (host clock) and the DualGNN
    # predict's seed policy alone (events), beside the stage times above
    Cp = torch.from_numpy(by_family["uniform"][0]["cost"].astype(np.float32)).cuda()[None]
    predict_ms = {name: _ms_host(torch, lambda p=pipe: p.predict_duals(Cp), 5)
                  for name, pipe in models.items()}
    with torch.inference_mode():
        gf = graph_features(Cp)
        u = dual_model(gf.edge_feat, gf.row_feat, gf.col_feat)["u"]
        policy_ms = _event_ms(torch, lambda: auto_select_seed(Cp, u, min_trick=min_trick_v), 5)
    del Cp, gf, u
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    report = {
        "phase": "eval", "n": EVAL_N, "instances": n_inst, "sentinel_instances": n_sentinel,
        "dual_gnn_width": {"hidden": dual_model.hidden_dim, "layers": dual_model.num_layers,
                           "heads": dual_model.heads, "parameters": n_params},
        "launches": launches, "launches_phase": _launches(since),
        "kernels_against_plain_on_the_ladder": against_plain,
        "overall": {name: r["overall"] for name, r in result.items()},
        "ms_per_instance_host_clock": ms_per_instance,
        "timing_branch": {"model": "one_gnn", "instances": 2, "repeats": 3,
                          "host_clock": True, **speedup},
        "card_vs_cpu": card_vs_cpu, "times": times,
        "predict_ms_host_clock": predict_ms, "dual_gnn_seed_policy_auto_ms": policy_ms,
        "per_family_ms_host_clock": per_family_ms,
        "labelling_seconds": label_s, "phase_seconds": phase_s,
    }
    _emit(report)
    if phase_s > EVAL_PHASE_LIMIT_S:
        raise AssertionError(f"the eval phase took {phase_s:.1f} s, above {EVAL_PHASE_LIMIT_S} s")
    return {"launches": launches, "max_abs_err": errs}


def phase_dual_train(torch, seed, train_data=None):
    """The DualGNN training path on the card: ``train_dual_gnn`` at
    dual_gnn_r5's full width and schedule (hidden 256, 6 layers, 4 heads,
    dropout 0.1, lr 1e-3, batch 4, the sentinel-clipped, normalised and
    supervised loss), warm-started from r5's weights, one epoch over the
    train phase's n = 512 records (32 train: 8 steps; 8 val: 2 batches),
    every greedy call held bit for bit to its plain loop; the trained
    checkpoint saved with the CLI's meta, rebuilt from it and served on one
    n = 512 instance; one step on the card against the CPU at (2, 64); the
    step's time, stages, peak memory and idle share at (4, 512) and
    (2, 1024).  ``train_data`` is the train phase's ({n: (train, val)}, ...),
    labelled while an earlier phase ran; without it the phase labels its
    own.  Returns the launch counts of the training run and the greedy
    kernel's largest difference from its plain loop there."""
    import math
    import tempfile

    import numpy as np

    import lapgnn_tpu_torch.train.loss as loss_mod
    from lapgnn_tpu_torch.cli import train_dual_gnn as cli
    from lapgnn_tpu_torch.data.synthetic import generate_synthetic_instance, instance_record
    from lapgnn_tpu_torch.evaluation import DualGNNPredictor, evaluate_pipeline
    from lapgnn_tpu_torch.ops.cuda import greedy_total
    from lapgnn_tpu_torch.ops.cuda.greedy import greedy_total_plain
    from lapgnn_tpu_torch.train import dual_trainer
    from lapgnn_tpu_torch.train.checkpoint import (build_model_from_meta, load_checkpoint,
                                                   save_checkpoint)
    from lapgnn_tpu_torch.train.convert import params_from_flax
    from lapgnn_tpu_torch.train.schedule import make_optimizer, warmup_cosine

    if train_data is None:
        records, _, _ = _label_async(_train_jobs(seed))()
        train_data = (_train_split(records), None, None)
    data = train_data[0]
    t_phase = time.perf_counter()
    init, meta, _ = load_checkpoint(DUAL_CHECKPOINT)
    train, val = data[EVAL_N]
    cfg = dual_trainer.DualTrainConfig(
        hidden=int(meta["hidden"]), layers=int(meta["layers"]), heads=int(meta["heads"]),
        dropout=float(meta["dropout"]), lr=DUAL_TRAIN_LR, epochs=1, batch_size=DUAL_TRAIN_BATCH,
        seed=seed)

    # one epoch, counted: the steps and validation batches (their outputs
    # stay device tensors) and every greedy call's arguments and result
    steps, evals, greedy_calls, logs = [], [], [], []
    with _wrapped(dual_trainer, "make_dual_train_step", _counting(steps)), \
            _wrapped(dual_trainer, "make_dual_eval_step", _counting(evals)), \
            _wrapped(loss_mod, "greedy_total", _capture(greedy_calls, clone=True)):
        since = _launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best, history = dual_trainer.train_dual_gnn(train, val, cfg, log_fn=logs.append,
                                                    init_params=init)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = _launches(since)

    warm = logs[0].split()
    loaded, total = (int(x) for x in warm[2].split("/"))
    if warm[:2] != ["warm", "init:"] or loaded != total or total != len(_flat(init)):
        raise AssertionError(f"warm start did not restore every leaf: {logs[0]!r}")
    losses = [float(m["loss"]) for _, m in steps]
    if len(steps) != -(-len(train) // DUAL_TRAIN_BATCH) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train steps {len(steps)}, losses {losses}")
    moved = sum(not np.array_equal(a, _flat(init)[k]) for k, a in _flat(best).items())
    if moved == 0:
        raise AssertionError("training left every parameter where it started")
    if not all(math.isfinite(g) for g in history["val_gap_median"]) or not history["val_gap_median"]:
        raise AssertionError(f"validation gap median: {history['val_gap_median']}")
    if launches["greedy_total"] != len(steps) + len(evals) or len(greedy_calls) != len(steps) + len(evals):
        raise AssertionError(f"greedy kernel launched {launches['greedy_total']} times "
                             f"({len(greedy_calls)} calls seen) for {len(steps)} train steps "
                             f"and {len(evals)} validation batches")
    greedy_err = 0.0
    for i, (args, got) in enumerate(greedy_calls):
        plain = greedy_total_plain(*args)
        if not torch.equal(got.view(torch.int32), plain.view(torch.int32)):
            raise AssertionError(f"greedy kernel differs from its plain loop (dual_train call {i})")
        greedy_err = max(greedy_err, _max_abs_err(torch, got, plain))
    greedy_shapes = sorted({tuple(a[0].shape) for a, _ in greedy_calls})
    first_greedy = greedy_calls[0]
    del greedy_calls

    # the checkpoint the CLI would write, rebuilt from its meta and served
    args = cli.build_parser().parse_args(
        ["--train", "-", "--output", "-", "--hidden", str(cfg.hidden), "--layers", str(cfg.layers),
         "--heads", str(cfg.heads), "--dropout", str(cfg.dropout), "--lr", str(cfg.lr),
         "--batch-size", str(cfg.batch_size), "--epochs", str(cfg.epochs)])
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, best, cli.checkpoint_meta(args, history))
        params, saved_meta, _ = load_checkpoint(tmp)
    if any(not np.array_equal(a, _flat(best)[k]) for k, a in _flat(params).items()):
        raise AssertionError("the saved checkpoint does not read back as trained")
    served = evaluate_pipeline(
        DualGNNPredictor(build_model_from_meta(saved_meta), params, seed_mode="auto"),
        val[:1], time_solvers=False)
    if served["feasible_rate"] != 1.0 or served["assist_rate"] != 1.0:
        raise AssertionError(f"the trained DualGNN served: {served}")
    serve = {k: served[k] for k in ("feasible_rate", "assist_rate", "fallback_rate",
                                    "presolve_gap_clipped_median")}

    # one step on the card against the CPU, r5's weights, dropout 0
    B, n = DUAL_VS_CPU
    rng = np.random.default_rng(seed + 64)
    small = [instance_record(generate_synthetic_instance(f, n, rng)) for f in ("uniform", "block")][:B]
    cost = torch.from_numpy(np.stack([r["cost"] for r in small]).astype(np.float32))
    u = torch.from_numpy(np.stack([r["u"] for r in small]).astype(np.float32))
    grads, vals, calls = {}, {}, []
    for dev in ("cuda", "cpu"):
        model = build_model_from_meta({**meta, "dropout": 0.0})
        model.load_state_dict(params_from_flax(init))
        model.to(dev)
        names = [k for k, _ in model.named_parameters()]
        with _wrapped(loss_mod, "greedy_total", _capture(calls)):
            loss, _, g = dual_trainer.dual_loss_and_grads(model, list(model.parameters()),
                                                          cost.to(dev), u.to(dev))
        vals[dev] = float(loss.detach())
        grads[dev] = {k: x.detach().cpu() for k, x in zip(names, g)}
    rel = abs(vals["cuda"] - vals["cpu"]) / abs(vals["cpu"])
    g_max = max(float(x.abs().max()) for x in grads["cpu"].values())
    g_err = max(float((grads["cuda"][k] - grads["cpu"][k]).abs().max()) for k in grads["cpu"])
    if rel > 1e-5 or g_err > 1e-4 * g_max + 1e-7:
        raise AssertionError(f"card against CPU: loss rel {rel}, gradient err {g_err} (max |g| {g_max})")
    cpu_args, gb_cpu = calls[-1]
    gb_card = greedy_total(*(None if a is None else a.cuda() for a in cpu_args)).cpu()
    if not torch.equal(gb_card.view(torch.int32), gb_cpu.view(torch.int32)):
        raise AssertionError("greedy bound on the card differs from the CPU's")
    card_vs_cpu = {"batch": B, "n": n, "loss_rel_err": rel, "grad_max_abs_err": g_err,
                   "grad_tol": 1e-4 * g_max + 1e-7, "greedy_bound_bit_equal": True}
    del calls, cpu_args, grads

    # times: a step at r5's width and schedule, its stages, its peak memory
    # and the device's idle share over one step
    model = build_model_from_meta(meta)
    model.load_state_dict(params_from_flax(init))
    model.cuda()
    n_params = sum(p.numel() for p in model.parameters())
    opt = make_optimizer(list(model.parameters()), warmup_cosine(cfg.lr, 1, 100),
                         cfg.weight_decay, cfg.grad_clip)
    step = dual_trainer.make_dual_train_step(model, opt)
    gen = torch.Generator().manual_seed(seed)
    stage_names = ("graph_features", "forward", "loss_with_greedy", "backward", "optimizer")
    times = {}
    for B, n in DUAL_TRAIN_TIMED:
        cost, u = _tiled(torch, data[n][0], B)
        step(cost, u, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step_ms = _ms_host(torch, lambda: step(cost, u, gen), 3)
        peak = torch.cuda.max_memory_allocated()
        cuts = [_stage_ms(torch, step, model, opt, cost, u, gen, owner=dual_trainer,
                          features="graph_features", loss="dual_gnn_loss") for _ in range(3)]
        rows, wall_ms = _profile(torch, lambda: step(cost, u, gen))
        busy_ms = sum(r[0] for r in rows) / 1e3
        fwd_ms, by, flops = _dual_forward_bound_ms(n, cfg.hidden, cfg.layers, n_params)
        step_flops = 3 * flops * B
        times[f"{B}x{n}"] = {
            "batch": B, "n": n, "step_ms_host_clock": step_ms,
            "stage_ms": {name: statistics.median(c[i] for c in cuts)
                         for i, name in enumerate(stage_names)},
            "max_memory_allocated_bytes": peak, "memory_allocated_before_step_bytes": before,
            "bound_ms": step_flops / F32_OPS_PER_S * 1e3, "bound_by": "operations",
            "step_matrix_flops": step_flops, "tflops_per_s": step_flops / step_ms / 1e9,
            "profiled_step_wall_ms": wall_ms,
            "device_busy_ms": busy_ms if rows else "not measured",
            "device_idle_share": (1.0 - busy_ms / wall_ms) if rows else "not measured",
            "top_kernels": [{"name": k[:80], "device_ms": d / 1e3, "count": c}
                            for d, k, c in rows[:6]],
        }
        del cost, u
        torch.cuda.empty_cache()
    del model, opt, step
    torch.cuda.empty_cache()
    # the greedy kernel on the epoch's first step's arguments, timed beside
    # its plain loop (bit-equality held above for every call)
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    no_flush = torch.empty(1, dtype=torch.float32, device="cuda")
    greedy = _greedy_against_plain(torch, *first_greedy, "the dual train step", flush, no_flush)
    greedy_key = f"{greedy['batch']}x{greedy['n']}"
    del first_greedy, flush

    phase_s = time.perf_counter() - t_phase
    _emit({
        "phase": "dual_train",
        "width": {"hidden": cfg.hidden, "layers": cfg.layers, "heads": cfg.heads,
                  "dropout": cfg.dropout, "parameters": n_params},
        "schedule": {"lr": cfg.lr, "batch": cfg.batch_size, "epochs": cfg.epochs,
                     "clip_sentinels": cfg.clip_sentinels, "normalize_gap": cfg.normalize_gap,
                     "supervise_duals": cfg.supervise_duals},
        "instances": [len(train), len(val)], "n": EVAL_N, "train_seconds": train_s,
        "steps": len(steps), "validation_batches": len(evals), "step_losses": losses,
        "history": history, "log": logs, "leaves_moved": moved, "launches": launches,
        "greedy_against_plain": {"calls": len(steps) + len(evals), "shapes": greedy_shapes,
                                 "bit_equal": True, "max_abs_err": greedy_err},
        "greedy": {greedy_key: greedy},
        "checkpoint_meta_keys": sorted(saved_meta), "serve": serve, "card_vs_cpu": card_vs_cpu,
        "times": times, "phase_seconds": phase_s,
    })
    if phase_s > DUAL_TRAIN_PHASE_LIMIT_S:
        raise AssertionError(f"the dual_train phase took {phase_s:.1f} s, above "
                             f"{DUAL_TRAIN_PHASE_LIMIT_S} s")
    return {"launches": launches, "max_abs_err": greedy_err, "greedy": {greedy_key: greedy}}


# The front_ends phase: the benchmark and profiling CLIs, the regression
# bench and the solver classes, on artifacts/one_gnn_default at its full width.
FRONT_N = 2048
FRONT_BY_TYPE_N = 512
FRONT_COMPREHENSIVE_N = (512, 1024)
FRONT_LARGE_N = 4096
FRONT_REGRESSION_N = 1024
FRONT_VERIFY_N = 1024
FRONT_ENDS_PHASE_LIMIT_S = 60.0


@contextlib.contextmanager
def _recording_front_ends():
    """Every instance the port's generators make (float64), every
    (float32 input, assignment) the pipeline's ``solve`` or the batched
    device solver that ``profile_pipeline`` times returns, and every SciPy
    solve the CLIs time, for the float64 optimality hold (which then needs
    no SciPy solve of its own for an instance a CLI solved)."""
    import numpy as np
    import scipy.optimize

    import lapgnn_tpu_torch.data.generators as gen_mod
    import lapgnn_tpu_torch.pipeline as pipeline_mod
    import lapgnn_tpu_torch.utils.profiling as profiling_mod

    made, solved, scipy_solved = [], [], []
    real_lsa = scipy.optimize.linear_sum_assignment
    fams = gen_mod.FAMILIES
    real_fams = dict(fams)
    real_uniform = gen_mod.generate_uniform_costs
    real_solve = pipeline_mod.WarmStartPipeline.solve
    real_batch = profiling_mod.lapjv_seeded_batch

    def keep(fn):
        def run(*args, **kwargs):
            C = fn(*args, **kwargs)
            made.append(C)
            return C

        return run

    def host32(cost):
        a = np.asarray(pipeline_mod._host_array(cost), np.float32)
        return a if a.ndim == 3 else a[None]

    def solve(self, cost, *args, **kwargs):
        out = real_solve(self, cost, *args, **kwargs)
        solved.append((host32(cost), out["col_of_row"]))
        return out

    def batch(C, *args, **kwargs):
        res = real_batch(C, *args, **kwargs)
        solved.append((host32(C), res.col_of_row.cpu().numpy()))
        return res

    def lsa(C, *args, **kwargs):
        r, c = real_lsa(C, *args, **kwargs)
        scipy_solved.append((C, float(np.asarray(C)[r, c].sum())))
        return r, c

    for name, fn in real_fams.items():
        fams[name] = keep(fn)
    gen_mod.generate_uniform_costs = keep(real_uniform)
    pipeline_mod.WarmStartPipeline.solve = solve
    profiling_mod.lapjv_seeded_batch = batch
    scipy.optimize.linear_sum_assignment = lsa
    try:
        yield made, solved, scipy_solved
    finally:
        fams.update(real_fams)
        gen_mod.generate_uniform_costs = real_uniform
        pipeline_mod.WarmStartPipeline.solve = real_solve
        profiling_mod.lapjv_seeded_batch = real_batch
        scipy.optimize.linear_sum_assignment = real_lsa


def _hold_optimal(made, solved, scipy_solved, what):
    """Each solved assignment's float64 cost against SciPy's optimum of the
    float64 instance it was made from, to 1e-12 relative (the optimum a CLI's
    own SciPy solve of that array found, else a SciPy solve here).  Returns
    the number held, the largest relative gap and the indices in ``made``
    of the instances held."""
    import numpy as np

    opts, worst, held = {}, 0.0, set()
    for k, C in enumerate(made):
        opts.update({k: opt for D, opt in scipy_solved if D is C})
    for c32, x in solved:
        for b in range(c32.shape[0]):
            k = next((i for i, C in enumerate(made)
                      if C.shape == c32.shape[1:] and np.array_equal(C.astype(np.float32), c32[b])),
                     None)
            if k is None:
                raise AssertionError(f"{what}: a solved instance is none of the generated ones")
            C = made[k]
            if k not in opts:
                opts[k] = _scipy_opt(C)
            n = C.shape[0]
            xb = np.asarray(x[b], np.int64)
            if not np.array_equal(np.sort(xb), np.arange(n)):
                raise AssertionError(f"{what}: an assignment is not a permutation")
            got = float(C[np.arange(n), xb].sum())
            gap = abs(got - opts[k]) / max(1.0, abs(opts[k]))
            if not gap <= 1e-12:
                raise AssertionError(f"{what}: cost {got} against SciPy's {opts[k]} (n = {n})")
            worst = max(worst, gap)
            held.add(k)
    return sum(c.shape[0] for c, _ in solved), worst, held


def _hold_two_min_calls(torch, calls, what, chunk_bytes=2**30):
    """Captured K4 calls ``((C, v), result)`` against the plain version, bit
    for bit.  The consecutive calls on one (n, m) matrix (a solve's ARR
    rounds) are held a chunk at a time: their v stacked, one broadcast plain
    call, which gives each row the bits of its own call.  Returns the
    largest absolute difference over the finite entries."""
    from lapgnn_tpu_torch.ops.cuda.twomin import two_min_plain

    err, i = 0.0, 0
    while i < len(calls):
        C = calls[i][0][0]
        most = max(1, chunk_bytes // (C.numel() * C.element_size())) if C.ndim == 2 else 1
        j = i + 1
        while j < len(calls) and j - i < most and calls[j][0][0] is C:
            j += 1
        group = calls[i:j]
        V = torch.stack([args[1] for args, _ in group])
        got = tuple(torch.stack([g[t] for _, g in group]) for t in range(3))
        want = two_min_plain(C, V) if C.ndim == 2 else two_min_plain(C[None], V)
        err = max(err, _check_two_min(
            torch, got, want, f"{what}, calls {i}-{j - 1} of {len(calls)}, "
                              f"shape {tuple(C.shape)}, {C.dtype}"))
        i = j
    return err


def _run_cli(main, argv):
    """``main(argv)`` in process with its standard output kept: (its return
    value, the JSON lines it printed, the host-clock seconds).  A CLI goes on
    past a failed measurement and says so on a ``#`` line: any such line
    that names a failure raises here."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    seconds = time.perf_counter() - t0
    lines = []
    for x in buf.getvalue().splitlines():
        if x.startswith("#") and "fail" in x.lower():
            raise AssertionError(f"{main.__module__} {' '.join(argv)}: {x}")
        if x.startswith("{") and x.endswith("}"):  # one-line JSON objects only
            lines.append(json.loads(x))
    return ret, lines, seconds


def _expect(what, got, want):
    if got != want:
        raise AssertionError(f"front_ends: {what} is {got!r}, expected {want!r}")


def _experiment_rows(logs):
    """(solver, family, n) -> median ms and cost of a BenchmarkLogger run."""
    files = sorted((Path(logs) / "experiments").glob("*.json"))
    rows = json.loads(files[-1].read_text())["rows"]
    return [{"solver": r["solver"], "family": r["family"], "n": r["n"],
             "median_ms": None if r["median_s"] is None else r["median_s"] * 1e3,
             "cost": r["cost"]} for r in rows]


def phase_front_ends(torch, seed):
    """The solver front ends, the benchmark and profiling CLIs and the
    regression bench on the card: ``cli.benchmark`` (device mode, n = 2048,
    uniform and sparse, ``--quick``), ``cli.profile_pipeline`` (device mode,
    n = 2048), ``cli.benchmark_by_type`` (n = 512), ``cli.comprehensive_benchmark``
    (n = 512 and 1024, ``--no-plots``), ``cli.large_scale_benchmark`` (device
    mode, n = 4096), ``cli.main_benchmark --quick`` (host only: its
    correctness gate, then the host solvers' times), ``bench.regression
    --device`` (n = 1024), all with ``artifacts/one_gnn_default`` where they
    take a checkpoint.  Each CLI's count of measured rows is held, a ``#``
    line that names a failure fails the phase, every instance the pipeline
    CLIs made must have gone through the pipeline, and every assignment the
    pipeline returned is held in float64 to SciPy's optimum (1e-12
    relative).  Then the solver classes:
    ``TorchSolver`` and ``SeededTorchSolver`` in float32 (S1-S3) at n = 2048
    on uniform, seeded by row / column minima and by the rank-1 seed, within
    n * 2^-23 * max|C| of SciPy's optimum; ``verify_solver_correctness`` at
    1e-10 with all seven classes (the torch ones in float64: S1 and S2's
    float64 forms) at n = 1024 on uniform and sparse; ``LAPMODSolver`` on sparse at n = 2048 and the route
    that answered.  The launch counters, zeroed just before, must show K1-K3
    and S1-S3, and every K1 / K2 / K3 call of the phase is held against its plain
    version on its own arguments (K1, K2 bit for bit, K3 within rtol
    2e-5 / atol 2e-6 with its selection channels bit-equal).  At most 60 s."""
    import tempfile

    import numpy as np

    import lapgnn_tpu_torch.ops.cuda.features as cuda_features
    import lapgnn_tpu_torch.ops.dual as dual_mod
    import lapgnn_tpu_torch.ops.features as features_mod
    import lapgnn_tpu_torch.solver.seeded as seeded_mod
    from lapgnn_tpu_torch.bench import regression
    from lapgnn_tpu_torch.cli import (benchmark, benchmark_by_type, comprehensive_benchmark,
                                      large_scale_benchmark, main_benchmark, profile_pipeline)
    from lapgnn_tpu_torch.data.generators import FAMILIES
    from lapgnn_tpu_torch.solver.api import (LAPMODSolver, LAPSolver, SciPySolver,
                                             SeededLAPSolver, SeededTorchSolver, TorchSolver,
                                             WarmStartLAPSolver)
    from lapgnn_tpu_torch.solver.seed_baselines import seed_rank1_analytic, seed_row_col_minima
    from lapgnn_tpu_torch.solver.verification import verify_solver_correctness

    ck = str(CHECKPOINT)
    rng = np.random.default_rng(seed + 909)
    C_u = FAMILIES["uniform"](FRONT_N, rng)
    C_sparse = FAMILIES["sparse"](FRONT_N, rng)
    C_verify = {f: FAMILIES[f](FRONT_VERIFY_N, rng) for f in ("uniform", "sparse")}
    seeds = {"row_col_minima": seed_row_col_minima(C_u), "rank1_analytic": seed_rank1_analytic(C_u)}
    verify_seeds = {f: seed_rank1_analytic(C) for f, C in C_verify.items()}
    opt_u = _scipy_opt(C_u)
    torch.cuda.synchronize()

    seen = {k: [] for k in ("col_min", "min_trick", "row_features_stats", "two_min")}
    clis, classes = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        since = _launches()
        with _eager_predicts(), \
                _wrapped(cuda_features, "col_min", _capture(seen["col_min"], clone=True)), \
                _wrapped(dual_mod, "min_trick", _capture(seen["min_trick"], clone=True)), \
                _wrapped(features_mod, "row_features_stats",
                         _capture(seen["row_features_stats"], clone=True)), \
                _wrapped(seeded_mod, "two_min", _capture(seen["two_min"])), \
                _recording_front_ends() as (made, solved, scipy_solved):
            # each pipeline CLI's count of measured instances is held
            # beside the '#' failure lines that _run_cli refuses
            logs = f"{tmp}/benchmark"
            ret, _, s = _run_cli(benchmark.main, [
                "--checkpoint", ck, "--mode", "device", "--sizes", str(FRONT_N),
                "--families", "uniform", "sparse", "--quick", "--logs", logs])
            _expect("cli.benchmark's measured_instances", ret["measured_instances"], 2)
            clis["benchmark"] = {"seconds": s, "summary": ret, "rows": _experiment_rows(logs)}
            ret, _, s = _run_cli(profile_pipeline.main, [
                "--checkpoint", ck, "--size", str(FRONT_N), "--families", "uniform",
                "--mode", "device", "--repeats", "3"])
            _expect("cli.profile_pipeline's families", list(ret), ["uniform"])
            clis["profile_pipeline"] = {"seconds": s, "stages_ms": ret}
            logs = f"{tmp}/by_type"
            ret, _, s = _run_cli(benchmark_by_type.main, [
                "--checkpoint", ck, "--size", str(FRONT_BY_TYPE_N), "--instances", "1",
                "--repeats", "1", "--logs", logs])
            by_type_fams = benchmark_by_type.build_parser().parse_args(
                ["--checkpoint", ck]).families
            _expect("cli.benchmark_by_type's families", list(ret["per_family"]), by_type_fams)
            _expect("cli.benchmark_by_type's timed pipeline solves",
                    sum(r["solver"] == "warm_pipeline" and r["median_ms"] is not None
                        for r in _experiment_rows(logs)), len(by_type_fams))
            clis["benchmark_by_type"] = {"seconds": s, "summary": ret}
            ret, lines, s = _run_cli(comprehensive_benchmark.main, [
                "--checkpoint", ck, "--sizes", *map(str, FRONT_COMPREHENSIVE_N),
                "--instances", "1", "--repeats", "1", "--no-plots", "--out", f"{tmp}/comp"])
            _expect("cli.comprehensive_benchmark's rows",
                    [(r["family"], r["n"]) for r in lines[:-1]],
                    [(f, n) for f in ("uniform", "sparse") for n in FRONT_COMPREHENSIVE_N])
            clis["comprehensive_benchmark"] = {"seconds": s, "summary": ret, "rows": lines[:-1]}
            logs = f"{tmp}/large"
            ret, lines, s = _run_cli(large_scale_benchmark.main, [
                "--checkpoint", ck, "--sizes", str(FRONT_LARGE_N), "--instances", "1",
                "--repeats", "1", "--mode", "device", "--logs", logs])
            _expect("cli.large_scale_benchmark's rows with a pipeline time",
                    [(r["n"], "pipeline_s" in r) for r in lines], [(FRONT_LARGE_N, True)])
            clis["large_scale_benchmark"] = {"seconds": s, "rows": lines,
                                             "logged": _experiment_rows(logs)}
            n_made_by_pipeline_clis = len(made)
            ret, lines, s = _run_cli(main_benchmark.main, ["--quick", "--logs", f"{tmp}/main"])
            _expect("cli.main_benchmark --quick's rows", len(lines[:-1]), 6)
            clis["main_benchmark"] = {"seconds": s, "summary": ret, "rows": lines[:-1]}
            ret, _, s = _run_cli(regression.main, [
                "--sizes", str(FRONT_REGRESSION_N), "--device", "--repeats", "2"])
            clis["bench.regression"] = {"seconds": s, "cells": ret}
            made_cli, solved_cli, scipy_cli = list(made), list(solved), list(scipy_solved)

            # the solver classes on the card
            for name, solver, kw in (
                    ("torch_float32", TorchSolver(), {}),
                    *((f"seeded_torch_float32_{k}", SeededTorchSolver(), {"u": u, "v": v})
                      for k, (u, v) in seeds.items())):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, x, cost = solver.solve(C_u, **kw)
                ms = (time.perf_counter() - t0) * 1e3
                if not np.array_equal(np.sort(x), np.arange(FRONT_N)):
                    raise AssertionError(f"{name}: not a permutation")
                got = float(C_u[np.arange(FRONT_N), x].sum())
                bound = FRONT_N * 2.0 ** -23 * float(np.abs(C_u).max())
                if not abs(got - opt_u) <= bound:
                    raise AssertionError(f"{name}: cost {got}, SciPy {opt_u}, bound {bound}")
                classes[name] = {"ms_host_clock": ms, "float64_cost": got,
                                 "reported_float32_cost": cost, "scipy_cost": opt_u,
                                 "equals_scipy": got == opt_u, "gap": got - opt_u,
                                 "bound": bound}
            gate = [SciPySolver(), LAPSolver(), SeededLAPSolver(),
                    TorchSolver(dtype=torch.float64), SeededTorchSolver(dtype=torch.float64),
                    LAPMODSolver(), WarmStartLAPSolver()]
            for fam, C in C_verify.items():
                t0 = time.perf_counter()
                costs = verify_solver_correctness(C, gate, tol=1e-10, u=verify_seeds[fam][0],
                                                  v=verify_seeds[fam][1])
                classes[f"verify_{fam}"] = {"n": FRONT_VERIFY_N, "costs": costs,
                                            "seconds": time.perf_counter() - t0}
            lapmod = LAPMODSolver()
            t0 = time.perf_counter()
            _, x, cost = lapmod.solve(C_sparse)
            opt_s = _scipy_opt(C_sparse)
            if not abs(cost - opt_s) <= 1e-12 * max(1.0, abs(opt_s)):
                raise AssertionError(f"lapmod: cost {cost}, SciPy {opt_s}")
            classes["lapmod_sparse"] = {"n": FRONT_N, "route": lapmod.last_route,
                                        "ms_host_clock": (time.perf_counter() - t0) * 1e3,
                                        "cost": cost, "scipy_cost": opt_s}
            print(f"front_ends: LAPMODSolver on sparse n = {FRONT_N} answered by the "
                  f"{lapmod.last_route} route", flush=True)
        torch.cuda.synchronize()
        launches = _launches(since)
    drive_s = time.perf_counter() - t_phase
    want = ("col_min", "min_trick", "row_features_stats", *SOLVER_KERNELS)
    if any(launches[k] < 1 for k in want):
        raise AssertionError(f"the front ends skipped a kernel: launches {launches}")

    held, worst_gap, held_ids = _hold_optimal(made_cli, solved_cli, scipy_cli, "front_ends CLIs")
    # every instance the pipeline CLIs made went through the pipeline
    unsolved = [i for i in range(n_made_by_pipeline_clis) if i not in held_ids and not any(
        made_cli[k].shape == made_cli[i].shape and np.array_equal(made_cli[k], made_cli[i])
        for k in held_ids)]
    if unsolved or not held_ids:
        raise AssertionError(f"front_ends: {len(unsolved)} of the {n_made_by_pipeline_clis} "
                             "instances the pipeline CLIs made were never solved by the pipeline")

    # every kernel call of the phase against its plain version
    errs = {k: 0.0 for k in seen}
    errs["two_min"] = _hold_two_min_calls(torch, seen["two_min"], "front_ends")
    for k, calls in seen.items():
        if k == "two_min":
            continue
        for i, (args, got) in enumerate(calls):
            what = f"front_ends, call {i} of {len(calls)}, shape {tuple(args[0].shape)}"
            if k in ("col_min", "min_trick"):
                e, _, _ = _hold_colmin(torch, k, got,
                                       _colmin_want(torch, args[0], args[1] if k == "min_trick" else None),
                                       what)
            else:
                e = _hold_k3(torch, got, args[0], what, finite=bool(torch.isfinite(args[0]).all()))
            errs[k] = max(errs[k], e)
    against_plain = {k: {"calls": len(calls), "shapes": sorted({tuple(a[0].shape) for a, _ in calls}),
                         "max_abs_err": errs[k]} for k, calls in seen.items()}
    del seen
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    _emit({"phase": "front_ends", "checkpoint": "artifacts/one_gnn_default", "n": FRONT_N,
           "launches": launches, "kernels_against_plain": against_plain,
           "pipeline_solves_held_optimal": held,
           "pipeline_cli_instances": n_made_by_pipeline_clis, "largest_relative_gap": worst_gap,
           "clis": clis, "solver_classes": classes,
           "drive_seconds": drive_s, "phase_seconds": phase_s})
    if phase_s > FRONT_ENDS_PHASE_LIMIT_S:
        raise AssertionError(
            f"the front_ends phase took {phase_s:.1f} s, above {FRONT_ENDS_PHASE_LIMIT_S} s")
    return {"launches": launches, "max_abs_err": errs}


# The parallel phase: row-sharded serving at one_gnn_default's full width.
PAR_N = 2048
PAR_FAMILIES = ("uniform", "sparse")
PAR_DIJKSTRA_N = 128
PAR_PREDICT_ATOL = 1e-5  # tests/test_torch_parallel.py's, the JAX test's
PAR_WARM_N = 256  # a small solve first, so that no timed call builds or initialises
PARALLEL_PHASE_LIMIT_S = 45.0
# The roofline block at n = 2048 only: at 8192 its host-side instance
# generation alone takes seconds of the phase's limit.  Run the CLI by hand
# with ``--roofline-n 2048 8192`` for the larger size.
PAR_SCALING_ARGV = ["--meshes", "1", "--n", "2048", "--roofline-n", "2048", "--solve"]


@contextlib.contextmanager
def _kernel_calls():
    """Every K1 / K2 call (``col_min_kernel``, which both wrappers launch
    through) and every K4 call (``two_min_kernel``) inside the block, kept
    with its arguments and (for K1 / K2, a copy of) its result."""
    import lapgnn_tpu_torch.ops.cuda.colmin as colmin_mod
    import lapgnn_tpu_torch.ops.cuda.twomin as twomin_mod

    calls = {"col_min": [], "min_trick": [], "two_min": []}

    def colmin(real):
        def run(C, u=None, **force):
            out = real(C, u, **force)
            calls["col_min" if u is None else "min_trick"].append(((C, u), out.clone()))
            return out

        return run

    with _wrapped(colmin_mod, "col_min_kernel", colmin), \
            _wrapped(twomin_mod, "two_min_kernel", _capture(calls["two_min"])):
        yield calls


def _hold_kernel_calls(torch, calls, what):
    """``_kernel_calls``' calls against the plain versions, bit for bit (a
    mixed-zero minimum of K1 / K2 only ``==``): {kernel: (calls, largest
    absolute difference)}."""
    out = {"two_min": (len(calls["two_min"]), _hold_two_min_calls(torch, calls["two_min"], what))}
    for k in ("col_min", "min_trick"):
        err = 0.0
        for i, ((C, u), got) in enumerate(calls[k]):
            e, _, _ = _hold_colmin(torch, k, got, _colmin_want(torch, C, u),
                                   f"{what}, call {i}, shape {tuple(C.shape)}")
            err = max(err, e)
        out[k] = (len(calls[k]), err)
    return out


def _one_gnn_default(torch, device):
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint, params_from_flax

    params, meta, _ = load_checkpoint(CHECKPOINT)
    model = build_model_from_meta(meta)
    model.load_state_dict(params_from_flax(params))
    return model.to(device).eval()


def _plain_predict(torch, model, cost):
    """``make_sharded_predict``'s steps on the whole batch, unsharded: the
    sort-based features, the model, the 'auto' policy."""
    from lapgnn_tpu_torch.ops.features import row_features
    from lapgnn_tpu_torch.ops.sinkhorn import auto_select_seed

    with torch.inference_mode():
        u = model(row_features(cost), cost=cost)["u"].to(cost.dtype)
        return auto_select_seed(cost, u)


def _plain_pipeline(torch, model, C):
    """``make_sharded_pipeline``'s steps on the whole matrix, unsharded."""
    from lapgnn_tpu_torch.ops.dual import robust_normalize
    from lapgnn_tpu_torch.ops.features import row_features
    from lapgnn_tpu_torch.ops.rank1 import rank1_duals, select_best_seed
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single

    with torch.inference_mode():
        C_in, mn, a = robust_normalize(C[None])
        u = model(row_features(C_in), cost=C_in)["u"][0] * a + mn
        u, v = select_best_seed(C, (u, rank1_duals(C[None])[0][0]))
        return lapjv_seeded_single(C, u, v, gate="both")


def _rank1_seeds(torch, C):
    from lapgnn_tpu_torch.ops.dual import fast_min_trick
    from lapgnn_tpu_torch.ops.rank1 import rank1_duals

    with torch.inference_mode():
        u = rank1_duals(C)[0]
        return u, fast_min_trick(C, u)


def _par_cost(fam, seed):
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES

    return FAMILIES[fam](PAR_N, np.random.default_rng(seed)).astype(np.float32)


def _load_kernels():
    """Build or load every kernel library, so that no timed call does."""
    from lapgnn_tpu_torch.ops.cuda._lib import KERNEL_LIBS

    for lib in KERNEL_LIBS.values():
        lib.load()


def _warm_up(torch, mesh, run_pipeline=None):
    """Load the kernels, open the collectives' communicators and run each
    path once at n = PAR_WARM_N."""
    from lapgnn_tpu_torch.parallel import local_rows
    from lapgnn_tpu_torch.parallel.solver import make_sharded_seeded_solve

    if mesh.device.type == "cuda":
        _load_kernels()
    C = torch.from_numpy(_par_cost("uniform", 1)[:PAR_WARM_N, :PAR_WARM_N]).to(mesh.device)
    u, v = _rank1_seeds(torch, C)
    make_sharded_seeded_solve(mesh)(local_rows(C, mesh), local_rows(u[:, None], mesh)[:, 0], v)
    if run_pipeline is not None:
        run_pipeline(local_rows(C, mesh))
    torch.cuda.synchronize()
    mesh.log.clear()


def _wait_for(path, timeout_s=300.0):
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout_s} s")
        time.sleep(0.02)


def _parallel_rank(rank, device, seed, out_dir):
    """One of the two gloo ranks on the one card: the sharded solve from
    rank-1 seeds, the sharded predict and the shmap column passes on uniform
    at n = PAR_N, every K1 / K2 / K4 call held against its plain version;
    what the parent compares goes to ``rank{rank}.pt``.  The rank sets up,
    then waits for ``out_dir/go``, so that its start-up overlaps the
    parent's world-1 work and its timed work does not."""
    import torch

    from lapgnn_tpu_torch.ops.cuda import col_min, min_trick
    from lapgnn_tpu_torch.parallel import (local_rows, make_mesh, make_sharded_predict,
                                           shmap_col_min, shmap_min_trick)
    from lapgnn_tpu_torch.parallel.solver import (assert_no_matrix_allgather,
                                                  make_sharded_seeded_solve)

    mesh = make_mesh(data=1, model=2, device=device)
    C = torch.from_numpy(_par_cost("uniform", seed)).to(mesh.device)
    u, v = _rank1_seeds(torch, C)
    model = _one_gnn_default(torch, mesh.device)
    C_blk, u_blk = local_rows(C, mesh), local_rows(u[:, None], mesh)[:, 0]
    solve = make_sharded_seeded_solve(mesh)
    predict = make_sharded_predict(model, mesh)
    _warm_up(torch, mesh)
    _wait_for(Path(out_dir) / "go")
    since = _launches()
    mesh.log.clear()
    with _kernel_calls() as calls:
        t0 = time.perf_counter()
        res = solve(C_blk, u_blk, v)
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) * 1e3
        solve_log = max(e[1] for e in mesh.log)
        assert_no_matrix_allgather(mesh.log, PAR_N, 2)
        u_pred, v_pred = predict(C_blk[None])
        col, mt = shmap_col_min(mesh)(C_blk), shmap_min_trick(mesh)(C_blk, u_blk)
        torch.cuda.synchronize()
    launches = _launches(since)
    largest = max(e[1] for e in mesh.log)
    assert_no_matrix_allgather(mesh.log, PAR_N, 2)
    held = _hold_kernel_calls(torch, calls, f"parallel rank {rank}")
    whole = {"col_min": col_min(C), "min_trick": min_trick(C, u)}
    torch.save({
        "x": res.col_of_row.cpu(), "y": res.row_of_col.cpu(), "v": res.v.cpu(),
        "cost": res.cost.cpu(), "solve_ms": solve_ms, "solve_largest_collective": solve_log,
        "largest_collective": largest, "u_pred": u_pred.cpu(), "v_pred": v_pred.cpu(),
        "shmap_col_min_equal": torch.equal(col.view(torch.int32), whole["col_min"].view(torch.int32)),
        "shmap_min_trick_equal": torch.equal(mt.view(torch.int32), whole["min_trick"].view(torch.int32)),
        "launches": launches, "held": held,
    }, f"{out_dir}/rank{rank}.pt")


def _same_bits(a, b):
    import torch

    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.cpu().view(bits), b.cpu().view(bits))


def _par_world1(torch, seed):
    """World 1 under NCCL (a TCP store on 127.0.0.1): the sharded pipeline
    against the same steps unsharded and SciPy, the sharded solve against
    the unsharded one, on ``PAR_FAMILIES``.  SciPy's optima are solved on
    host threads (it releases the interpreter lock) while the card warms
    up."""
    import datetime
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch.distributed as dist

    from lapgnn_tpu_torch.parallel import local_rows, make_mesh, ring_min_trick
    from lapgnn_tpu_torch.parallel.launch import free_port
    from lapgnn_tpu_torch.parallel.solver import (assert_no_matrix_allgather,
                                                  make_sharded_pipeline,
                                                  make_sharded_seeded_solve)
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single

    costs = [_par_cost(fam, seed + 17 * k) for k, fam in enumerate(PAR_FAMILIES)]
    scipy_pool = ThreadPoolExecutor(len(costs))
    optima = [scipy_pool.submit(_scipy_opt, C_np.astype(np.float64)) for C_np in costs]
    scipy_pool.shutdown(wait=False)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    out, launches, held = {}, {}, []
    try:
        mesh = make_mesh(data=1, model=1, device="cuda")
        model = _one_gnn_default(torch, mesh.device)
        run, solve = make_sharded_pipeline(model, mesh), make_sharded_seeded_solve(mesh)
        _warm_up(torch, mesh, run)
        for fam, C_np, opt in zip(PAR_FAMILIES, costs, optima):
            C = torch.from_numpy(C_np).cuda()
            u, v = _rank1_seeds(torch, C)
            C_blk = local_rows(C, mesh)
            torch.cuda.synchronize()
            since = _launches()
            mesh.log.clear()
            with _kernel_calls() as calls:
                t0 = time.perf_counter()
                piped = run(C_blk)
                torch.cuda.synchronize()
                pipe_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                res = solve(C_blk, u, v)
                torch.cuda.synchronize()
                solve_ms = (time.perf_counter() - t0) * 1e3
                ring = ring_min_trick(mesh)(C_blk, u)
            for name, count in _launches(since).items():
                launches[name] = launches.get(name, 0) + count
            assert_no_matrix_allgather(mesh.log, PAR_N, 1)
            held.append(_hold_kernel_calls(torch, calls, f"parallel world 1, {fam}"))
            ref = _plain_pipeline(torch, model, C)
            t0 = time.perf_counter()
            unsharded = lapjv_seeded_single(C, u, v, gate="both")
            torch.cuda.synchronize()
            unsharded_ms = (time.perf_counter() - t0) * 1e3
            x = piped.col_of_row.cpu().numpy()
            opt = opt.result()
            got = float(C_np.astype(np.float64)[np.arange(PAR_N), x].sum())
            checks = {
                "pipeline_assignment_equal": torch.equal(piped.col_of_row, ref.col_of_row),
                "pipeline_cost_equal": _same_bits(piped.cost.reshape(1), ref.cost.reshape(1)),
                "pipeline_optimal": abs(got - opt) <= 1e-5 * abs(opt),
                "solve_bit_equal": (torch.equal(res.col_of_row, unsharded.col_of_row)
                                    and torch.equal(res.row_of_col, unsharded.row_of_col)
                                    and _same_bits(res.v, unsharded.v)
                                    and _same_bits(res.cost.reshape(1), unsharded.cost.reshape(1))),
                "ring_min_trick_equal": _same_bits(ring, (C - u[:, None]).amin(0)),
            }
            if not all(checks.values()):
                raise AssertionError(f"parallel world 1, {fam}: {checks}")
            out[fam] = {**checks, "pipeline_ms": pipe_ms, "sharded_solve_ms": solve_ms,
                        "unsharded_solve_ms": unsharded_ms,
                        "cost_float64": got, "scipy_cost": opt,
                        "largest_collective": max((e[1] for e in mesh.log), default=0),
                        "collectives": len(mesh.log)}
    finally:
        dist.destroy_process_group()
    return out, launches, held, model


def _par_dijkstra(torch, seed):
    """``augment_all`` and ``augment_all_multisource`` on the card from
    ``column_reduction`` at n = PAR_DIJKSTRA_N: equal to the CPU's."""
    from lapgnn_tpu_torch.solver import augment_all, augment_all_multisource, column_reduction

    C = torch.from_numpy(_par_cost("uniform", seed + 3)[:PAR_DIJKSTRA_N, :PAR_DIJKSTRA_N])
    out = {}
    for fn in (augment_all, augment_all_multisource):
        card = fn(C.cuda(), column_reduction(C.cuda()))
        cpu = fn(C, column_reduction(C))
        same = (torch.equal(card.col_of_row.cpu(), cpu.col_of_row)
                and torch.equal(card.row_of_col.cpu(), cpu.row_of_col)
                and _same_bits(card.v, cpu.v))
        if not same:
            raise AssertionError(f"{fn.__name__} on the card differs from the CPU")
        out[fn.__name__] = same
    return out


def phase_parallel(torch, seed):
    """Row-sharded serving on the card at one_gnn_default's full width,
    n = PAR_N: world 1 under NCCL (``_par_world1``), two gloo ranks on the
    one card (``_parallel_rank``: the sharded solve bit-equal to the
    unsharded one on the card, the sharded predict within PAR_PREDICT_ATOL of
    the same steps unsharded, the shmap passes bit-equal to K1 / K2 on the
    whole matrix), every K1 / K2 / K4 call of both held against its plain
    version, the collective logs held to ``assert_no_matrix_allgather``;
    then the scaling CLI and the Dijkstra augmenters.  Returns the launches
    of each kernel on the sharded path (world 1 and 2; the scaling CLI's
    timing loops are counted apart) and each one's largest difference."""
    import json as _json
    import tempfile

    from lapgnn_tpu_torch.cli import scaling_benchmark
    from lapgnn_tpu_torch.parallel.launch import spawn_ranks
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single

    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        # the two ranks start up while world 1 runs, and wait for "go"
        world2_run = pool.submit(spawn_ranks, _parallel_rank, 2, args=("cuda", seed, tmp),
                                 backend="gloo", timeout=300)
        try:
            world1, launches, held, model = _par_world1(torch, seed)
        finally:
            Path(tmp, "go").touch()
        world1_s = time.perf_counter() - t_phase
        world2_run.result()
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(2)]
    C = torch.from_numpy(_par_cost("uniform", seed)).cuda()
    u, v = _rank1_seeds(torch, C)
    t0 = time.perf_counter()
    unsharded = lapjv_seeded_single(C, u, v, gate="both")
    torch.cuda.synchronize()
    unsharded_ms = (time.perf_counter() - t0) * 1e3
    u_ref, v_ref = _plain_predict(torch, model, C[None])
    world2 = {}
    for r, res in enumerate(ranks):
        rows = slice(r * PAR_N // 2, (r + 1) * PAR_N // 2)
        u_err = float((res["u_pred"][0] - u_ref[0, rows].cpu()).abs().max())
        v_err = float((res["v_pred"][0] - v_ref[0].cpu()).abs().max())
        checks = {
            "solve_bit_equal": (torch.equal(res["x"], unsharded.col_of_row.cpu())
                                and torch.equal(res["y"], unsharded.row_of_col.cpu())
                                and _same_bits(res["v"], unsharded.v)
                                and _same_bits(res["cost"].reshape(1), unsharded.cost.reshape(1))),
            "predict_within_atol": u_err <= PAR_PREDICT_ATOL and v_err <= PAR_PREDICT_ATOL,
            "shmap_col_min_equal": res["shmap_col_min_equal"],
            "shmap_min_trick_equal": res["shmap_min_trick_equal"],
        }
        if not all(checks.values()):
            raise AssertionError(f"parallel rank {r} of 2: {checks} (u {u_err}, v {v_err})")
        for name, count in res["launches"].items():
            launches[name] = launches.get(name, 0) + count
        held.append(res["held"])
        world2[f"rank{r}"] = {**checks, "sharded_solve_ms": res["solve_ms"],
                              "unsharded_solve_ms": unsharded_ms,
                              "predict_max_abs_err_u": u_err, "predict_max_abs_err_v": v_err,
                              "largest_collective_solve": res["solve_largest_collective"],
                              "largest_collective": res["largest_collective"]}
    for k in ("col_min", "min_trick", "two_min"):
        if launches.get(k, 0) < 1:
            raise AssertionError(f"the sharded path launched no {k}: {launches}")
    world2_s = time.perf_counter() - t_phase - world1_s

    since = _launches()
    t0 = time.perf_counter()
    scaling = scaling_benchmark.main(PAR_SCALING_ARGV)
    scaling_s = time.perf_counter() - t0
    launches_cli = _launches(since)
    if launches_cli["row_features_stats"] < 1:
        raise AssertionError("the scaling CLI's roofline block launched no K3")
    dijkstra = _par_dijkstra(torch, seed)

    errs = {k: max(h[k][1] for h in held) for k in ("col_min", "min_trick", "two_min")}
    calls = {k: sum(h[k][0] for h in held) for k in ("col_min", "min_trick", "two_min")}
    phase_s = time.perf_counter() - t_phase
    _emit({"phase": "parallel", "n": PAR_N, "checkpoint": "artifacts/one_gnn_default",
           "world1_nccl": world1, "world2_gloo_one_card": world2,
           "kernel_calls_held": calls, "max_abs_err": errs, "launches": launches,
           "scaling": {"seconds": scaling_s, "mesh_1": scaling["pipeline_edges_per_s_per_mesh"],
                       "roofline": scaling["roofline"], "launches": launches_cli},
           "dijkstra_card_equals_cpu": dijkstra, "world1_seconds": world1_s,
           "world2_seconds": world2_s, "phase_seconds": phase_s})
    print("parallel: " + _json.dumps({
        "ms_per_sharded_solve": {"world1": {f: w["sharded_solve_ms"] for f, w in world1.items()},
                                 "world2": {r: w["sharded_solve_ms"] for r, w in world2.items()}},
        "ms_per_unsharded_solve": {"world1": {f: w["unsharded_solve_ms"] for f, w in world1.items()},
                                   "world2": unsharded_ms},
        "largest_collective": {"world1": {f: w["largest_collective"] for f, w in world1.items()},
                               "world2": {r: w["largest_collective"] for r, w in world2.items()}},
        "edges_per_s_mesh_1": {m: e["edges_per_s"] for m, e in
                               scaling["pipeline_edges_per_s_per_mesh"].items()},
        "min_trick": {n: {k: e[k] for k in e if k.startswith("min_trick")}
                      for n, e in scaling["roofline"].items()},
    }), flush=True)
    if phase_s > PARALLEL_PHASE_LIMIT_S:
        raise AssertionError(
            f"the parallel phase took {phase_s:.1f} s, above {PARALLEL_PHASE_LIMIT_S} s")
    return {"launches": launches, "max_abs_err": errs}


# The parallel_train phase: training under a mesh at full width.  OneGNN at
# one_gnn_default's width on a (32, 512) batch, the DualGNN at dual_gnn_r5's
# on (2, 1024) and its sharded predict at n = 2048; world 1 under NCCL, then
# two gloo ranks on the one card.  Dropout 0, so that the sharded and
# unsharded steps draw the same (no) masks.
PT_DP = (32, 512)
PT_DUAL = (2, 1024)
PT_PREDICT_N = 2048
PT_DP_MESHES = ((2, 1), (1, 2))
PT_DUAL_MESHES = ((2, 1), (1, 2))
PT_LR = 1e-3
PT_LOSS_RTOL = 1e-5
PT_PREDICT_RTOL = 1e-5  # of max|u| (max|v|), and 1e-6 absolute
# OneGNN centres u, so a shift of its head's last bias changes nothing: the
# gradient there is 0, and what either step computes is rounding, which can
# be as large as a trained model's other gradients.  It is held to one AdamW
# step, not compared.
PT_GAUGE_FREE = ("row_out.3.bias",)
PARALLEL_TRAIN_PHASE_LIMIT_S = 60.0


def _pt_inputs(torch, seed, device):
    """The phase's batches on ``device``, made with numpy from ``seed``; the
    target duals the rank-1 seed of each instance (any target does for
    parity)."""
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES
    from lapgnn_tpu_torch.ops.rank1 import rank1_duals

    rng = np.random.default_rng(seed + 41)
    fams = ("uniform", "noisy_linear", "block")

    def batch(B, n):
        C = np.stack([FAMILIES[fams[k % 3]](n, rng) for k in range(B)]).astype(np.float32)
        C = torch.from_numpy(C).to(device)
        with torch.no_grad():
            return C, rank1_duals(C)[0].contiguous()

    dp, dual = batch(*PT_DP), batch(*PT_DUAL)
    pred = torch.from_numpy(FAMILIES["uniform"](PT_PREDICT_N, rng)[None].astype(np.float32)).to(device)
    return {"dp": dp, "dual": dual, "predict": pred}


def _pt_one_gnn(torch, device):
    """one_gnn_default at dropout 0 and an optimizer over every parameter
    its step trains, with the optimizer's step wrapped to keep the
    gradients it is handed."""
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint, params_from_flax
    from lapgnn_tpu_torch.train.schedule import make_optimizer
    from lapgnn_tpu_torch.train.trainer import trainable_parameters

    params, meta, _ = load_checkpoint(CHECKPOINT)
    model = build_model_from_meta({**meta, "dropout": 0.0})
    model.load_state_dict(params_from_flax(params))
    model.to(device)
    opt = _kept(make_optimizer(trainable_parameters(model, True), PT_LR))
    opt.names = [n for n, _ in model.named_parameters()]
    return model, opt


def _pt_dual_gnn(torch, device):
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint, params_from_flax
    from lapgnn_tpu_torch.train.schedule import make_optimizer

    params, meta, _ = load_checkpoint(DUAL_CHECKPOINT)
    model = build_model_from_meta({**meta, "dropout": 0.0})
    model.load_state_dict(params_from_flax(params))
    model.to(device)
    opt = _kept(make_optimizer(list(model.parameters()), PT_LR))
    opt.names = [n for n, _ in model.named_parameters()]
    return model, opt


def _kept(opt):
    """The optimizer with ``opt.seen`` holding, on the CPU, the gradients
    of its first step."""
    opt.seen = []
    real = opt.step

    def step(grads):
        if not opt.seen:
            opt.seen.append([g.detach().to("cpu", copy=True) for g in grads])
        real(grads)

    opt.step = step
    return opt


def _pt_result(torch, metrics, opt, old):
    return {"loss": float(metrics["loss"]), "grads": opt.seen[0], "names": opt.names,
            "params": [p.detach().to("cpu", copy=True) for p in opt.params], "old": old}


def _plain_dual_step(torch, model, opt, cost, u):
    """``make_sharded_dual_train_step``'s step on the whole batch: the dense
    features, the model, ``dual_gnn_loss(include_primal=False)`` (the loss
    of JAX's sharded step), its gradient and the update."""
    from lapgnn_tpu_torch.ops.features import graph_features
    from lapgnn_tpu_torch.train.loss import dual_gnn_loss

    with torch.no_grad():
        gf = graph_features(cost)
    preds = model(gf.edge_feat, gf.row_feat, gf.col_feat)
    loss, _ = dual_gnn_loss(cost, preds, normalize_gap=True, clip_sentinels=True, u_target=u,
                            include_primal=False)
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True, materialize_grads=True)
    opt.step(grads)
    return {"loss": loss.detach()}


def _plain_dual_predict(torch, model, cost):
    from lapgnn_tpu_torch.ops.features import graph_features

    with torch.inference_mode():
        gf = graph_features(cost)
        u = model(gf.edge_feat, gf.row_feat, gf.col_feat)["u"]
        return u.cpu(), (cost - u[..., :, None]).amin(-2).cpu()


def _pt_against(torch, got, ref, what):
    """The sharded step's loss, gradients and updated parameters against the
    unsharded step's: loss within PT_LOSS_RTOL, each gradient within
    1e-4 max|g| + 1e-7, each parameter within 1e-4 max|dp| + 1e-7.  Where
    the reference gradient is itself within the gradient's tolerance of 0
    its sign is not determined, and the first AdamW step moves the entry lr
    times that sign: those entries, and the parameters of PT_GAUGE_FREE,
    are held to a step of at most lr."""
    rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    held = [k not in PT_GAUGE_FREE for k in ref["names"]]
    g_max = max(float(g.abs().max()) for g, h in zip(ref["grads"], held) if h)
    d_max = max(float((p - o).abs().max()) for p, o in zip(ref["params"], ref["old"]))
    g_tol = 1e-4 * g_max + 1e-7
    g_err = max(float((a - b).abs().max())
                for a, b, h in zip(got["grads"], ref["grads"], held) if h)
    p_err, free, free_step = 0.0, 0, 0.0
    for p, pr, o, gr, h in zip(got["params"], ref["params"], ref["old"], ref["grads"], held):
        sign_free = gr.abs() <= g_tol if h else torch.ones_like(gr, dtype=torch.bool)
        free += int(sign_free.sum())
        if sign_free.any():
            free_step = max(free_step, float((p - o).abs()[sign_free].max()))
        if (~sign_free).any():
            p_err = max(p_err, float((p - pr).abs()[~sign_free].max()))
    out = {"loss_rel_err": rel, "grad_max_abs_err": g_err, "grad_tol": g_tol,
           "param_max_abs_err": p_err, "param_tol": 1e-4 * d_max + 1e-7,
           "sign_free_grad_entries": free, "their_largest_step": free_step}
    if (rel > PT_LOSS_RTOL or g_err > g_tol or p_err > out["param_tol"]
            or free_step > PT_LR * (1 + 1e-3)):
        raise AssertionError(f"{what}: sharded against unsharded {out}")
    return out


def _pt_collectives(log):
    return {"collectives": len(log), "largest": max(e[1] for e in log),
            "largest_op": max(log, key=lambda e: e[1])[0],
            "backward": sum(e[0].endswith(".backward") for e in log)}


def _pt_dp_step(torch, mesh, inputs, reps):
    """One data-parallel step from one_gnn_default's weights on this rank's
    block, then ``reps`` more timed; the first step's result."""
    from lapgnn_tpu_torch.parallel import NamedSharding, P, batch_sharding, make_dp_train_step

    model, opt = _pt_one_gnn(torch, mesh.device)
    old = [p.detach().to("cpu", copy=True) for p in opt.params]
    C, u = inputs["dp"]
    cost = batch_sharding(mesh, shard_n=True).local(C)
    u_blk = NamedSharding(mesh, P("data", "model")).local(u)
    step = make_dp_train_step(model, opt, mesh, use_cost=True, shard_rows=True)
    mesh.log.clear()
    m = step(cost, u_blk)
    torch.cuda.synchronize()
    res = {**_pt_result(torch, m, opt, old), **_pt_collectives(mesh.log)}
    res["step_ms"] = _ms_host(torch, lambda: step(cost, u_blk), reps)
    return res


def _pt_dual_step(torch, mesh, inputs, reps):
    """One 2-D edge-partitioned step from r5's weights on this rank's tile,
    its peak memory, its log held to ``assert_no_edge_tensor_gather``; then
    ``reps`` more timed."""
    from lapgnn_tpu_torch.parallel import assert_no_edge_tensor_gather, make_sharded_dual_train_step
    from lapgnn_tpu_torch.parallel.dual import local_tile

    model, opt = _pt_dual_gnn(torch, mesh.device)
    old = [p.detach().to("cpu", copy=True) for p in opt.params]
    C, u = inputs["dual"]
    tile = local_tile(C, mesh).contiguous()
    rows = tile.shape[-2]
    u_rows = u[:, mesh.coordinate("row") * rows:(mesh.coordinate("row") + 1) * rows]
    step = make_sharded_dual_train_step(model, opt, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.log.clear()
    m = step(tile, u_rows)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert_no_edge_tensor_gather(mesh.log, C.shape[-1], batch=C.shape[0])
    res = {**_pt_result(torch, m, opt, old), **_pt_collectives(mesh.log),
           "peak_memory_bytes": peak, "edge_gather_check": "held"}
    res["step_ms"] = _ms_host(torch, lambda: step(tile, u_rows), reps)
    del model, opt, step
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def _pt_kernel_calls():
    """``_kernel_calls`` and every greedy call, with their arguments."""
    import lapgnn_tpu_torch.train.loss as loss_mod

    greedy = []
    with _kernel_calls() as calls, _wrapped(loss_mod, "greedy_total", _capture(greedy, clone=True)):
        calls["greedy_total"] = greedy
        yield calls


def _pt_hold(torch, calls, what):
    """The calls of ``_pt_kernel_calls`` against their plain versions:
    {kernel: (calls, largest difference)}."""
    from lapgnn_tpu_torch.ops.cuda.greedy import greedy_total_plain

    held = _hold_kernel_calls(torch, calls, what)
    err = 0.0
    for i, (args, got) in enumerate(calls["greedy_total"]):
        want = greedy_total_plain(*args)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"greedy kernel differs from its plain loop ({what}, call {i})")
        err = max(err, _max_abs_err(torch, got, want))
    held["greedy_total"] = (len(calls["greedy_total"]), err)
    return held


def _parallel_train_rank(rank, device, seed, out_dir):
    """One of the two gloo ranks on the one card: the DP step at data 2 x
    model 1 and 1 x 2, the sharded dual step on the 2 x 1 and 1 x 2 meshes,
    the sharded dual predict (2 x 1, both v modes); every K1 / K2 / greedy
    call held against its plain version.  It waits for ``out_dir/go``, so
    that the parent's unsharded references have the card to themselves."""
    import torch

    from lapgnn_tpu_torch.device import resolve_device
    from lapgnn_tpu_torch.parallel import dual_mesh, make_mesh, make_sharded_dual_predict
    from lapgnn_tpu_torch.parallel.dual import local_tile

    torch.cuda.set_device(0)
    dev = resolve_device(device)
    _load_kernels()
    _wait_for(Path(out_dir) / "go")
    inputs = torch.load(Path(out_dir) / "inputs.pt")
    inputs = {k: tuple(t.to(dev) for t in v) if isinstance(v, tuple) else v.to(dev)
              for k, v in inputs.items()}
    res = {"dp": {}, "dual": {}}
    since = _launches()
    with _pt_kernel_calls() as calls:
        for data, model in PT_DP_MESHES:
            mesh = make_mesh(data, model, device=device)
            res["dp"][f"{data}x{model}"] = _pt_dp_step(torch, mesh, inputs, 2)
        for row, col in PT_DUAL_MESHES:
            mesh = dual_mesh(row, col, device=device)
            res["dual"][f"{row}x{col}"] = _pt_dual_step(torch, mesh, inputs, 1)
        mesh = dual_mesh(2, 1, device=device)
        model, _ = _pt_dual_gnn(torch, mesh.device)
        tile = local_tile(inputs["predict"], mesh)
        mesh.log.clear()
        predict = make_sharded_dual_predict(model, mesh)
        u, v = predict(tile)
        torch.cuda.synchronize()
        res["predict"] = {"u": u.cpu(), "v": v.cpu(), **_pt_collectives(mesh.log),
                          "ms": _ms_host(torch, lambda: predict(tile), 2)}
        res["predict"]["v_hint_finite"] = bool(torch.isfinite(
            make_sharded_dual_predict(model, mesh, project=False)(tile)[1]).all())
        torch.cuda.synchronize()
    res["launches"] = _launches(since)
    res["held"] = _pt_hold(torch, calls, f"parallel_train rank {rank}")
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def _pt_world1(torch, seed, inputs):
    """World 1 under NCCL: the unsharded references of every step, each
    sharded step on the 1 x 1 mesh against them, the timed steps."""
    import datetime

    import torch.distributed as dist

    from lapgnn_tpu_torch.device import resolve_device
    from lapgnn_tpu_torch.parallel import dual_mesh, make_mesh
    from lapgnn_tpu_torch.parallel.launch import free_port
    from lapgnn_tpu_torch.train.trainer import make_train_step

    dev = resolve_device("cuda")
    refs, out = {}, {}
    # the unsharded OneGNN step (the trainer's) and its time
    model, opt = _pt_one_gnn(torch, dev)
    old = [p.detach().to("cpu", copy=True) for p in opt.params]
    C, u = inputs["dp"]
    step = make_train_step(model, opt, use_cost=True)
    m = step(C, u)
    torch.cuda.synchronize()
    refs["dp"] = _pt_result(torch, m, opt, old)
    out["dp_unsharded_step_ms"] = _ms_host(torch, lambda: step(C, u), 2)
    del model, opt, step
    # the unsharded dual step at (2, 1024), its peak memory and time
    model, opt = _pt_dual_gnn(torch, dev)
    old = [p.detach().to("cpu", copy=True) for p in opt.params]
    C, u = inputs["dual"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = _plain_dual_step(torch, model, opt, C, u)
    torch.cuda.synchronize()
    out["dual_unsharded_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    refs["dual"] = _pt_result(torch, m, opt, old)
    out["dual_unsharded_step_ms"] = _ms_host(torch, lambda: _plain_dual_step(torch, model, opt, C, u), 1)
    model.load_state_dict(_pt_dual_gnn(torch, "cpu")[0].state_dict())  # r5's weights again
    refs["predict"] = _plain_dual_predict(torch, model, inputs["predict"])
    del model, opt
    torch.cuda.empty_cache()

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        since = _launches()
        with _pt_kernel_calls() as calls:
            mesh = make_mesh(1, 1, device="cuda")
            dp = _pt_dp_step(torch, mesh, inputs, 2)
            dual = _pt_dual_step(torch, dual_mesh(1, 1, device="cuda"), inputs, 1)
        launches = _launches(since)
        held = _pt_hold(torch, calls, "parallel_train world 1")
    finally:
        dist.destroy_process_group()
    out["dp_1x1"] = {**_pt_against(torch, dp, refs["dp"], "DP step 1 x 1"),
                     **{k: dp[k] for k in ("step_ms", "collectives", "largest", "largest_op")}}
    out["dual_1x1"] = {**_pt_against(torch, dual, refs["dual"], "dual step 1 x 1"),
                       **{k: dual[k] for k in ("step_ms", "collectives", "largest", "largest_op",
                                               "peak_memory_bytes")}}
    return refs, out, launches, held


def phase_parallel_train(torch, seed):
    """Training under a mesh on the card at full width: the data-parallel
    OneGNN step (one_gnn_default: hidden 192, 4 layers, top-k 16, its
    weights, dropout 0) on a (32, 512) batch, the 2-D edge-partitioned
    DualGNN step (dual_gnn_r5: hidden 256, 6 layers, 4 heads, its weights,
    dropout 0) at (2, 1024) and its sharded predict at n = 2048.  World 1
    under NCCL computes the unsharded references (the trainer's OneGNN step;
    the dual step's dense features, model, surrogate loss and update; the
    dense forward and min-trick) and holds the 1 x 1 mesh's steps to them;
    two gloo ranks on the one card then run the DP step at data 2 x model 1
    and 1 x 2, the dual step on the 2 x 1 and 1 x 2 meshes and the predict
    on 2 x 1, each held to the same references: losses within 1e-5
    relative, gradients within 1e-4 max|g| + 1e-7, parameters within
    1e-4 max|dp| + 1e-7 (``_pt_against``), u and v within 1e-5 max|ref| +
    1e-6, the ranks' parameters bit-equal.  Every K1, K2 and greedy call
    held against its plain version; each dual log held to
    ``assert_no_edge_tensor_gather``; ms a step, each rank's peak memory at
    (2, 1024) beside the unsharded step's, the collectives a step and the
    largest.  Returns each kernel's launches on the path and its largest
    difference."""
    import json as _json
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from lapgnn_tpu_torch.parallel.launch import spawn_ranks

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(spawn_ranks, _parallel_train_rank, 2, args=("cuda", seed, tmp),
                                backend="gloo", timeout=300)
        try:
            from lapgnn_tpu_torch.device import resolve_device

            inputs = _pt_inputs(torch, seed, resolve_device("cuda"))
            torch.save({k: tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu()
                        for k, v in inputs.items()}, Path(tmp) / "inputs.pt")
            refs, world1, launches, held = _pt_world1(torch, seed, inputs)
            del inputs
            torch.cuda.empty_cache()
        finally:
            Path(tmp, "go").touch()
        world1_s = time.perf_counter() - t_phase
        ranks_run.result()
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(2)]
    held = [held]
    world2 = {}
    u_ref, v_ref = refs["predict"]
    for r, res in enumerate(ranks):
        out = {}
        for name, got in res["dp"].items():
            out[f"dp_{name}"] = {**_pt_against(torch, got, refs["dp"], f"DP step {name}, rank {r}"),
                                 **{k: got[k] for k in ("step_ms", "collectives", "largest",
                                                        "largest_op")}}
        for name, got in res["dual"].items():
            out[f"dual_{name}"] = {**_pt_against(torch, got, refs["dual"], f"dual step {name}, rank {r}"),
                                   **{k: got[k] for k in ("step_ms", "collectives", "largest",
                                                          "largest_op", "backward",
                                                          "peak_memory_bytes", "edge_gather_check")}}
        p = res["predict"]
        u_err = float((p["u"] - u_ref).abs().max())
        v_err = float((p["v"] - v_ref).abs().max())
        u_tol = PT_PREDICT_RTOL * float(u_ref.abs().max()) + 1e-6
        v_tol = PT_PREDICT_RTOL * float(v_ref.abs().max()) + 1e-6
        if u_err > u_tol or v_err > v_tol or not p["v_hint_finite"]:
            raise AssertionError(f"sharded dual predict, rank {r}: u {u_err} (tol {u_tol}), "
                                 f"v {v_err} (tol {v_tol}), v_hint finite {p['v_hint_finite']}")
        out["predict_2x1"] = {"u_max_abs_err": u_err, "v_max_abs_err": v_err, "u_tol": u_tol,
                              "v_tol": v_tol, **{k: p[k] for k in ("ms", "collectives", "largest")}}
        for name, count in res["launches"].items():
            launches[name] = launches.get(name, 0) + count
        held.append(res["held"])
        world2[f"rank{r}"] = out
    for kind in ("dp", "dual"):
        for name in ranks[0][kind]:
            if not all(torch.equal(a, b) for a, b in zip(ranks[0][kind][name]["params"],
                                                         ranks[1][kind][name]["params"])):
                raise AssertionError(f"{kind} {name}: the ranks' parameters differ after the step")
    for k in ("col_min", "min_trick", "greedy_total"):
        if launches.get(k, 0) < 1:
            raise AssertionError(f"the parallel_train path launched no {k}: {launches}")
    errs = {k: max(h[k][1] for h in held) for k in ("col_min", "min_trick", "greedy_total")}
    calls = {k: sum(h[k][0] for h in held) for k in ("col_min", "min_trick", "greedy_total")}
    phase_s = time.perf_counter() - t_phase
    gb = 1e9
    _emit({"phase": "parallel_train", "dp_batch": PT_DP, "dual_batch": PT_DUAL,
           "predict_n": PT_PREDICT_N, "checkpoints": ["artifacts/one_gnn_default",
                                                      "artifacts/dual_gnn_r5"],
           "world1_nccl": world1, "world2_gloo_one_card": world2, "launches": launches,
           "kernel_calls_held": calls, "max_abs_err": errs, "world1_seconds": world1_s,
           "phase_seconds": phase_s})
    print("parallel_train: " + _json.dumps({
        "ms_per_step": {"dp_unsharded": world1["dp_unsharded_step_ms"],
                        "dp_1x1": world1["dp_1x1"]["step_ms"],
                        **{f"dp_{m}_rank{r}": world2[f"rank{r}"][f"dp_{m}"]["step_ms"]
                           for r in range(2) for m in ("2x1", "1x2")},
                        "dual_unsharded": world1["dual_unsharded_step_ms"],
                        "dual_1x1": world1["dual_1x1"]["step_ms"],
                        **{f"dual_{m}_rank{r}": world2[f"rank{r}"][f"dual_{m}"]["step_ms"]
                           for r in range(2) for m in ("2x1", "1x2")}},
        "dual_peak_memory_gb_at_2x1024": {
            "unsharded": world1["dual_unsharded_peak_memory_bytes"] / gb,
            "1x1": world1["dual_1x1"]["peak_memory_bytes"] / gb,
            **{f"{m}_rank{r}": world2[f"rank{r}"][f"dual_{m}"]["peak_memory_bytes"] / gb
               for r in range(2) for m in ("2x1", "1x2")}},
        "collectives_per_step": {f"{kind}_{m}": (world2["rank0"][f"{kind}_{m}"]["collectives"],
                                                 world2["rank0"][f"{kind}_{m}"]["largest"])
                                 for kind in ("dp", "dual") for m in ("2x1", "1x2")},
        "edge_gather_check": "held on every dual step's log",
    }), flush=True)
    if phase_s > PARALLEL_TRAIN_PHASE_LIMIT_S:
        raise AssertionError(f"the parallel_train phase took {phase_s:.1f} s, above "
                             f"{PARALLEL_TRAIN_PHASE_LIMIT_S} s")
    return {"launches": launches, "max_abs_err": errs}


def _time_ms(torch, fn, reps, flush, queued=True, flush_by_read=False):
    """Median CUDA-event time of ``fn`` with L2 flushed before each launch:
    by ``flush.zero_()``, which leaves L2 full of dirty lines that the timed
    reads must evict, or (``flush_by_read``) by a sum over ``flush``, which
    leaves clean lines.

    Queued (the default): a spin kernel first, then every rep's flush, start
    event, launch and end event without a synchronize between reps, and one
    synchronize at the end.  The host enqueues the reps while the card
    spins, so the card finds each launch already queued and the host's
    launch latency stays out of the event windows.  ``queued=False``
    synchronises after every rep instead, so each rep starts on an idle
    card and its window holds the host's launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    for start, end in zip(starts, ends):
        if flush_by_read:
            flush.sum()
        else:
            flush.zero_()
        start.record()
        fn()
        end.record()
        if not queued:
            end.synchronize()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _device_launch_profile(torch, fn, reps=20):
    """Device time (us) and number of ``fn``'s kernels per call, from
    torch.profiler, with the data left in L2 between calls; (None, None)
    where the profiler saw none.  The profiler now and then loses a few
    kernel events: a trace in which a kernel's count is no multiple of the
    calls is taken again, up to four times, and the last is kept as it is."""
    for _ in range(3):
        fn()
    rows = []
    for _ in range(4):
        rows, _ = _profile(torch, lambda: [fn() for _ in range(reps)])
        if rows and all(r[2] % reps == 0 for r in rows):
            break
    if not rows:
        return None, None
    # by kernel name: its mean time, times how often a call launches it
    per_call = [max(1, round(r[2] / reps)) for r in rows]
    return sum(r[0] / r[2] * k for r, k in zip(rows, per_call)), sum(per_call)


def _four_states(torch, fn, reps, flush, no_flush):
    """``fn`` timed in the four states a kernel is read in: L2 flushed by
    ``zero_`` (dirty lines), flushed by a read (clean lines), its data left
    in L2 (both by events), and device time a call under torch.profiler."""
    us, kernels = _device_launch_profile(torch, fn)
    return {
        "ms": _time_ms(torch, fn, reps, flush),
        "ms_read_flush": _time_ms(torch, fn, reps, flush, flush_by_read=True),
        "ms_l2_resident": _time_ms(torch, fn, reps, no_flush),
        "device_us_per_launch_l2_resident": us,
        "kernels_per_call": kernels,
    }


# K1 / K2's geometries timed side by side; two_launch is the earlier kernel,
# read first and last.
COLMIN_VARIANTS = {
    "two_launch": {"path": "two_launch"},
    "cluster_ahead4": {"path": "cluster", "ahead": 4},
    "cluster_ahead8": {"path": "cluster", "ahead": 8},
    "cluster_of_2": {"path": "cluster", "cluster": 2},
    "cluster_of_4": {"path": "cluster", "cluster": 4},
    "cluster_of_8": {"path": "cluster", "cluster": 8},
    "two_launch_again": {"path": "two_launch"},
}


# (rows, m) on either side of the width below which K1 / K2 take two_launch.
COLMIN_NARROW_SHAPES = ((512, 512), (4096, 256), (8192, 1024), (8192, 2048), (16384, 7),
                        (16384, 128), (16384, 512), (16384, 2048), (32768, 256),
                        (32768, 1024), (65536, 64), (65536, 512))


def _col_min_narrow(torch, reps, flush, no_flush, seed):
    """K2 on narrow matrices, both paths, cold and with C left in L2: what
    ``col_min_geometry``'s choice of path rests on."""
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_geometry, col_min_kernel

    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    out = []
    for rows, m in COLMIN_NARROW_SHAPES:
        C = torch.rand((1, rows, m), generator=g, device="cuda")
        u = torch.randn((1, rows), generator=g, device="cuda") * 0.3
        row = {"rows": rows, "m": m, "picked": col_min_geometry(rows, m, True).path}
        for path in ("two_launch", "cluster"):
            fn = lambda: col_min_kernel(C, u, path=path)  # noqa: E731
            row[path] = {"ms": _time_ms(torch, fn, reps, flush),
                         "ms_l2_resident": _time_ms(torch, fn, reps, no_flush)}
        out.append(row)
    return out


def _col_min_states(torch, C, u, reps, flush, no_flush):
    """K1 and K2 at this size: the wrapper as the main path calls it in the
    four states, every variant in the same states, and ``torch.amin`` over
    the same matrix (one read of C: K1's library call, and the yardstick of
    K2, which has none of its own)."""
    from lapgnn_tpu_torch.ops.cuda import col_min, min_trick
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_geometry, col_min_kernel

    B, n, m = C.shape
    amin = _four_states(torch, lambda: torch.amin(C, dim=-2), reps, flush, no_flush)
    geometry = col_min_geometry(n, m, C.data_ptr() % 16 == 0, batch=B)
    out = {}
    for name, kern, uu in (("col_min", lambda: col_min(C), None),
                           ("min_trick", lambda: min_trick(C, u), u)):
        row = _four_states(torch, kern, reps, flush, no_flush)
        row["geometry"] = {"path": geometry.path, "cluster": geometry.cluster,
                           "warps": geometry.warps, "ahead": geometry.ahead,
                           "rows_per_block": geometry.rows_per_block,
                           "blocks": geometry.blocks, "vector": geometry.vector}
        row["variants_ms"] = {
            label: _four_states(torch, lambda: col_min_kernel(C, uu, **force),
                                reps, flush, no_flush)
            for label, force in COLMIN_VARIANTS.items()
        }
        row["amin_over_columns"] = amin
        out[name] = row
    return out


def _two_min_yardsticks(torch, C, v, reps, flush, no_flush):
    """What K4's times at this size stand beside: the event window's floor (a
    launch on 8 x 128 elements through the same wrapper), a row reduction of
    the same matrix by the framework (``torch.amin`` over rows: one read of
    C, not K4's function), both kernels flushed by a read instead of by
    ``zero_``, and their device time per launch under the profiler."""
    from lapgnn_tpu_torch.ops.cuda import two_min

    tiny_C = torch.rand((1, 8, 128), device="cuda")
    tiny_v = torch.zeros((1, 128), device="cuda")
    kern = lambda: two_min(C, v)  # noqa: E731
    amin = lambda: torch.amin(C, dim=-1)  # noqa: E731
    return {
        "event_floor_ms": _time_ms(torch, lambda: two_min(tiny_C, tiny_v), reps, no_flush),
        "ms_read_flush": _time_ms(torch, kern, reps, flush, flush_by_read=True),
        "device_us_per_launch_l2_resident": _device_launch_profile(torch, kern)[0],
        "row_amin_ms": _time_ms(torch, amin, reps, flush),
        "row_amin_ms_l2_resident": _time_ms(torch, amin, reps, no_flush),
        "row_amin_ms_read_flush": _time_ms(torch, amin, reps, flush, flush_by_read=True),
        "row_amin_device_us_per_launch_l2_resident": _device_launch_profile(torch, amin)[0],
    }


def _two_min_variants(torch, C, v, reps, flush, no_flush):
    """K4's time with each compare state and either unroll, cold and with C
    left in L2."""
    from lapgnn_tpu_torch.ops.cuda.twomin import two_min_kernel

    out = {}
    for state in ("keys", "floats"):
        for unroll in (4, 1):
            fn = lambda: two_min_kernel(C, v, state=state, unroll=unroll)  # noqa: E731
            out[f"{state}_unroll{unroll}"] = {
                "ms": _time_ms(torch, fn, reps, flush),
                "ms_l2_resident": _time_ms(torch, fn, reps, no_flush),
            }
    return out


def _solver_inputs(torch, C):
    """The arguments a seeded solve of C hands S3, S2 and S1, from the
    min-trick seed of C's row minima: the tight matrix, the greedy matching
    with the seed's v (ARR's start), and the state after ARR."""
    from lapgnn_tpu_torch.solver.jv import Matching
    from lapgnn_tpu_torch.solver.seeded import greedy_tight_matching, jacobi_arr

    n = C.shape[0]
    v = (C - C.amin(1)[:, None]).amin(0)
    u = (C - v[None, :]).amin(1)
    tight = (C - u[:, None] - v[None, :]).abs() <= 1e-5
    x, y = greedy_tight_matching(tight)
    start = Matching(x, y, v)
    return tight, start, jacobi_arr(C, start, max_rounds=max(64, n // 32))


def _free_rows_a_round(torch, C, tight, start, rounds):
    """The free rows each round of S3 and of S2 reads, from their plain
    loops on the card: a row partition that holds every row and records
    how many rows are free each time a round asks (once a round)."""
    from lapgnn_tpu_torch.ops.cuda.twomin import two_min_plain
    from lapgnn_tpu_torch.ops.partition import RowPartition
    from lapgnn_tpu_torch.solver.jv import SolveStats
    from lapgnn_tpu_torch.solver.seeded import _greedy_tight_matching_eager, _jacobi_arr_eager

    class Recording(RowPartition):
        def __init__(self):
            self.free = []

        def local(self, x):
            self.free.append(int((x < 0).sum()))
            return x

    greedy, arr = Recording(), Recording()
    _greedy_tight_matching_eager(tight, SolveStats(), greedy)
    _jacobi_arr_eager(C, start, rounds, 0.0, SolveStats(), arr, bid=two_min_plain)
    return greedy.free, arr.free


def _solver_times(torch, C, flush, reps):
    """S1-S3 on the arguments a seeded solve of C hands them: each kernel's
    CUDA-event ms (L2 flushed before each call) beside its plain loop's
    host-clock ms (each condition is a host read), its loop count, launches
    a call, and the bound from that count (``_solver_bound_ms``)."""
    from lapgnn_tpu_torch.ops.cuda import arr_auction, augment_sweep, greedy_match
    from lapgnn_tpu_torch.ops.cuda.arr import arr_auction_plain
    from lapgnn_tpu_torch.ops.cuda.augment import augment_sweep_plain
    from lapgnn_tpu_torch.ops.cuda.greedy_match import greedy_match_plain

    n = C.shape[0]
    tight, start, after = _solver_inputs(torch, C)
    rounds = max(64, n // 32)
    free_greedy, free_arr = _free_rows_a_round(torch, C, tight, start, rounds)
    s1_rows = _s1_rows_read(torch, C, after)
    calls = {
        "greedy_match": (lambda c: greedy_match(tight, c[0:1]),
                         lambda c: greedy_match_plain(tight, c[0:1]), 0, 1),
        "arr_auction": (lambda c: arr_auction(C, *start, rounds, 0.0, c[1:2]),
                        lambda c: arr_auction_plain(C, *start, rounds, 0.0, c[1:2]), 1, 4),
        "augment_sweep": (lambda c: augment_sweep(C, *after, c[2:]),
                          lambda c: augment_sweep_plain(C, *after, c[2:]), 3, 4),
    }
    out = {}
    for name, (kern, plain, slot, itemsize) in calls.items():
        counts = torch.zeros(5, dtype=torch.int64, device=C.device)
        since = _launches()
        kern(counts)
        torch.cuda.synchronize()
        launched = _launches(since)[name]
        count = int(counts[slot])
        scratch = torch.zeros(5, dtype=torch.int64, device=C.device)
        rows_read = {"greedy_match": sum(free_greedy), "arr_auction": sum(free_arr),
                     "augment_sweep": s1_rows["rows_read"]}[name]
        bound, by, every_read = _solver_bound_ms(name, rows_read * n, n, itemsize)
        out[name] = {
            "ms": _time_ms(torch, lambda: kern(scratch), reps, flush),
            "plain_ms": _ms_host(torch, lambda: plain(scratch), 1 if n > N_E2E else 3),
            "library_ms": None,
            "bound_ms": bound, "bound_by": by, "every_read_from_hbm_ms": every_read,
            "loop_count": count, "matrix_rows_read": rows_read,
            "loop": {"greedy_match": "rounds", "arr_auction": "rounds",
                     "augment_sweep": "sweeps"}[name],
            "launches_a_call": launched,
        }
    s1 = out["augment_sweep"]
    if s1["loop_count"] != s1_rows["sweeps"]:
        raise AssertionError(f"S1's sweeps {s1['loop_count']} != its plain loop's "
                             f"{s1_rows['sweeps']}")
    # the bound if every sweep read every row
    s1["bound_every_row_ms"], s1["bound_every_row_by"], _ = _solver_bound_ms(
        "augment_sweep", s1["loop_count"] * n * n, n, 4)
    s1["changed_rows"] = s1_rows["changed_rows"]
    s1.update(_s1_layouts(torch, C, after, flush, reps))
    loops = {name: out[name]["loop_count"] for name in ("arr_auction", "greedy_match")}
    for name, extra in _auction_variants(torch, C, start, rounds, loops, flush, reps).items():
        out[name].update(extra)
    return out


def _auction_variants(torch, C, start, rounds, loops, flush, reps):
    """S2's and S3's grids on C: S2's layout and its other layout forced
    (CUDA events, L2 flushed), and each one's sync floor: its rounds on
    this state (``loops``; one barrier a round, S2 in float32) times one
    grid barrier timed alone on its own grid (``augment.barrier_bench``,
    median of 5 launches of 20,000 barriers)."""
    import importlib

    from lapgnn_tpu_torch.ops.cuda._lib import sm_count
    from lapgnn_tpu_torch.ops.cuda.arr import _arr, arr_geometry, arr_layout
    from lapgnn_tpu_torch.ops.cuda.augment import barrier_bench

    gm_mod = importlib.import_module("lapgnn_tpu_torch.ops.cuda.greedy_match")
    n, sms = C.shape[0], sm_count(C.device)
    scratch = torch.zeros(1, dtype=torch.int64, device=C.device)
    iters = 20_000
    layout = arr_layout(n, C.element_size(), sms)
    other = "global" if layout == "resident" else "resident"
    out = {}
    for name, g in (("arr_auction", arr_geometry(n, C.element_size(), sms, 1, layout)),
                    ("greedy_match", gm_mod.greedy_match_geometry(n, sms, 1))):
        per_barrier = _time_ms(torch, lambda: barrier_bench(C.device, g, iters), 5, flush) / iters
        out[name] = {"blocks": g.blocks, "smem_bytes": g.smem_bytes,
                     "barrier_us": per_barrier * 1e3, "barriers": loops[name],
                     "sync_floor_ms": loops[name] * per_barrier}
    out["arr_auction"].update({
        "layout": layout,
        f"{other}_ms": _time_ms(
            torch, lambda: _arr(C, *start, rounds, 0.0, scratch, layout=other), reps, flush)})
    return out


def _s1_rows_read(torch, C, after):
    """The matrix rows S1 must read on the state ``after``: every row once a
    round (red) and, each sweep, the rows whose e changed since the last
    one (the rest cannot improve a column), counted by the plain loop on the
    card with its sweeps replaced by their transcription over the changed
    rows (``augment.sweeps_by_frontier``), which must give the plain loop's
    result.  Returns the rows read, the changed rows and the sweeps."""
    import lapgnn_tpu_torch.solver.jv as jv_mod
    from lapgnn_tpu_torch.ops.cuda.augment import augment_sweep_plain, sweeps_by_frontier

    changed = []

    def frontier(red, free_row, x_safe, d0, pred0, max_sweeps, free_col=None, stats=None,
                 part=None):
        d, pred, sweeps = sweeps_by_frontier(red, free_row, x_safe, d0, pred0, free_col,
                                             max_sweeps, changed)
        stats.sweeps += sweeps
        return d, pred

    counts = torch.zeros(3, dtype=torch.int64, device=C.device)
    with _wrapped(jv_mod, "_sweep_shortest_paths", lambda _: frontier):
        got = augment_sweep_plain(C, *after, counts)
    want = augment_sweep_plain(C, *after, torch.zeros(3, dtype=torch.int64, device=C.device))
    differ = _same_solve(torch, {"x": got[0], "y": got[1], "v": got[2], "used_fallback": False,
                                 "counts": {}},
                         {"x": want[0], "y": want[1], "v": want[2], "used_fallback": False,
                          "counts": {}})
    if differ:
        raise AssertionError(f"S1's sweeps over the changed rows differ from the plain loop: "
                             f"{differ}")
    rounds, sweeps = int(counts[0]), int(counts[1])
    n = C.shape[0]
    return {"rows_read": rounds * n + sum(changed), "changed_rows": sum(changed),
            "sweeps": sweeps}


def _s1_layouts(torch, C, after, flush, reps):
    """S1's layout on C; where it is the resident one, S1 again with its
    staged layout forced and with its tile loaded by coalesced loads (CUDA
    events, L2 flushed), and the sweeps' sync floor: S1's sweeps on this
    state times one grid barrier timed alone on S1's grid
    (``augment.barrier_bench``, median of 5 launches of 20,000 barriers),
    with and without the stop test's atomics, reset and read."""
    from lapgnn_tpu_torch.ops.cuda._lib import sm_count
    from lapgnn_tpu_torch.ops.cuda.augment import (_augment, augment_geometry, augment_layout,
                                                   barrier_bench)

    n = C.shape[0]
    layout = augment_layout(n, C.element_size(), sm_count(C.device))
    if layout != "resident":
        return {"layout": layout}
    counts = torch.zeros(3, dtype=torch.int64, device=C.device)
    _augment(C, *after, counts)
    sweeps = int(counts[1])
    scratch = torch.zeros(3, dtype=torch.int64, device=C.device)
    g = augment_geometry(n, C.element_size(), sm_count(C.device), 1, "resident")
    iters = 20_000
    per_barrier = {}
    for payload in (False, True):
        ms = _time_ms(torch, lambda: barrier_bench(C.device, g, iters, payload), 5, flush)
        per_barrier[payload] = ms / iters
    return {
        "layout": layout, "blocks": g.blocks, "tile": g.tile,
        "staged_ms": _time_ms(torch, lambda: _augment(C, *after, scratch, layout="staged"),
                              reps, flush),
        "resident_loads_ms": _time_ms(
            torch, lambda: _augment(C, *after, scratch, layout="resident", tma=False), reps,
            flush),
        "barrier_us": per_barrier[False] * 1e3,
        "barrier_with_stop_words_us": per_barrier[True] * 1e3,
        "sync_floor_ms": sweeps * per_barrier[False],
        "sync_floor_with_stop_words_ms": sweeps * per_barrier[True],
    }


def _sinkhorn_times(torch, C, flush, no_flush, seed, reps):
    """The ladder on a (1, n, n) uniform batch: the kernel (L2 flushed, and
    left in L2), the eager loop on the card, the bound; at the e2e size also
    the seed policy ``auto_select_seed`` with the kernel and with the eager
    loop (host clock, each call synchronised: the eager loop's time is its
    launches)."""
    import lapgnn_tpu_torch.ops.cuda as cuda_ops
    from lapgnn_tpu_torch.ops.cuda import sinkhorn as ksink
    from lapgnn_tpu_torch.ops.sinkhorn import auto_select_seed

    cost_r, u0, scale, eps_rel, iters = _sinkhorn_inputs(torch, C, seed)
    args = (cost_r, C, u0, scale, eps_rel, iters)
    n = C.shape[-1]
    g = ksink.sinkhorn_geometry(n, torch.cuda.get_device_properties(0).multi_processor_count)
    half_passes = 2 * len(eps_rel) * iters
    bound, by, one_read = _sinkhorn_bound_ms(C.shape[0], n, half_passes)
    row = {
        "ms": _time_ms(torch, lambda: ksink.sinkhorn_ladder_kernel(*args), reps, flush),
        "ms_l2_resident": _time_ms(torch, lambda: ksink.sinkhorn_ladder_kernel(*args), reps,
                                   no_flush),
        "plain_ms": _time_ms(torch, lambda: ksink.sinkhorn_ladder_plain(*args), max(3, reps // 4),
                             flush),
        "library_ms": None, "bound_ms": bound, "bound_by": by, "one_read_ms": one_read,
        "half_passes": half_passes, "layout": "resident" if g.resident else "streamed",
        "blocks": g.blocks, "rows_a_block": g.rows,
        "max_abs_err": _hold_sinkhorn(torch, args, ksink.sinkhorn_ladder_kernel(*args),
                                      f"times, n={n}"),
    }
    if n == N_E2E:
        from lapgnn_tpu_torch.ops.dual import fast_min_trick
        from lapgnn_tpu_torch.ops.rank1 import rank1_duals
        from lapgnn_tpu_torch.ops.sentinels import clip_cost_sentinels
        from lapgnn_tpu_torch.ops.sinkhorn import _robust_scale, uniq_argmin_count

        v0 = fast_min_trick(C, u0)
        # the seed policy's pieces, each alone (host clock, synchronised)
        parts = {"clip_cost_sentinels": lambda: clip_cost_sentinels(C),
                 "robust_scale": lambda: _robust_scale(cost_r),
                 "rank1_duals": lambda: rank1_duals(C), "min_trick": lambda: fast_min_trick(C, u0),
                 "uniq_argmin_count": lambda: uniq_argmin_count(C, u0, v0),
                 "ladder_kernel": lambda: ksink.sinkhorn_ladder_kernel(*args)}
        with torch.inference_mode():
            row["seed_parts_ms_host_clock"] = {k: _ms_host(torch, f, 10) for k, f in parts.items()}
            row["seed_policy_ms_host_clock"] = _ms_host(torch, lambda: auto_select_seed(C, u0), 10)
            real = cuda_ops.sinkhorn_ladder
            cuda_ops.sinkhorn_ladder = ksink.sinkhorn_ladder_plain
            try:
                row["seed_policy_eager_ladder_ms_host_clock"] = _ms_host(
                    torch, lambda: auto_select_seed(C, u0), 10)
            finally:
                cuda_ops.sinkhorn_ladder = real
    return row


# The dual_edge phase: the serving cell's shape and the training cell's.
DUAL_EDGE_TIMED = ((1, 2048), (4, 512))  # (B, n)
DUAL_EDGE_RAGGED = ((1, 1), (1, 3), (3, 33), (1, 257), (3, 257))
DUAL_EDGE_U_GAP = 2e-5  # the serving cell's limit on u


def _dual_edge_bound_ms(B: int, n: int, out: int):
    """Least time of one edge-MLP launch on (B, n, n) edges: 2·10·128 +
    2·128·128 + 2·128·out float32 operations an edge (fc1, fc2 and the
    folded fc3) against 40 bytes read and 4·out written an edge.  Returns
    (bound, what bounds it)."""
    edges = B * n * n
    t_ops = edges * (2 * 10 * 128 + 2 * 128 * 128 + 2 * 128 * out) / F32_OPS_PER_S * 1e3
    t_bytes = edges * (40 + 4 * out) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _eager_edge_terms(torch, layer, x):
    """The unfolded eager edge stage (``DualLayer.forward`` off the kernel):
    fc1, GELU, fc2, GELU, fc3, then the block-diagonal edge weight."""
    from torch.nn import functional as F

    e = F.gelu(layer.edge_fc1(x), approximate="none")
    e = layer.edge_fc3(F.gelu(layer.edge_fc2(e), approximate="none"))
    return torch.matmul(e.view(-1, layer.hidden_dim), layer._edge_weight())


def _hold_dual_edge(torch, x, w, what):
    """The kernel's terms on (x, w) against the plain version on the same
    card: NaN and infinities where it has them, the rest within the module's
    tolerance.  Returns the largest difference over its instance's largest
    finite term."""
    from lapgnn_tpu_torch.ops.cuda import dual_edge as kedge

    got = kedge.dual_edge_terms(x, *w)
    want = kedge.dual_edge_terms_plain(x, *w)
    fin = torch.isfinite(want)
    inf = torch.isinf(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(got[inf], want[inf]):
        raise AssertionError(f"dual_edge_terms: NaN or infinities differ from the plain "
                             f"version ({what})")
    diff = torch.where(fin, (got - want).abs(), torch.zeros_like(want))
    tol = kedge.tolerance(want)
    if not bool((diff <= tol).all()):
        raise AssertionError(f"dual_edge_terms: {float(diff.max())} from the plain version, "
                             f"tolerance {float(tol.max())} ({what})")
    scale = (tol / kedge.RTOL).clamp_min(torch.finfo(torch.float32).tiny)
    return float((diff / scale).max())


def phase_dual_edge(torch, seed):
    """The DualGNN edge MLP kernel against its plain version and inside
    dual_gnn_r5's forward, then its times (see the module's phase 15)."""
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES
    from lapgnn_tpu_torch.ops.cuda import dual_edge as kedge
    from lapgnn_tpu_torch.ops.features import graph_features
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint, params_from_flax

    params, meta, _ = load_checkpoint(DUAL_CHECKPOINT)
    model = build_model_from_meta(meta)
    model.load_state_dict(params_from_flax(params))
    model.to("cuda")
    for p in model.parameters():
        p.requires_grad_(False)
    layer = model.layer[0]
    wf, bf = kedge.fold_edge_weights(layer.edge_fc3.weight, layer.edge_fc3.bias,
                                     layer._edge_weight())
    w = (layer.edge_fc1.weight, layer.edge_fc1.bias, layer.edge_fc2.weight,
         layer.edge_fc2.bias, wf, bf)
    rng = np.random.default_rng(seed + 2100)

    def feats(fam, B, n):
        C = np.stack([FAMILIES[fam](n, rng) for _ in range(B)]).astype(np.float32)
        return graph_features(torch.from_numpy(C).cuda())

    errs = {}
    with torch.inference_mode():
        for B, n in DUAL_EDGE_RAGGED + DUAL_EDGE_TIMED:
            errs[f"uniform_{B}x{n}"] = _hold_dual_edge(torch, feats("uniform", B, n).edge_feat, w,
                                                       f"uniform ({B}, {n})")
        x = feats("sparse", 2, 257).edge_feat
        if not float(x.amin()) < -1e14:
            raise AssertionError(f"the sparse family's features reach {float(x.amin())}")
        errs["sparse_2x257"] = _hold_dual_edge(torch, x, w, "sparse (2, 257)")
        clean = feats("noisy_linear", 1, 33).edge_feat
        x = clean.clone()
        x[0, 0, 0, 3], x[0, 1, 2, 0], x[0, 5, 5, 7] = float("nan"), float("inf"), -float("inf")
        x[0, 9, 4, :] = float("inf")
        errs["nan_inf_1x33"] = _hold_dual_edge(torch, x, w, "NaN and infinities")
        buf = torch.cat([torch.zeros(1, device="cuda"), clean.flatten()])
        errs["unaligned_1x33"] = _hold_dual_edge(torch, buf[1:].view(clean.shape), w,
                                                 "unaligned view")

    # dual_gnn_r5's whole forward, kernel against the unfolded eager chain
    with torch.no_grad():
        gf = feats("noisy_linear", 1, N_E2E)
    with torch.inference_mode():
        since = _launches()
        u = model(gf.edge_feat, gf.row_feat, gf.col_feat)["u"]
        launches = _launches(since)["dual_edge_terms"]
    with torch.enable_grad():  # off the kernel; no parameter requires a gradient
        u_eager = model(gf.edge_feat, gf.row_feat, gf.col_feat)["u"]
    u_gap = float((u - u_eager).norm() / u_eager.norm())
    if launches != model.num_layers or not u_gap <= DUAL_EDGE_U_GAP:
        raise AssertionError(f"dual_gnn_r5 at n = {N_E2E}: {launches} kernel launches, u "
                             f"{u_gap} from the eager forward (limit {DUAL_EDGE_U_GAP})")
    del gf, u, u_eager

    # cell D's call: solve(C) of the serving pipeline with r5 on the n = 2048
    # instances, one launch a layer, each cost within the cell's opt_gap of SciPy's
    pipe = WarmStartPipeline(build_model_from_meta(meta), params, mode="device",
                             normalize_costs=False)
    serve = {}
    for f, C in _e2e_costs(seed + 2101).items():
        since = _launches()
        got = float(pipe.solve(C)["cost"][0])
        torch.cuda.synchronize()
        opt = _scipy_opt(C.astype(np.float64))
        serve[f] = _launches(since)["dual_edge_terms"]
        if serve[f] != model.num_layers or not abs(got - opt) <= 1e-5 * max(1.0, abs(opt)):
            raise AssertionError(f"dual_gnn_r5 serving {f} at n = {N_E2E}: {serve[f]} kernel "
                                 f"launches, cost {got!r} against SciPy's {opt!r}")
    del pipe

    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    times = {}
    with torch.inference_mode():
        for B, n in DUAL_EDGE_TIMED:
            x = feats("uniform", B, n).edge_feat
            bound, by = _dual_edge_bound_ms(B, n, wf.shape[-1])
            ms = _time_ms(torch, lambda: kedge.dual_edge_terms(x, *w), 20, flush)
            times[f"{B}x{n}"] = {
                "ms": ms,
                "plain_ms": _time_ms(torch, lambda: kedge.dual_edge_terms_plain(x, *w), 5, flush),
                "eager_unfolded_ms": _time_ms(torch, lambda: _eager_edge_terms(torch, layer, x),
                                              5, flush),
                "library_ms": None, "bound_ms": bound, "bound_by": by,
                "bound_share_pct": 100.0 * bound / ms,
            }
            del x
    res = {"max_rel_err": max(errs.values()), "rel_err": errs, "u_gap_2048": u_gap,
           "launches_a_forward": launches, "launches_a_serving_call": serve, "times": times}
    _emit({"phase": "dual_edge", **res})
    return res


GRAPH_FEATURES_KINDS = ("uniform", "noisy_linear", "sparse", "tie", "signed_zeros", "nan_row")
GRAPH_FEATURES_SHAPES = ((1, 1, 1), (1, 2, 2), (1, 17, 33), (2, 33, 17), (4, 512, 512),
                         (1, 2048, 2048))  # (B, n, m)
GRAPH_FEATURES_TIMED = ((1, 2048), (4, 512))  # (B, n): cell D's call, cell C's step


def _graph_features_bound_ms(B: int, n: int, m: int):
    """Least time of one ``graph_features`` call on a (B, n, m) float32
    cost: C read once and the edge tensor (10 floats an entry) and the node
    features (14 a row and a column) written once, over the HBM rate; the
    float32 work, a few operations an entry, is far below it.  Returns
    (bound, what bounds it, the sorts' compare-exchanges, the design's
    traffic in ms at the same rate): a bitonic network over each row padded
    to the next power of two L, and over each column, L/2·log2 L·(log2 L +
    1)/2 a line, integer work the rate table does not cover; the design
    reads C in both passes, writes the column ranks and reads them back, and
    the columns' min, tie and entropy (16 B a column) likewise."""
    def exchanges(length):
        L = 1 << (length - 1).bit_length()
        lg = L.bit_length() - 1
        return L // 2 * lg * (lg + 1) // 2

    nodes = B * (n + m) * 14 * 4
    nbytes = B * n * m * (4 + 10 * 4) + nodes
    design = B * n * m * (2 * 4 + 2 * 4 + 10 * 4) + nodes + 2 * B * m * 16
    return (nbytes / HBM_BYTES_PER_S * 1e3, "bytes",
            B * (n * exchanges(m) + m * exchanges(n)), design / HBM_BYTES_PER_S * 1e3)


def phase_graph_features(torch, seed):
    """DualGNN's graph-feature kernels against the plain version, their
    launches and host syncs in cell D's call and cell C's step, then their
    times (see the module's phase 16)."""
    import numpy as np

    from lapgnn_tpu_torch import tracing
    from lapgnn_tpu_torch.data.generators import FAMILIES
    from lapgnn_tpu_torch.ops.cuda.graph_features import check_against_plain
    from lapgnn_tpu_torch.ops.features import graph_features, graph_features_plain
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint, params_from_flax
    from lapgnn_tpu_torch.train.dual_trainer import make_dual_train_step
    from lapgnn_tpu_torch.train.schedule import make_optimizer

    rng = np.random.default_rng(seed + 2300)

    def cost(kind, B, n, m):
        if kind == "signed_zeros":
            vals = np.array([-0.0, 0.0, 1.0, -1.0, 0.5], dtype=np.float32)
            C = rng.choice(vals, size=(B, n, m))
        elif kind == "nan_row":  # a NaN in every third entry of one row
            C = rng.uniform(0.0, 1.0, size=(B, n, m))
            C[:, n // 2, ::3] = np.nan
        else:
            C = np.stack([FAMILIES[kind](max(n, m), rng)[:n, :m] for _ in range(B)])
        return torch.from_numpy(C.astype(np.float32)).cuda()

    ulps = {}
    with torch.inference_mode():
        for kind in GRAPH_FEATURES_KINDS:
            for B, n, m in GRAPH_FEATURES_SHAPES:
                C = cost(kind, B, n, m)
                try:
                    ulps[f"{kind}_{B}x{n}x{m}"] = check_against_plain(
                        C, graph_features(C), graph_features_plain(C))
                except AssertionError as e:
                    raise AssertionError(f"{e} ({kind} ({B}, {n}, {m}))") from None
    worst = {k: max(u[k] for u in ulps.values()) for k in next(iter(ulps.values()))}

    def counted(fn):
        fn()
        torch.cuda.synchronize()
        before = tracing.counters()
        fn()
        torch.cuda.synchronize()
        after = tracing.counters()
        return {"launches": after.get("launch.graph_features", 0)
                - before.get("launch.graph_features", 0),
                "host_syncs": after["host_syncs"] - before["host_syncs"]}

    # cell D's call (the serving pipeline with r5 at n = 2048) and cell C's
    # step (r5's train step at (4, 512)): two launches each
    params, meta, _ = load_checkpoint(DUAL_CHECKPOINT)
    pipe = WarmStartPipeline(build_model_from_meta(meta), params, mode="device",
                             normalize_costs=False)
    C = _e2e_costs(seed + 2301)["uniform"]
    d_call = counted(lambda: pipe.solve(C))
    del pipe
    model = build_model_from_meta(meta)
    model.load_state_dict(params_from_flax(params))
    model.cuda()
    step = make_dual_train_step(model, make_optimizer(list(model.parameters()), 1e-3))
    cost4, u4 = cost("uniform", 4, 512, 512), torch.zeros(4, 512, device="cuda")
    gen = torch.Generator().manual_seed(seed)  # as the cell's: a card generator's draws sync
    c_step = counted(lambda: step(cost4, u4, gen))
    del model, step, cost4
    if d_call["launches"] != 2 or c_step["launches"] != 2:
        raise AssertionError(f"graph_features launches: D call {d_call}, C step {c_step}")

    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    times = {}
    with torch.inference_mode():
        for B, n in GRAPH_FEATURES_TIMED:
            x = cost("uniform", B, n, n)
            bound, by, exchanges, design_ms = _graph_features_bound_ms(B, n, n)
            ms = _time_ms(torch, lambda: graph_features(x), 20, flush)
            device_us, kernels = _device_launch_profile(torch, lambda: graph_features(x))
            times[f"{B}x{n}"] = {
                "ms": ms,
                "plain_ms": _time_ms(torch, lambda: graph_features_plain(x), 5, flush),
                "library_ms": None, "bound_ms": bound, "bound_by": by,
                "bound_share_pct": 100.0 * bound / ms, "design_traffic_ms": design_ms,
                "sort_compare_exchanges": exchanges,
                "device_us_l2_resident": device_us, "kernels_per_call": kernels,
            }
            del x
    res = {"max_ulps": worst, "ulps": ulps, "launches_d_call": d_call,
           "launches_c_step": c_step, "times": times}
    _emit({"phase": "graph_features", **res})
    return res


PREDICT_GRAPH_REPS = 30
# the sizes at which the eval and front-ends phases call A's predict
PREDICT_GRAPH_SHAPES = sorted({EVAL_N, *EVAL_TIMED_N, FRONT_N, FRONT_BY_TYPE_N,
                               *FRONT_COMPREHENSIVE_N, FRONT_LARGE_N, FRONT_REGRESSION_N})


def phase_predict_graph(torch, seed):
    """Cell A's and cell D's predict, eager against replayed CUDA graphs,
    and A's at the eval and front-ends phases' sizes (see the module's
    phase 17)."""
    import numpy as np

    from lapgnn_tpu_torch import tracing
    from lapgnn_tpu_torch.data.generators import FAMILIES
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint

    costs = {f: torch.from_numpy(C).cuda()[None]
             for f, C in _e2e_costs(seed + 2500).items()}
    C = costs["uniform"]

    def counted(fn):
        torch.cuda.synchronize()
        before = tracing.counters()
        out = fn()
        torch.cuda.synchronize()
        after = tracing.counters()
        return out, {k: after[k] - before.get(k, 0) for k in after
                     if after[k] != before.get(k, 0)}

    def timed(fn):
        host = _ms_host(torch, fn, PREDICT_GRAPH_REPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(PREDICT_GRAPH_REPS):
            fn()
        end.record()
        enqueue = (time.perf_counter() - t0) * 1e3 / PREDICT_GRAPH_REPS
        torch.cuda.synchronize()
        return {"host_ms": host, "events_ms": start.elapsed_time(end) / PREDICT_GRAPH_REPS,
                "enqueue_ms": enqueue}

    def launches(rise):
        return {k: v for k, v in rise.items() if k.startswith("launch.")}

    res = {}
    for cell, ckpt, normalize in (("A", CHECKPOINT, True), ("D", DUAL_CHECKPOINT, False)):
        params, meta, _ = load_checkpoint(ckpt)
        pipe = WarmStartPipeline(build_model_from_meta(meta), params, normalize_costs=normalize)
        predict = pipe._predict

        @torch.inference_mode()
        def eager(X=None):
            return predict.graphs.eager(C if X is None else X)

        if cell == "A":
            served = predict
        else:  # D's predict runs eagerly: its graphs, called as A's predict calls them
            @torch.inference_mode()
            def served(X):
                with tracing.span("predict", X.device):
                    return predict.graphs(X)

        _, first = counted(lambda: served(C))  # eager: builds the kernels
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        _, captured = counted(lambda: served(C))
        pool_bytes = torch.cuda.memory_reserved() - reserved
        (_, replayed), (_, eagerly) = counted(lambda: served(C)), counted(eager)
        if replayed.get("predict_graph.replay") != 1:
            raise AssertionError(f"cell {cell} predict: not replayed: counters {replayed}")
        # what the capture counted is what each replay adds: it must be an
        # eager call's launches
        for what, rise in (("capture", captured), ("eager again", eagerly)):
            if launches(rise) != launches(first):
                raise AssertionError(f"cell {cell} predict, {what}: launches {launches(rise)} "
                                     f"against the first eager call's {launches(first)}")
        for what, rise in (("capture", captured), ("replay", replayed), ("eager again", eagerly)):
            if rise.get("host_syncs", 0) != 0:
                raise AssertionError(f"cell {cell} predict, {what}: host syncs {rise}")
        for f, X in costs.items():
            got, want = served(X), eager(X)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"cell {cell} predict on {f}: the replay differs from "
                                     "the eager chain")
        recording = predict.graphs._keys[predict.graphs.keys()[-1]].recording
        times = {}
        for way, fn in (("eager", eager), ("replay", lambda: served(C)),
                        ("replay_2", lambda: served(C)), ("eager_2", eager)):
            times[way] = timed(fn)
        # the replay's stages on the card: its spans' CUDA events, the median of five
        tracing.take()  # what earlier phases left recorded
        stages = {}
        for _ in range(5):
            with tracing.record():
                served(C)
            for sp in tracing.take():
                stages.setdefault(sp.name, []).append(sp.device_ms)
        stages = {k: statistics.median(v) for k, v in sorted(stages.items())}
        if cell == "A":  # what the seed policy's rank-1 fit takes on the card, alone
            from lapgnn_tpu_torch.graphs import capture
            from lapgnn_tpu_torch.ops.rank1 import rank1_duals

            with torch.inference_mode():
                rank1 = capture(lambda: rank1_duals(C), C.device)
                stages["rank1_duals"] = timed(rank1.replay)["events_ms"]
            del rank1
        res[cell] = {"pool_reserved_bytes": pool_bytes, "graphs": recording.graphs,
                     "served": "replay" if cell == "A" else "eager (graphs called directly)",
                     "replay_stages_device_ms": stages,
                     "launches": launches(first),
                     "times": times,
                     "host_ms_saved": (times["eager"]["host_ms"] + times["eager_2"]["host_ms"]
                                       - times["replay"]["host_ms"]
                                       - times["replay_2"]["host_ms"]) / 2}
        del pipe, predict, recording, served
        torch.cuda.empty_cache()

    # A's predict, as served, at the sizes the eval and front-ends phases
    # drive with its graphs held eager: replay against eager on the four families
    params, meta, _ = load_checkpoint(CHECKPOINT)
    predict = WarmStartPipeline(build_model_from_meta(meta), params)._predict
    rng = np.random.default_rng(seed + 2501)
    shapes = {}
    for n in PREDICT_GRAPH_SHAPES:
        fams = {f: torch.from_numpy(FAMILIES[f](n, rng).astype(np.float32)).cuda()[None]
                for f in FAMILIES_E2E}
        predict(fams["uniform"])  # eager
        predict(fams["uniform"])  # captures
        before = tracing.counters()["predict_graph.replay"]
        for f, X in fams.items():
            got = predict(X)
            with torch.inference_mode():
                want = predict.graphs.eager(X)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"A's predict at (1, {n}) on {f}: the replay differs "
                                     "from the eager chain")
        shapes[n] = tracing.counters()["predict_graph.replay"] - before
        if shapes[n] != len(fams):
            raise AssertionError(f"A's predict at (1, {n}): {shapes[n]} replays of {len(fams)}")
        del fams
    res["A_bit_equal_replays_by_n"] = shapes
    del predict
    torch.cuda.empty_cache()
    _emit({"phase": "predict_graph", **res})
    return res


def phase_times(torch, seed):
    from lapgnn_tpu_torch.ops.cuda import col_min, min_trick, row_features_stats, two_min
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_plain, min_trick_plain
    from lapgnn_tpu_torch.ops.cuda.features import row_features_stats_plain, stats_kernel
    from lapgnn_tpu_torch.ops.cuda.twomin import two_min_plain

    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    no_flush = torch.empty(1, dtype=torch.float32, device="cuda")
    out = {}

    def base_row(name, n, kern, plain, lib, reps):
        bound, by = _bound_ms(name, 1, n, n)
        return {
            "ms": _time_ms(torch, kern, reps, flush),
            "plain_ms": _time_ms(torch, plain, max(3, reps // 4), flush),
            "library_ms": None if lib is None else _time_ms(torch, lib, reps, flush),
            "bound_ms": bound,
            "bound_by": by,
        }

    for n in (2048, 8192):
        C = _batch(torch, n, seed + 7 * n, fams=("uniform",))
        g = torch.Generator(device="cuda").manual_seed(seed)
        u = torch.randn((1, n), device="cuda", generator=g) * 0.3
        v = torch.randn((1, n), device="cuda", generator=g) * 0.3
        cm = col_min_plain(C)
        reps = 20 if n == 2048 else 10
        fns = {
            "col_min": (lambda: col_min(C), lambda: col_min_plain(C), lambda: torch.amin(C, dim=-2)),
            "min_trick": (lambda: min_trick(C, u), lambda: min_trick_plain(C, u), None),
            "row_features_stats": (
                lambda: row_features_stats(C),
                lambda: row_features_stats_plain(C, cm),
                None,
            ),
            "two_min": (lambda: two_min(C, v), lambda: two_min_plain(C, v), None),
        }
        for name, (kern, plain, lib) in fns.items():
            row = base_row(name, n, kern, plain, lib, reps)
            if n == N_E2E:
                row["ms_synced_loop"] = _time_ms(torch, kern, reps, flush, queued=False)
            out.setdefault(name, {})[n] = row
        for name, states in _col_min_states(torch, C, u, reps, flush, no_flush).items():
            out[name][n].update(states)

        # K3 without K1 inside, on either path.
        k3 = out["row_features_stats"][n]
        k3["kernel_only_ms"] = _time_ms(torch, lambda: stats_kernel(C, cm), reps, flush)
        k3["shared_path_kernel_only_ms"] = _time_ms(
            torch, lambda: stats_kernel(C, cm, path="shared"), reps, flush)
        # K4 with C left in L2 between launches, and every geometry.
        k4 = out["two_min"][n]
        k4["ms_l2_resident"] = _time_ms(torch, lambda: two_min(C, v), reps, no_flush)
        k4["variants_ms"] = _two_min_variants(torch, C, v, reps, flush, no_flush)
        k4["yardsticks"] = _two_min_yardsticks(torch, C, v, reps, flush, no_flush)
        k3["kernel_only_ms_l2_resident"] = _time_ms(
            torch, lambda: stats_kernel(C, cm), reps, no_flush)
        # K4's float64 form (the float64 solves), its own bound
        C64, v64 = C.double(), v.double()
        bound, by = _bound_ms("two_min", 1, n, n, itemsize=8)
        k4["float64"] = {"ms": _time_ms(torch, lambda: two_min(C64, v64), reps, flush),
                         "plain_ms": _time_ms(torch, lambda: two_min_plain(C64, v64),
                                              max(3, reps // 4), flush),
                         "ms_l2_resident": _time_ms(torch, lambda: two_min(C64, v64), reps,
                                                    no_flush),
                         "bound_ms": bound, "bound_by": by}
        del C64, v64
        for name, row in _solver_times(torch, C[0], flush, 10 if n == N_E2E else 3).items():
            out.setdefault(name, {})[n] = row
        out.setdefault("sinkhorn_ladder", {})[n] = _sinkhorn_times(torch, C, flush, no_flush,
                                                                    seed, reps)
    n = 4096
    C = _batch(torch, n, seed + 7 * n, fams=("uniform",))
    v = torch.randn((1, n), device="cuda", generator=g) * 0.3
    out["two_min"][n] = {"variants_ms": _two_min_variants(torch, C, v, 10, flush, no_flush)}
    # K1 / K2 between the L2-resident size and the streaming one.
    u = torch.randn((1, n), device="cuda", generator=g) * 0.3
    out["col_min"][n] = base_row("col_min", n, lambda: col_min(C), lambda: col_min_plain(C),
                                 lambda: torch.amin(C, dim=-2), 10)
    out["min_trick"][n] = base_row("min_trick", n, lambda: min_trick(C, u),
                                   lambda: min_trick_plain(C, u), None, 10)
    for name, states in _col_min_states(torch, C, u, 10, flush, no_flush).items():
        out[name][n].update(states)
    _emit({"phase": "times", "batch": 1, "kernels": out,
           "min_trick_narrow_shapes": _col_min_narrow(torch, 10, flush, no_flush, seed)})
    for name in ("col_min", "min_trick"):
        per_call = out[name][N_E2E]["kernels_per_call"]
        if per_call is not None and per_call != 1:
            raise AssertionError(f"{name} at n={N_E2E} is {per_call} kernels a call, not one")
    return out


def _profile(torch, fn):
    """Run ``fn`` once under torch.profiler.  Returns the kernels' rows
    (device us, name, count), heaviest first, and the host-clock ms of the
    run, which ends in a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        # kernel events only: an aten op's device time repeats its kernels'
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    return rows, wall_ms


def phase_breakdown(torch, pipe, C_np):
    """Where one predict's time goes at the e2e size (uniform instance):
    each stage timed alone with CUDA events (median of 5 after warm-up), and
    one whole predict under torch.profiler for the device's busy share and
    its heaviest kernels."""
    from lapgnn_tpu_torch.ops.dual import robust_normalize
    from lapgnn_tpu_torch.ops.features import fast_row_features
    from lapgnn_tpu_torch.ops.sinkhorn import auto_select_seed

    cost = torch.from_numpy(C_np).cuda()[None]
    with torch.inference_mode():
        cn, mn, a = robust_normalize(cost)
        feats = fast_row_features(cn)
        u = pipe.model(feats, cost=cn)["u"] * a[..., None] + mn[..., None]
        stages = {
            "normalize": lambda: robust_normalize(cost),
            "features_k3_k1": lambda: fast_row_features(cn),
            "model": lambda: pipe.model(feats, cost=cn),
            "seed_policy_auto": lambda: auto_select_seed(cost, u),
            "predict_total": lambda: pipe.predict_duals(cost),
        }
        no_flush = torch.empty(1, device="cuda")
        stage_ms = {k: _time_ms(torch, fn, 5, no_flush) for k, fn in stages.items()}

        rows, wall_ms = _profile(torch, lambda: pipe.predict_duals(cost))
    busy_ms = sum(r[0] for r in rows) / 1e3
    _emit({
        "phase": "breakdown", "n": C_np.shape[-1], "stage_ms": stage_ms,
        "profiled_predict_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if rows else "not measured",
        "device_idle_share": (1.0 - busy_ms / wall_ms) if rows else "not measured",
        "top_kernels": [{"name": k[:80], "device_ms": d / 1e3, "count": c} for d, k, c in rows[:8]],
    })


def _device_phases(torch, seed):
    """device_e2e, device_vs_cpu and device_breakdown, as the full run has
    them."""
    _, dpipe, costs = phase_device_e2e(torch, seed)
    phase_device_vs_cpu(torch, dpipe, seed)
    phase_device_breakdown(torch, dpipe, costs["uniform"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="",
                    help="comma-separated subset of build,compare,device,times,stream,train,"
                         "eval,dual_train,front_ends,parallel,parallel_train,dual_edge,"
                         "graph_features,predict_graph (no ok line)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        import lapgnn_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run it from the "
              "repository root", file=sys.stderr)
        return 1

    card = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    _emit({"torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0]})
    try:
        if args.phases:
            subset = {"build": lambda: phase_build(torch, strict=False),
                      "compare": lambda: phase_compare(torch, args.seed),
                      "device": lambda: _device_phases(torch, args.seed),
                      "times": lambda: phase_times(torch, args.seed),
                      "stream": lambda: phase_stream(torch, args.seed),
                      "train": lambda: phase_train(torch, args.seed),
                      "eval": lambda: phase_eval(torch, args.seed),
                      "dual_train": lambda: phase_dual_train(torch, args.seed),
                      "front_ends": lambda: phase_front_ends(torch, args.seed),
                      "parallel": lambda: phase_parallel(torch, args.seed),
                      "parallel_train": lambda: phase_parallel_train(torch, args.seed),
                      "dual_edge": lambda: phase_dual_edge(torch, args.seed),
                      "graph_features": lambda: phase_graph_features(torch, args.seed),
                      "predict_graph": lambda: phase_predict_graph(torch, args.seed)}
            for phase in args.phases.split(","):
                subset[phase]()
            print(f"chip_smoke: partial run ({args.phases}), no ok line")
            return 0
        phase_build(torch)
        # label the train and eval phases' instances on the host's cores
        # while the compare phase keeps the card busy; the pool is gone
        # before any host-clock time is taken
        train_jobs = _train_jobs(args.seed)
        collect = _label_async(train_jobs + _eval_jobs(args.seed))
        try:
            errs = phase_compare(torch, args.seed)
        finally:
            records, label_s, workers = collect()
        train_data = (_train_split(records[: len(train_jobs)]), label_s, workers)
        eval_records = records[len(train_jobs):]
        pipe, c_uniform = phase_e2e(torch, args.seed)
        phase_breakdown(torch, pipe, c_uniform)
        launches, dpipe, costs = phase_device_e2e(torch, args.seed)
        vs_cpu = phase_device_vs_cpu(torch, dpipe, args.seed)
        phase_device_breakdown(torch, dpipe, costs["uniform"])
        phase_stream(torch, args.seed)
        train = phase_train(torch, args.seed, train_data)
        evaluated = phase_eval(torch, args.seed, eval_records)
        dual = phase_dual_train(torch, args.seed, train_data)
        front = phase_front_ends(torch, args.seed)
        par = phase_parallel(torch, args.seed)
        par_train = phase_parallel_train(torch, args.seed)
        times = phase_times(torch, args.seed)
        dual_edge = phase_dual_edge(torch, args.seed)
        graph_feats = phase_graph_features(torch, args.seed)
        phase_predict_graph(torch, args.seed)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    kernels = []
    for kname, info in KERNELS.items():
        if kname in SOLVER_KERNELS:
            # the device solver's kernels: launches on the device path (four
            # instances at n = 2048), error against their plain loops over
            # device_vs_cpu's solves, times on a uniform solve's arguments
            t = times[kname]
            kernels.append({"name": kname, **info, "launches": launches[kname],
                            "launches_eval": evaluated["launches"][kname],
                            "launches_dual_train": dual["launches"][kname],
                            "launches_front_ends": front["launches"][kname],
                            "launches_parallel": par["launches"].get(kname, 0),
                            "launches_parallel_train": par_train["launches"][kname],
                            "max_abs_err": vs_cpu["max_abs_err"], "n": N_E2E, **t[N_E2E],
                            "at_n_8192": t[8192], "card": card})
            continue
        if kname == "sinkhorn_ladder":
            # the seed policy's ladder: launches on every path that serves
            # 'auto', the error against the eager loop over the compare,
            # eval and times phases, times on a uniform instance
            t = times[kname]
            kernels.append({"name": kname, **info, "launches": launches[kname],
                            **{f"launches_{ph}": res["launches"].get(kname, 0) for ph, res in
                               (("eval", evaluated), ("dual_train", dual), ("front_ends", front),
                                ("parallel", par), ("parallel_train", par_train))},
                            "n": N_E2E, **t[N_E2E], "at_n_8192": t[8192],
                            "max_abs_err": max(errs[kname], evaluated["max_abs_err"][kname],
                                               t[N_E2E]["max_abs_err"], t[8192]["max_abs_err"]),
                            "card": card})
            continue
        if kname == "dual_edge_terms":
            # DualGNN's edge MLP: launches in a serving call of r5 (cell D's
            # solve(C), one a layer) and on every other path, the error against
            # its plain version, times at the serving cell's shape and the
            # training cell's
            t = dual_edge["times"]
            serve = dual_edge["launches_a_serving_call"]
            kernels.append({"name": kname, **info, "launches": serve[FAMILIES_E2E[0]],
                            "launches_a_serving_call": serve,
                            "launches_default_pipeline": launches[kname],
                            **{f"launches_{ph}": res["launches"].get(kname, 0) for ph, res in
                               (("eval", evaluated), ("dual_train", dual), ("front_ends", front),
                                ("parallel", par), ("parallel_train", par_train))},
                            "n": N_E2E, **t[f"1x{N_E2E}"], "at_4x512": t["4x512"],
                            "max_rel_err": dual_edge["max_rel_err"],
                            "u_gap_2048": dual_edge["u_gap_2048"], "card": card})
            continue
        if kname == "graph_features":
            # DualGNN's graph features: launches in cell D's call and cell C's
            # step and on every other path, the largest ulps of the summed
            # channels against the plain version, times at both cells' shapes
            t = graph_feats["times"]
            d_call, c_step = graph_feats["launches_d_call"], graph_feats["launches_c_step"]
            kernels.append({"name": kname, **info, "launches": d_call["launches"],
                            "host_syncs_d_call": d_call["host_syncs"],
                            "launches_c_step": c_step["launches"],
                            "host_syncs_c_step": c_step["host_syncs"],
                            "launches_default_pipeline": launches[kname],
                            **{f"launches_{ph}": res["launches"].get(kname, 0) for ph, res in
                               (("eval", evaluated), ("dual_train", dual), ("front_ends", front),
                                ("parallel", par), ("parallel_train", par_train))},
                            "n": N_E2E, **t[f"1x{N_E2E}"], "at_4x512": t["4x512"],
                            "max_ulps": graph_feats["max_ulps"], "card": card})
            continue
        if kname == "greedy_total":
            # the training path's kernel: launches from the train phase, times
            # at its (16, 2048) batch, then (32, 512) and (32, 1024); the error
            # over the compare phase and the train and eval phases' real
            # arguments
            kernels.append({"name": kname, **info, **train,
                            "max_abs_err": max(errs[kname], train["max_abs_err"],
                                               evaluated["max_abs_err"][kname],
                                               dual["max_abs_err"],
                                               par_train["max_abs_err"][kname]),
                            "launches_eval": evaluated["launches"][kname],
                            "launches_dual_train": dual["launches"][kname],
                            "launches_front_ends": front["launches"][kname],
                            "launches_parallel": par["launches"][kname],
                            "launches_parallel_train": par_train["launches"][kname],
                            **{f"at_{k}_dual_train": v for k, v in dual["greedy"].items()},
                            "card": card})
            continue
        t = times[kname]
        kernels.append({
            "name": kname, **info,
            "launches": launches[kname],
            "launches_eval": evaluated["launches"][kname],
            "launches_dual_train": dual["launches"][kname],
            "launches_front_ends": front["launches"][kname],
            "launches_parallel": par["launches"][kname],
            "launches_parallel_train": par_train["launches"][kname],
            "max_abs_err": max(errs[kname], evaluated["max_abs_err"].get(kname, 0.0),
                               front["max_abs_err"][kname],
                               par["max_abs_err"].get(kname, 0.0),
                               par_train["max_abs_err"].get(kname, 0.0)),
            "n": N_E2E,
            **t[N_E2E],
            "at_n_8192": t[8192],
            "at_n_4096": t.get(4096),
            "card": card,
        })
    _emit({"kernels": kernels})
    print(card, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
