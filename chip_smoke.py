"""Smoke run of xgboost_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls and holds
every kernel against its plain PyTorch version.  The paths:

- Higgs: the JAX package's headline benchmark configuration
  (``bench.py``: 1,000,000 x 28, binary logistic, max_depth 6, eta 0.1,
  max_bin 64, hist_precision auto = int8), 20 rounds, kernel K1;
- the command line (``python -m xgboost_tpu_torch``, called in-process
  as ``xgboost_tpu_torch.cli.main``) on the Higgs path's data, written
  as DMatrix buffers: ``task=train`` of the same configuration (K1),
  ``pred``, ``eval`` and ``dump``, and ``task=lanes`` on 8 of the lanes
  path's tenants (K4);
- multiclass: ``bench.py:bench_multiclass`` (200,000 x 28, 6-class
  softmax, max_depth 6, eta 0.3, max_bin 64), all 60 rounds, kernel K3
  (one launch per level for the round's 6 trees);
- otto: ``bench.py:bench_otto`` (200,000 x 93, 9-class softprob), cut
  to 10 rounds, kernel K3 with feature tiling;
- depth 0: a max_depth=0 6-class booster, 5 rounds, kernel K2 (one
  launch a round, one kernel a launch);
- lanes: ``pipeline.run_tenant_lanes`` over 48 tenant pipelines at the
  Higgs booster's width (depth 6, eta 0.1, max_bin 64, 28 features),
  12,288 to 16,283 rows each, 2 cycles of 3 rounds, stacked into one
  K4 launch per level for all tenants (a stack of 64 lanes of 16,384
  rows; K4 is K1's and K3's scatter kernel with the lanes as its trees),
  then the same tenants through the host loop (K1 per tenant);
- serving: the Higgs and multiclass models behind
  ``xgboost_tpu_torch.serving`` (one CUDA graph per row bucket, the
  micro-batcher, the HTTP server with a hot reload and a rollback, the
  feature store);
- the fleet: a router (``python -m xgboost_tpu_torch task=fleet_router``,
  a subprocess) over two replicas of the Higgs model on the card in this
  process, with consistent-hash ``/predict_by_id``, the catalog placer,
  a canary rollout of a candidate trained on the card and its rollback,
  a killed replica and load shedding;
- ranking: ``bench.py:bench_rank`` (1,000,000 x 28, 10,000 groups of
  100, rank:ndcg, depth 6), cut to 20 rounds, on the group-padded layout
  (K1 on 1,040,000 slots), then the sort path (``rank:map``,
  ``rank:pairwise``) and the host path; the rest of the Booster API
  (custom objectives, ``boost``, ``cv``, the ranking metrics);
- the histogram microbenchmarks: the seven ported Pallas prototypes'
  ``main``s (``xgboost_tpu_torch.tools``: T5 ``hist_microbench``, T3
  ``hist_int8_proto``, T2 ``hist_notrans_proto``, T7 ``hist_r5_ab``; the
  bf16 family T1 ``hist_group_proto``, T4a and T4b ``hist_pack2_proto``
  ``main`` and ``main_onebig``, T6 ``hist_r4_ab``) at their full shapes
  (1M x 28), each timing its one-hot tensor-core kernel beside K1.

Phases, in order; any failure exits non-zero:

  1. environment: the card's name and power limit;
  2. build: nvcc compiles every kernel from xgboost_tpu_torch/csrc/, one
     process per source, all at once;
  3. each kernel against its plain version on the card, at its paths'
     shapes and beyond (int8 bitwise; fp32 / bf16 bitwise on dyadic
     gradients, within the f32 summation bound on random ones; K3's tree
     slices and K4's lanes against solo K1 launches, bitwise; K1 and K3
     also at 1, 3 and 12,373 rows, 93 features, 24 trees, B = 1 and 256,
     64 and 128 nodes, every row inactive, and 2% of the bins at B or
     above; K4 under both of its flushes, at 1, 3 and 64 lanes, B = 7
     and 256, 128 nodes and 2% of the bins at B or above);
  4. each path: ``train`` with every launch count reset just before and
     read just after, its quality metric against a floor, the same
     rounds with the plain version forced (identical model bytes where
     the sums are integers), save/load (bitwise predictions), and the
     kernel against the plain version on every level's real inputs;
  5. times on the card: ms per round, and per kernel call on the paths'
     real inputs the kernel's ms (CUDA events around back-to-back
     calls) and, for K1-K4, its device ms (``torch.profiler``'s CUDA
     activities of 20 calls: the kernel and any memset, without the
     host's issue time) beside its bound, the plain version's and one
     PyTorch call's (``index_add_``), with K1's, K3's and K4's launch
     plan at each level (tiles, units, copies, blocks, rows a step, the
     store or the atomic flush) and K2's one kernel a call; for the
     lanes, the stacked and the host-loop cycle (gate and publish left
     out, as ``tools/bench_lanes.py`` times them) and tenants per
     second.

The ``[onehot]`` phase holds each one-hot kernel against its plain
version (int bitwise, including the int8 wrap, the dropped tail and T7's
floor-mod pad rows; T3 and T2 at M = 1-5, 8, 16, 32, 33 and 100, B = 1,
8 and 255 on five features, F = 3, r_tile = 1000 and with bins out of
range; T7 also at B = 1, 8 and 255 on five features and at 2, 6 and 8
levels; T5 bitwise on bf16-exact gradients, within the f32 summation
bound on random ones, also at F Bp not a multiple of 64, rows not a
multiple of the row step and one node) and each int kernel against a K1
int launch on the same inputs, fails unless T5's built library holds
wgmma (HGMMA) instructions and no mma.sync (HMMA) ones and T7's, T3's
and T2's integer wgmma (IGMMA) and no integer mma.sync (IMMA) ones
(``cuobjdump -sass``), then runs the four mains with every launch count
set to 0 just before and read just after, and fails on any count but the
mains' exact ones (a fall to the plain version would leave it short), on
T2's int32 sums differing from exact ones, and on T3's dequantized
histogram beyond its rows' half quantization steps.

The ``[onehot-bf16]`` phase does the same for T1, T4a, T4b and T6: each
kernel bitwise against its plain version on bf16-exact gradients and
within the f32 summation bound on random ones (dropped tails, bins past
B, rows outside the node tile, T1's node tiles and every fg and r_tile
of its main, F Bp not a multiple of 64 on rows that are not a multiple
of the row step, one node, a planted out-of-range bin that must leave
its row in the group's other features, T4b == T4a prod, T4 at F = 5 and
6, B = 1, 8, 255, M = 3, 5, 33, 100 and r_tile = 1000 and 300, T6's
u8bins == i16hot == prod, every T6 mode on rows that are not a multiple
of its row step and at F Bp not a multiple of 64), the same SASS check
of T1's, T6's and T4's libraries, then the three
bf16 mains with exact launch counts, T1's accuracy line within bf16's
rounding of K1 fp32, and T4a's and T4b's match checks. Every path counts
the launches of all twelve kernels and fails on any kernel it should not
run.

The ``[cli]`` phase, after ``[main]``, writes ``[main]``'s train set and
holdout with ``DMatrix.save_binary`` and times writing and loading them,
then fails unless: the buffers hold ``[main]``'s values and labels;
``task=train`` (``eval[test]=`` the holdout buffer, ``eval_metric=auc``,
``save_period=10``, ``checkpoint_dir=``) exits 0, launches K1 exactly
``[main]``'s 120 times and nothing else, writes ``0010.model``,
``0020.model`` and a ring of two members, and its model's tree arrays and
cuts equal ``[main]``'s bitwise, its last eval line's ``test-auc``
``[main]``'s AUC to six decimals; ``task=pred`` on the holdout as libsvm
text (``{:.9g}`` values) writes ``f"{p:g}"`` of ``Booster.predict`` on
the buffer, transformed and with ``pred_margin=1``; ``task=eval`` prints
``eval_set``'s line; ``task=dump`` with ``dump_stats=1`` and a 28-line
fmap gives the 20 boosters of ``get_dump``; pred, eval and dump launch no
histogram kernel; ``task=lanes`` over 8 tenants' buffers
(``lane_stack=1``, one cycle of 10 rounds, gate on AUC) exits 0,
launches K4 and no K1, and each tenant's trees equal those of
``run_tenant_lanes`` called on the same tenants' arrays, bitwise.

The ``[dist]`` phase, after ``[cli]``, trains row-split
(``xgboost_tpu_torch.parallel``) on [cli]'s buffers with W ranks on this
one card over gloo, each started by the user's entry point ``python -m
xgboost_tpu_torch.parallel.launch -n W python -m xgboost_tpu_torch
dist.conf`` ([main]'s configuration, ``eval[test]=`` the holdout), and
fails unless: (a) at W = 2 and 4 with ``device_sketch=0`` the model's
tree arrays and cuts equal [main]'s bitwise and the last eval line is
[main]'s; (b) at W = 2 with the default device sketch the cuts equal
the same sketch run on the CPU over the same two blocks and every
rank's, and the holdout AUC is at [main]'s floor; (c) a rank worker
(this script's ``--dist-worker`` entry, W = 2) finds each level's K1 on
its 500,000-row block equal to the plain version (int8 bitwise) and
each reduced level equal to the plain histogram of all 1M rows, a
refresh pass's K2 launches, on each block and summed over the ranks,
within K2's own f32 bound of the f64 sums of the same rows, node by
node (gamma_L of the node's sum|x|, L the additions a term passes in
the kernel's order), while a planted fault (16 rows of the fullest
node dropped) exceeds it, and a 6-class round of 200,000 x 28 (K3)
byte-equal to a world of one; (d) a split load (``shard_load=1``) of
[cli]'s 100,000 holdout rows of libsvm text trains the trees of their
replicated load with ``device_sketch=1``; (e) it prints ms per round at
W = 1 (this process, a world of one) and 2 (the worker), each rank's
launch counts and the collectives a round (calls, bytes, seconds from
``obs/comm.py``); (f) any failed rank, a launcher past its time limit
or a mismatch exits non-zero; column split and ranking on row-split
data (``xgboost_tpu_torch.parallel.colsplit``): (g) at W = 2 the CLI
with ``dsplit=col`` (every rank all rows, its 14 of the 28 features)
trains [main]'s tree arrays and cuts bitwise with [main]'s last eval
line, and in the worker round 0's K1 on each rank's block equals the
plain version and rounds 1-19 launch K1 6 times a round on each rank
and nothing else; (h) the worker's exact ``grow_colmaker`` with
``dsplit=col`` on 200,000 of [main]'s rows, 3 rounds, gives the model
bytes of a world of one, K2 7 times a tree on each rank, each launch
node by node within K2's bound of the f64 sums; (i) its ``rank:ndcg``
with ``dsplit=row`` on 200,000 rows of ``make_rank`` in 2,000 groups, 5
rounds, gives the model bytes of a world of one with K1 6 times a tree;
each prints its seconds and collectives a round.  (a), (b), (d) and
(g)'s CLI run at once; the worker runs alone.  Each launch has a limit
of DIST_LIMIT_S (the worker DIST_CHECK_LIMIT_S).

The phases after ``[cli]`` drive sampled, subtracted and multi-root
growth and the round profiler on the same data, each with its launch
counts set to 0 just before and read just after:

- ``[sample]``: [main]'s data and configuration with ``subsample``,
  ``colsample_bytree`` and ``colsample_bylevel`` 0.8 (seed 0), 20
  rounds; fails unless K1 runs exactly 120 times and nothing else, the
  row and feature masks of rounds 0-2 drawn on the card equal bitwise
  those drawn on the CPU from the same keys, the model bytes equal those
  of a run with the plain histogram and of a second run, and the holdout
  AUC is at least the JAX package's CPU AUC for this configuration
  (``SAMPLE_AUC_JAX``) less 0.005; prints ms per round beside [main]'s
  and the ms of one 1M-row ``uniform`` draw;
- ``[subtract]``: [main]'s configuration under
  ``XGBTPU_HIST_SUBTRACTION=1``; fails unless K1 runs 6 times a tree and
  K2 5 times (levels 1-5) and nothing else, K1 runs on the compacted rows
  from level 1 on and equals its plain version there (int8 bitwise), K2's
  row counts equal its plain version's, each subtracted level equals the
  same subtraction on the plain versions bitwise and the plain full
  build within its stated f32 bound, and the AUC is within 0.002 of
  [main]'s; prints ms per round beside [main]'s.  After ``[forest]`` the
  multiclass data under the switch, 5 rounds of 6 trees: fails unless
  K3 runs once a round (level 0), K4 (the small children on each tree's
  compacted rows) and K2 5 times a round and nothing else, and the plain
  K3, K4 and K2 give the same model bytes; prints its ms per round beside
  [multiclass]'s;
- ``[roots]``: 200,000 of [main]'s rows with ``num_roots=2``, the label
  flipped where ``X[:, 20] > 0.5``, which is also each row's
  ``root_index``; fails unless K1 runs 60 times, the trees hold 255 nodes,
  the AUC is at least the JAX package's CPU AUC less 0.005, every root
  flipped predicts worse than chance, save / load keeps predictions and
  leaves bitwise and the plain histogram gives the same model bytes;
  then the same rows and roots as a forest (``num_parallel_tree=2``,
  ``subsample=0.8``): fails unless K3 runs 60 times and nothing else,
  the AUC is at least the one-tree run's less 0.01, flipped roots
  predict worse than chance and the plain K3 gives the same model bytes;
- ``[profile]``: [main]'s configuration with ``profile=1`` and the
  holdout as a watchlist; fails unless it prints a ``[prof]`` line a
  round and its model bytes equal [main]'s (the ``profile`` parameter
  reset); prints the ms per round of ``predict``, ``gradient``, ``grow``
  and ``eval``; then 3 rounds with ``profile=2``: fails unless its
  ``torch.profiler`` trace is written and holds CUDA activity, and
  prints the ten CUDA operations with the most device time a round, with
  their counts, and K1's share of ``grow``;
- ``[updaters]`` (after ``[profile]``): [main]'s data and configuration
  with ``updater=grow_colmaker``, 5 rounds: fails unless K2 runs 7
  times a tree (every level, exact node sums) and nothing else, one
  rank build runs, the holdout AUC is at least ``EXACT_AUC_JAX`` less
  0.005, and the model loaded on the CPU predicts margins within 1e-6
  and the same leaves; ``grow_skmaker``, 10 rounds: K1 60 and K2 10
  (the terminal levels) only, AUC at least ``SK_AUC_JAX`` less 0.005;
  on the multiclass data, 5 rounds: K3 30 and K2 5 (6 trees a launch)
  only, merror better than chance; ``refresh`` of [main]'s model on a
  fresh 1M-row draw (seed 43): K2 7 only (all 20 trees a launch), the
  structure unchanged, leaf values within rtol 1e-5 plus the f32
  summation bound of the port's CPU refresh on the same rows and
  gradients; then 2 rounds of ``grow_histmaker,refresh``: K1 12 and K2
  14 only.  Prints ms per exact and skmaker round, the rank build's s
  and ms a refresh pass;
- ``[linear]``, ``[compat]``, ``[extmem]`` (after ``[updaters]``):
  ``booster=gblinear`` on [main]'s data (10 rounds)
  and [multiclass]'s (5 rounds): fails on any histogram kernel, on
  weights or bias outside rtol 1e-4 / atol 1e-6 of the port's CPU run on
  the same rows, on a holdout AUC under ``LIN_AUC_JAX`` less 0.002 or a
  merror over ``LIN_MERROR_JAX`` plus 0.005, or if the model file on the
  CPU predicts otherwise; the reference CLI's ``ref_agaricus.model`` and
  ``.bs64`` on the card must predict 10,000 synthetic rows to the CPU's
  bytes, and [main]'s model written with ``save_reference_model`` and
  read back must predict [main]'s holdout bytes; [main]'s 1M training
  rows as an external-memory matrix of 16 pages under an 8 MiB budget,
  5 rounds: fails unless K1 runs 480 times and K2 560 and nothing else,
  a second streamed run grows the same model bytes, every K1 launch of
  a streamed round (batches of 65,536 and 16,960 rows, up to 32 nodes)
  equals the plain K1 bitwise and every K2 launch (up to 64 nodes) the
  plain K2 within 2 n 2^-24 sum|x|, one level's 16 int32 partial
  histograms add up to the plain K1 on the whole matrix bitwise, a
  streamed round adds fewer device bytes at its peak than an in-memory
  one, and the holdout AUC is within 0.002 of the in-memory model's;
  under the default budget the same matrix must train in memory (K1
  30, no batch up); then a 50,000-row libsvm file through
  ``DMatrix("ext:...")`` and ``task=train``.  Prints ms per gblinear
  and per streamed round (twice, and in memory), upload seconds,
  ingest, sketch and binning seconds;
- ``[forest]`` (after ``[otto]``): the multiclass data with
  ``num_parallel_tree=2``, ``subsample`` and ``colsample_bytree`` 0.8, 20
  rounds of 12 trees; fails unless K3 runs 120 times and nothing else,
  round 0's 12 trees draw 12 distinct row masks, the plain batched
  histogram gives the same model bytes and the holdout merror is at most
  the JAX package's CPU merror plus ``FOREST_MERROR_BOUND``;
- ``[lanes-sampled]`` (after ``[lanes]``): 8 of [lanes]' tenants at one
  row count with ``subsample=0.8``, one cycle of 10 rounds, stacked and
  as the host loop; fails unless the stacked run launches K4 60 times in
  one dispatch and no K1, the host loop K1 480 times, and both give the
  same model bytes, ledgers and gate verdicts.

The ranking and API phases (after ``[lanes-sampled]``), each run's
launch counts set to 0 just before and read just after:

- ``[rank]``: ``bench.py:bench_rank`` at full width (rank:ndcg,
  1,000,000 x 28 from ``RandomState(11)``, 10,000 groups of 100, depth 6,
  eta 0.1, max_bin 64), its 50 rounds cut to 20, on the group-padded
  layout (10,000 groups of L = 104 lanes, 1,040,000 slots); fails unless
  the one ``[rank]`` path line names ``group-padded``, K1 runs 120 times
  and nothing else, the training NDCG is at least the JAX package's CPU
  NDCG for the same data, rounds and parameters (``RANK_NDCG_JAX``) less
  0.005, K1 equals its plain version (int8 bitwise) on round 0's six
  levels of the padded layout, padding slots included, one round's
  gradient on the card has the CPU's partner lanes bitwise and g / h
  within 16 ulp + 2^-21 (1 + n_other) of the CPU's on the same margin,
  and the plain K1 grows the same model bytes; prints ms per round and
  the gradient's ms a call (CUDA events);
- ``[rank-sort]``: the same data under ``XGBTPU_RANK_PAD=0``, 5 rounds
  of ``rank:map`` and of ``rank:pairwise`` on the sort path, then
  ``rank_impl=host`` (``rank:ndcg``) on the first 100,000 rows for 2
  rounds; fails unless K1 runs 6 times a round and nothing else, the
  path line names ``sort-based`` (none on the host path), the training
  NDCG is within ``RANK_SORT_TOL`` (``RANK_HOST_TOL`` on the host path)
  of a padded run of the same objective, rows and rounds, and the sort
  path's partners drawn on the card equal the CPU's; prints ms per round
  and the gradient's ms a call;
- ``[api]``: 200,000 Higgs rows (``make_higgs_like``, seed 77; 50,000
  more held out), 5 rounds: ``train(obj=)`` with a numpy logistic
  objective on ``binary:logitraw`` (K1 30 launches) within 0.005 holdout
  AUC of ``binary:logistic``; ``boost()`` with the built-in gradient
  pulled to the host gives ``update()``'s model bytes; ``cv`` (3 folds,
  ``auc``, ``ams@0.15``, ``pratio@0.1``, the numpy objective, int8 sums
  and 32-aligned bins) prints its lines, launches K1 90 times and its
  lines equal the CPU port's on the same data; and ``ndcg@10``,
  ``map@10`` and ``pre@10`` of ``[rank]``'s booster read through
  ``eval_set`` on the padded entry equal the metric functions on the
  host copy of ``predict`` (user order).

The ``[serve]`` phase (after ``[multiclass]``, launch counts set to 0
just before and read just after; none of the twelve kernels may launch)
serves ``[main]``'s model file (20 trees, one padded chunk of 32) and
``[multiclass]``'s (360 trees, 12 chunks of 32) through
``xgboost_tpu_torch.serving`` and fails unless: (a) a ``PredictEngine``
with the default ladder 8-8192 captures exactly 11 CUDA graphs in
``warmup`` and none afterwards; (b) predictions and margins of
``[main]``'s 100,000 holdout rows in requests of 1, 5, 8, 100, 1,000 and
8,192 rows (up to 200 requests a size) and all at once equal
``Booster.predict`` byte for byte, and the multiclass model's at 1, 100
and 8,192 rows (``multi:softmax``: shape ``(n,)``), and
``Booster.predict``'s chunked traversal (``pred_chunk`` 32, the card's
default) gives both models' holdout predictions and margins byte for
byte equal to the per-tree path's (``pred_chunk`` 0); (c) each bucket's
graph replay equals the eager margin function byte for byte; (d) 16
threads x 50 requests of 1-64 rows through ``MicroBatcher`` each equal
``Booster.predict`` of their rows, in fewer flushes than requests; (e)
``run_server`` on port 0 answers a 1,000-row CSV ``/predict`` with
``Booster.predict``'s values, ``/healthz`` is ok, ``/metrics`` holds the
serve counters, overwriting the model file with ``[cli]``'s
``0010.model`` (while a client keeps asking) moves ``model_version`` and
the predictions to that model's, and a rollback restores the first;
(f) ``predict_by_id`` of 1,000 ids put in a ``FeatureStore`` equals
``predict`` of their rows with no feature bytes uploaded; (g) the phase
ends within 90 s; and every graph's pool, read at capture, is not
empty.  It prints each engine's ``device_bytes`` (graph pools included)
beside the growth of ``torch.cuda.memory_reserved`` over its load and
warmup (the cache emptied before and after), p50 / p99 ms of ``engine.predict`` over 200
calls at 1, 64, 1,024 and 8,192 rows for both models and rows/s at
8,192, the eager function's and the graph's ms at 8 and 8,192 rows, the
HTTP round trip's p50 / p99 at 1 and 1,000 rows and ``predict_by_id``'s
at 64 ids.

The ``[fleet]`` phase (after ``[serve]``, launch counts set to 0 just
before and read just after: only the candidate's training launches a
kernel, K1 60 times) starts the router as a subprocess
(``fleet_lease_sec`` 3, ``fleet_hc_sec`` 0.5) and two replicas, ``r0``
and ``r1``, as ``run_server(..., device="cuda", router_url=...,
replica_id=...)`` on copies of ``[main]``'s model file, each with a
catalog budget (``serve_catalog_mb``) of its default engine and one more
in the bytes ``[serve]`` measured (graph pools included), and fails
unless: (a) both are in rotation within 10 s; (b) ``/predict`` of 1, 64
and 1,000 CSV holdout rows through the router gives the body of the same
request sent to ``r0``, byte for byte, and ``Booster.predict``'s values;
(c) 1,000 ids put through the router live each on its ``HashRing`` owner
only, and three repeats of the merged ``/predict_by_id`` (and 20 single
ids a repeat) equal ``/predict`` of their rows; (g) a placer converges a
two-model catalog (``[main]``'s and ``[multiclass]``'s models) with
each model on a replica, each replica hosting one and its advertised
``used_bytes`` within its ``budget_bytes``, and ``/predict?model=``
through the router equal to that model's ``Booster.predict``; (d) ``POST
/fleet/rollout`` (1 canary, a 2 s soak) of a candidate trained on the
card (10 rounds on the first 200,000 rows) succeeds under traffic, both
replicas report its sha256 and answer its predictions, and ``POST
/fleet/rollback`` restores the first hash and answers, every answer
under traffic one model's; (e) ``replica_kill`` on ``r1`` (its
``on_kill`` stops the server with no drain; first r1 is let back from a
latency ejection of (d), up to 15 s) fires during 400 requests from 16
threads, no client sees an error, ``r1`` leaves rotation within
``fleet_lease_sec`` + ``fleet_hc_sec``, the router's ``/metrics`` shows
retries and the breaker counter, and ``r1`` restarted under its id is in
rotation again; (f) a second router with ``fleet_inflight=2`` over a
replica wedged by ``slow_replica`` (0.2 s) answers 16 concurrent
requests with some 503 ``"shed"`` and every 200 right; the phase ends
within 120 s.  It prints the router's and a direct request's p50 / p99
at 1 and 1,000 rows, the rollout's seconds, the time to eject the killed
replica and each replica's advertised bytes beside
``torch.cuda.memory_reserved``.

The ``[lanes]`` phase fails on a solo lane or a ``lanes.stack_error``
event in the stacked run (the solo fallback would hide a K4 that does
not build or launch), on any K1 or K3 launch there, on a launch count
other than cycles x rounds x 6 levels for K4, on any difference in a
tenant's published bytes or gate verdicts between the stacked run and
the host loop, and on a holdout AUC under ``LANE_AUC_FLOOR``.

One clock times every phase (:func:`phase`); the script prints a
``[phases] {"<phase>": seconds, ..., "total": seconds}`` line, then a
``{"kernels": [...]}`` line and the card's name and power limit before
the last line, ``{"ok": true, "device": {...}}``.  A watchdog thread ends
the run at ``SMOKE_DEADLINE_S``: it prints the phase table so far with
the phase that is running, kills every process group the script started
and fails.  ``python3 chip_smoke.py --stop-after PHASE`` runs the phases
up to PHASE and ends there with the phase table (no kernel record, no
result line).  Scratch files go to ``.smoke_out/`` beside this script
(git-ignored).
"""

import atexit
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_TRAIN, N_TEST, N_FEAT = 1_000_000, 100_000, 28
ROUNDS, DEPTH = 20, 6
AUC_FLOOR = 0.93
PARAMS = {"objective": "binary:logistic", "max_depth": DEPTH, "eta": 0.1,
          "max_bin": 64}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and the f32 rate of
# the CUDA cores, which do the kernel's additions (no tensor cores)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# bench.py:bench_multiclass, all 60 rounds
MC_N, MC_TEST, MC_FEAT, MC_K, MC_ROUNDS = 200_000, 20_000, 28, 6, 60
MC_PARAMS = {"objective": "multi:softmax", "num_class": MC_K,
             "max_depth": DEPTH, "eta": 0.3, "max_bin": 64}
# The JAX package reaches holdout merror 0.1827 on this task and config
# (BENCH_r04.json, BENCH_r05.json).  The 20,000 holdout rows give that
# rate a standard error of about 0.0027, so 0.195 lies ~4.5 of them above
# it: a model of the JAX package's quality passes, one that is a point of
# accuracy worse fails.
MERROR_FLOOR = 0.195
# bench.py:bench_otto, its 60 rounds cut to 10
OTTO_N, OTTO_FEAT, OTTO_K, OTTO_ROUNDS = 200_000, 93, 9, 10
OTTO_PARAMS = {"objective": "multi:softprob", "num_class": OTTO_K,
               "max_depth": DEPTH, "eta": 0.3, "max_bin": 64}
# max_depth=0 (tests/test_edge_cases.py:54) on the multiclass task: the
# root's node statistics come from K2, one launch per round for its trees
D0_ROUNDS = 5
D0_PARAMS = {**MC_PARAMS, "max_depth": 0}
# [lanes]: gang-batched tenant training at the Higgs booster's width
# (binary:logistic, depth 6, eta 0.1, max_bin 64, 28 features) and tenant
# scale: tenant i trains on 12,288 + 85 i rows from seed 1000 + i and is
# judged on 2,048 holdout rows from seed 5000 + i; 48 tenants share one
# bucket of 16,384 rows and pad to a stack of 64 lanes
LANES_N, LANE_ROWS0, LANE_ROWS_STEP, LANE_HOLD = 48, 12_288, 85, 2048
LANE_CYCLES, LANE_ROUNDS = 2, 3
LANE_TIMED_CYCLES = 1            # [time] lanes cycle: cycles after cycle 0
LANE_PARAMS = dict(PARAMS)
LANE_STACK = 64                  # 48 tenants pad to a power of two
# The JAX package's own stacked lanes on these 48 tenants' arrays, the
# same parameters, cycles and rounds, on a CPU (``JAX_PLATFORMS=cpu
# python tests/test_torch_lanes.py 48``): holdout AUC 0.90692 at the
# lowest tenant, 0.924 on average.  The floor is that lowest minus 0.005.
LANE_JAX_AUC_MIN = 0.90692
LANE_AUC_FLOOR = LANE_JAX_AUC_MIN - 0.005
# [sample]: [main]'s data and configuration with rows and columns sampled
SAMPLE_PARAMS = {**PARAMS, "subsample": 0.8, "colsample_bytree": 0.8,
                 "colsample_bylevel": 0.8, "seed": 0}
# The JAX package's holdout AUC for SAMPLE_PARAMS on [main]'s data, 20
# rounds, on a CPU (fp32 histograms); the floor is 0.005 under it
SAMPLE_AUC_JAX = 0.939369
# [forest]: bench_multiclass's data as a sampled random forest
FOREST_NPAR, FOREST_ROUNDS = 2, 20
FOREST_PARAMS = {**MC_PARAMS, "num_parallel_tree": FOREST_NPAR,
                 "subsample": 0.8, "colsample_bytree": 0.8}
# The JAX package's holdout merror for FOREST_PARAMS, 20 rounds, on a CPU.
# The 20,000 holdout rows give it a standard error near 0.0028; the bound
# is about 3.5 of them
FOREST_MERROR_JAX = 0.2068
FOREST_MERROR_BOUND = 0.01
# [lanes-sampled]: 8 of [lanes]' tenants at one row count, subsample 0.8
SL_LANES, SL_ROUNDS = 8, 10
SL_PARAMS = {**LANE_PARAMS, "subsample": 0.8}
# [roots]: 200,000 of [main]'s rows, two regimes, one root each
ROOTS_N, ROOTS_ROUNDS = 200_000, 10
ROOTS_PARAMS = {**PARAMS, "num_roots": 2}
# the same rows and roots as a sampled forest: 2 trees a round through K3
ROOTS_FOREST_PARAMS = {**ROOTS_PARAMS, "num_parallel_tree": 2,
                       "subsample": 0.8, "seed": 0}
# The JAX package's holdout AUC for ROOTS_PARAMS on those rows, 10 rounds,
# on a CPU; the floor is 0.005 under it
ROOTS_AUC_JAX = 0.931807
# [subtract] on the multiclass data: rounds of 6 trees under the switch
SUB_MC_ROUNDS = 5
# [profile]: rounds of the profile=2 trace
PROFILE2_ROUNDS = 3
# [rank]: bench.py:bench_rank (rank:ndcg, 1,000,000 x 28 from
# RandomState(11), 10,000 groups of 100, depth 6, eta 0.1, max_bin 64),
# its 50 rounds cut to 20; the group-padded layout is 10,000 groups of
# L = 104 lanes, 1,040,000 slots
RANK_N, RANK_GSIZE, RANK_ROUNDS = 1_000_000, 100, 20
RANK_PARAMS = {"objective": "rank:ndcg", "max_depth": DEPTH, "eta": 0.1,
               "max_bin": 64}
# The JAX package's training-set NDCG for RANK_PARAMS, 20 rounds, on a
# CPU (fp32 histograms, the padded layout); the floor is 0.005 under it
RANK_NDCG_JAX = 0.96991980301737
# [rank-sort]: the same data on the sort path (XGBTPU_RANK_PAD=0), 5
# rounds of rank:map and rank:pairwise; then rank_impl=host on the first
# 100,000 rows, 2 rounds.  Each run's training NDCG against a padded run
# of the same objective, rounds and rows: the layouts draw other pairs
# and order tied predictions otherwise (round 0 ties every row).  A CPU
# run of the port at 200,000 rows put the sort path within 0.0015 of the
# padded one after 5 rounds and the host path within 0.006 after 2
RANK_SORT_ROUNDS, RANK_HOST_N, RANK_HOST_ROUNDS = 5, 100_000, 2
RANK_SORT_TOL, RANK_HOST_TOL = 0.01, 0.02
# [api]: 200,000 Higgs rows (and 50,000 held out), 5 rounds
API_N, API_TEST, API_ROUNDS = 200_000, 50_000, 5
API_PARAMS = {"max_depth": DEPTH, "eta": 0.1, "max_bin": 64}
# [updaters]: [main]'s data and configuration with updater=grow_colmaker
# (5 rounds: K2 at every level, 7 a tree), grow_skmaker (10 rounds: K1
# at levels 0-5, K2 at the terminal one; then [multiclass]'s data, 5
# rounds of 6 trees: K3 and one K2 a round), and refresh on [main]'s
# 20-tree model against a fresh 1M draw (one K2 launch a level for all
# 20 trees), then 2 rounds of grow_histmaker,refresh
UPD_EXACT_ROUNDS, UPD_SK_ROUNDS, UPD_SK_MC_ROUNDS = 5, 10, 5
UPD_REFRESH_SEED, UPD_GROW_REFRESH_ROUNDS = 43, 2
EXACT_PARAMS = {**PARAMS, "updater": "grow_colmaker"}
SK_PARAMS = {**PARAMS, "updater": "grow_skmaker"}
# The JAX package's holdout AUC for EXACT_PARAMS (5 rounds) and
# SK_PARAMS (10 rounds, fp32 histograms) on a CPU, trained on the first
# UPD_JAX_ROWS rows of [main]'s training set (the 100,000 holdout rows
# the same), a CPU-sized run of the reference (a model trained on more
# rows is no worse); the floors are 0.005 under
# (``tests/test_torch_updaters.py`` run as a script prints them)
UPD_JAX_ROWS = 100_000
EXACT_AUC_JAX = 0.928636
SK_AUC_JAX = 0.931701


# ------------------------------------------------------------ phase clock
SMOKE_DEADLINE_S = 1080          # 90% of the run's 1,200 s limit
_T_START = time.perf_counter()
PHASE_SECONDS = {}               # phase -> seconds, in the order run
_RUNNING = [None, 0.0]           # the running phase and its start
CHILDREN = []                    # processes started in sessions of their own


@contextlib.contextmanager
def phase(name):
    """Time the phase ``name`` into the phase table."""
    _RUNNING[:] = [name, time.perf_counter()]
    try:
        yield
    finally:
        PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                               + time.perf_counter() - _RUNNING[1])
        _RUNNING[:] = [None, 0.0]


def print_phases():
    """``[phases] {...}``: every phase's seconds so far, the running one
    marked, and the total."""
    table = {k: round(v, 1) for k, v in PHASE_SECONDS.items()}
    name, t0 = _RUNNING
    if name is not None:
        table[f"{name} (running)"] = round(time.perf_counter() - t0, 1)
    table["total"] = round(time.perf_counter() - _T_START, 1)
    print(f"[phases] {json.dumps(table)}", flush=True)


def start_child(cmd, **kw):
    """``subprocess.Popen(cmd)`` in a session of its own, so that its whole
    process group can be ended (:func:`kill_children`)."""
    proc = subprocess.Popen(cmd, start_new_session=True, **kw)
    CHILDREN.append(proc)
    return proc


def kill_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass


atexit.register(kill_children)


def start_deadline():
    """The watchdog: at ``SMOKE_DEADLINE_S`` it prints the phase table with
    the running phase, ends every process group the script started and
    fails the run."""
    def watch():
        time.sleep(max(0.0, SMOKE_DEADLINE_S
                       - (time.perf_counter() - _T_START)))
        print_phases()
        fail(f"the run passed its deadline of {SMOKE_DEADLINE_S} s in phase "
             f"[{_RUNNING[0]}]")
    threading.Thread(target=watch, daemon=True).start()


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    if threading.current_thread() is not threading.main_thread():
        # the watchdog: end the process, whatever the main thread does
        kill_children()
        sys.stdout.flush()
        os._exit(1)
    sys.exit(1)


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def make_higgs_like(n, f=28, seed=42):
    """The JAX package's benchmark task (``bench.py:make_higgs_like``):
    kinematic-ish features, a nonlinear decision surface, ~30% noise."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, f), dtype=np.float32)
    X[:, : f // 3] = rng.exponential(1.0, (n, f // 3))
    X[:, f // 3: 2 * f // 3] = rng.randn(n, f - 2 * (f // 3) + f // 3)[
        :, : f // 3]
    X[:, 2 * (f // 3):] = rng.rand(n, f - 2 * (f // 3))
    score = (np.sin(3 * X[:, 0]) + X[:, 1] * X[:, 2] - 0.5 * X[:, 3] ** 2
             + 2.0 * (X[:, 4] > 1.0) + 0.8 * rng.randn(n))
    y = (score > np.median(score)).astype(np.float32)
    return X, y


def tenant_arrays(i):
    """Tenant i's (X, y) train rows and (Xh, yh) holdout rows."""
    X, y = make_higgs_like(LANE_ROWS0 + LANE_ROWS_STEP * i, seed=1000 + i)
    Xh, yh = make_higgs_like(LANE_HOLD, seed=5000 + i)
    return X, y, Xh, yh


def cuda_ms(torch, fn, reps):
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def profiled_ms(torch, fn, reps=20):
    """Device time of ``fn()``: the per-call mean of the GPU activities it
    issues (kernels, memsets, copies), summed from ``torch.profiler``'s
    CUDA activities over ``reps`` calls, and those activities by name,
    per call.  The profiler can drop or add activities at a trace's
    edges, so a trace holds ``reps`` warm-up calls, a marker kernel
    (``torch.cuda._sleep``), the ``reps`` timed calls and four markers,
    and only the activities between the markers count; a trace that does
    not see the call's own kernel exactly ``reps`` times there is taken
    again, up to three times.  Back-to-back CUDA-event timing
    (:func:`cuda_ms`) also counts the host's issue time between calls;
    this counts only the card's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda._sleep(100)
            for _ in range(reps):
                fn()
            for _ in range(4):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        acts = sorted((e for e in prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA),
                      key=lambda e: e.start_ns())
        marks = [i for i, e in enumerate(acts) if "spin_kernel" in e.name()]
        acts = acts[marks[0] + 1:marks[1]] if len(marks) >= 2 else []
        names = {}
        for e in acts:
            names[e.name()] = names.get(e.name(), 0) + 1
        if names and max(names.values()) == reps:
            break
    else:
        fail(f"torch.profiler saw no clean trace of {reps} calls: {names}")
    return (sum(e.duration_ns() for e in acts) / 1e6 / reps,
            {k: v / reps for k, v in names.items()})


def make_multiclass(n, f=MC_FEAT, k=MC_K, seed=7):
    """``bench.py:bench_multiclass``'s data: Gaussian features, labels
    the argmax of noisy linear class scores."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    centers = rng.randn(k, f).astype(np.float32) * 1.2
    logits = X @ centers.T + 0.8 * rng.randn(n, k)
    return X, logits.argmax(axis=1).astype(np.float32)


def make_otto(n, f=OTTO_FEAT, k=OTTO_K, seed=21):
    """``bench.py:bench_otto``'s data: skewed count-like features."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32) ** 2
    centers = rng.randn(k, f).astype(np.float32)
    logits = X @ centers.T + 0.5 * rng.randn(n, k)
    return X, logits.argmax(axis=1).astype(np.float32)


def sum_bound_ok(torch, got, want, n, a):
    """|got - want| <= 2 n 2^-24 sum|x| everywhere: each of two orders
    of an n-term f32 sum is within n 2^-24 sum|x| of the exact sum."""
    return not bool(((got - want).abs() > 2.0 * n * 2.0 ** -24 * a).any())


def reset_counts(kernels):
    for mod in kernels.values():
        mod.reset_launches()


def read_counts(kernels):
    return {name: mod.launches for name, mod in kernels.items()}


def only(kernels, **launches):
    """The launch counts of a run that launched ``launches`` and no
    other kernel of ``kernels``."""
    return {**{name: 0 for name in kernels}, **launches}


# ------------------------------------------------------------- phase 3
def plant_bins(torch, bins, B, share, g, dev):
    """Set ``share`` of the bins to values in [B, 256): binning never makes
    them, and the kernels and their plain versions skip them."""
    if share and B < 256:
        hit = torch.rand(bins.shape, generator=g, device=dev) < share
        bins[hit] = torch.randint(B, 256, (int(hit.sum()),), generator=g,
                                  device=dev, dtype=torch.int32).to(
                                      torch.uint8)
    return bins


def hist_case(torch, cuda_hist, N, F, B, M, mode, dyadic, seed, dev,
              inactive=0.2, oob=0.0):
    """One K1 comparison on the same CUDA tensors: ``inactive`` of the
    rows at pos -1, ``oob`` of the bins planted at B or above.  Returns
    max |kernel - plain|."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (N, F), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    pos = torch.randint(0, M, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[torch.rand(N, generator=g, device=dev) < inactive] = -1
    bins = plant_bins(torch, bins, B, oob, g, dev)
    if dyadic:  # multiples of 1/256: f32 sums exact in any order
        gh = torch.randint(-512, 512, (N, 2), generator=g, device=dev,
                           dtype=torch.int32).to(torch.float32) / 256.0
    else:
        gh = torch.randn(N, 2, generator=g, device=dev)
    if mode == "int":
        gh, _ = cuda_hist.quantize_gh(gh)
    got = cuda_hist.level_histogram(bins, gh, pos, M, B, mode)
    want = cuda_hist.level_histogram_plain(bins, gh, pos, M, B, mode)
    torch.cuda.synchronize()
    tag = (f"K1 {mode} N={N} F={F} B={B} n_node={M} dyadic={dyadic} "
           f"inactive={inactive} oob={oob}")
    if got.shape != (F, B, 2, M) or got.dtype != want.dtype:
        fail(f"{tag}: shape {tuple(got.shape)} {got.dtype}")
    if mode == "int" or dyadic:
        if not torch.equal(got, want):
            fail(f"{tag}: not bitwise equal to the plain version")
        return 0.0
    # random f32 gh: the two differ only in the order of additions.  A
    # sum of n terms in any order is within n * 2^-24 * sum|x| of the
    # exact sum (the gamma_n bound), so they are within twice that
    src = gh.to(torch.bfloat16).to(torch.float32) if mode == "bf16" else gh
    n = cuda_hist.level_histogram_plain(bins, torch.ones_like(gh), pos, M,
                                        B, "fp32")
    a = cuda_hist.level_histogram_plain(bins, src.abs(), pos, M, B, "fp32")
    err = (got - want).abs()
    torch.cuda.synchronize()
    if bool((err > 2.0 * n * 2.0 ** -24 * a).any()):
        fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x| "
             f"(max {float(err.max())})")
    return float(err.max())


def phase_kernels(torch, cuda_hist, dev):
    """K1 at the Higgs path's level shapes and beyond: (N, F, B, n_node,
    share of rows inactive, share of bins planted at B or above)."""
    errs = {}
    cases = [(N_TRAIN, N_FEAT, 64, m, 0.2, 0.0)
             for m in (1, 2, 4, 8, 16, 32, 128)]
    cases += [(N_TRAIN, N_FEAT, 256, 64, 0.2, 0.0),
              (N_TRAIN, N_FEAT, 200, 8, 0.2, 0.0), (1000, 3, 7, 3, 0.2, 0.0),
              (1, N_FEAT, 64, 1, 0.0, 0.0), (3, N_FEAT, 64, 2, 0.2, 0.0),
              (12_373, N_FEAT, 64, 32, 0.2, 0.02),
              (OTTO_N, OTTO_FEAT, 64, 32, 0.2, 0.0),
              (100_000, N_FEAT, 1, 4, 0.2, 0.02),
              (100_000, N_FEAT, 64, 64, 0.2, 0.0),
              (100_000, N_FEAT, 64, 8, 1.0, 0.0),
              (N_TRAIN, N_FEAT, 64, 16, 0.2, 0.02)]
    for (n, f, b, m, inactive, oob) in cases:
        variants = [("int", False), ("fp32", True), ("bf16", True)]
        if m in (1, 32, 128) or b != 64 or oob:
            variants += [("fp32", False), ("bf16", False)]
        for mode, dyadic in variants:
            e = hist_case(torch, cuda_hist, n, f, b, m, mode, dyadic,
                          seed=m * 7 + b, dev=dev, inactive=inactive,
                          oob=oob)
            key = mode + ("" if dyadic or mode == "int" else "_random_gh")
            errs[key] = max(errs.get(key, 0.0), e)
        print(f"[K1] N={n} F={f} B={b} n_node={m} inactive={inactive} "
              f"bins>=B {oob}: int8 bitwise, fp32/bf16 bitwise on dyadic gh"
              + (", within bound on random gh" if len(variants) > 3 else ""),
              flush=True)
    print(f"[K1] max |kernel - plain| by mode: {json.dumps(errs)}",
          flush=True)


def batched_case(torch, kb, cuda_hist, N, F, B, T, M, mode, dyadic, seed,
                 dev, inactive=0.2, oob=0.0):
    """One K3 comparison on the same CUDA tensors (rows and bins as
    :func:`hist_case`); in int mode also each tree's slice against a
    solo K1 launch.  Returns max |kernel - plain|."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (N, F), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    pos = torch.randint(0, M, (T, N), generator=g, device=dev,
                        dtype=torch.int32)
    pos[torch.rand(T, N, generator=g, device=dev) < inactive] = -1
    bins = plant_bins(torch, bins, B, oob, g, dev)
    if dyadic:  # multiples of 1/256: f32 sums exact in any order
        gh = torch.randint(-512, 512, (T, N, 2), generator=g, device=dev,
                           dtype=torch.int32).to(torch.float32) / 256.0
    else:
        gh = torch.randn(T, N, 2, generator=g, device=dev)
    if mode == "int":
        gh, _ = cuda_hist.quantize_gh(gh)
    got = kb.level_histogram_batched(bins, gh, pos, M, B, mode)
    want = kb.level_histogram_batched_plain(bins, gh, pos, M, B, mode)
    torch.cuda.synchronize()
    tag = (f"K3 {mode} N={N} F={F} B={B} T={T} n_node={M} "
           f"dyadic={dyadic} inactive={inactive} oob={oob}")
    if got.shape != (F, B, 2, T * M) or got.dtype != want.dtype:
        fail(f"{tag}: shape {tuple(got.shape)} {got.dtype}")
    if mode == "int":
        for t in range(T):
            solo = cuda_hist.level_histogram(bins, gh[t].contiguous(),
                                             pos[t].contiguous(), M, B,
                                             "int")
            if not torch.equal(got[..., t * M:(t + 1) * M], solo):
                fail(f"{tag}: tree {t} differs from a solo K1 launch")
    if mode == "int" or dyadic:
        if not torch.equal(got, want):
            fail(f"{tag}: not bitwise equal to the plain version")
        return 0.0
    src = gh.to(torch.bfloat16).to(torch.float32) if mode == "bf16" else gh
    n = kb.level_histogram_batched_plain(bins, torch.ones_like(gh), pos, M,
                                         B, "fp32")
    a = kb.level_histogram_batched_plain(bins, src.abs(), pos, M, B, "fp32")
    if not sum_bound_ok(torch, got, want, n, a):
        fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x|")
    return float((got - want).abs().max())


def phase_k3(torch, kb, cuda_hist, dev):
    """K3 at the multiclass path's level shapes, otto's, a wide forest's,
    B = 256 and beyond: (N, F, B, T, n_node, share of rows inactive,
    share of bins planted at B or above)."""
    errs = {}
    cases = [(MC_N, MC_FEAT, 64, MC_K, m, 0.2, 0.0)
             for m in (1, 2, 4, 8, 16, 32)]
    cases += [(OTTO_N, OTTO_FEAT, 64, OTTO_K, m, 0.2, 0.0)
              for m in (1, 8, 32)]
    cases += [(MC_N, MC_FEAT, 64, 24, m, 0.2, 0.0) for m in (8, 32, 64)]
    cases += [(MC_N, MC_FEAT, 256, MC_K, m, 0.2, 0.0) for m in (8, 64)]
    cases += [(1000, 3, 7, 3, 3, 0.2, 0.0), (1, MC_FEAT, 64, MC_K, 1, 0.0, 0.0),
              (3, MC_FEAT, 64, MC_K, 2, 0.2, 0.0),
              (12_373, MC_FEAT, 64, MC_K, 32, 0.2, 0.02),
              (MC_N, MC_FEAT, 1, MC_K, 4, 0.2, 0.02),
              (MC_N, MC_FEAT, 64, MC_K, 128, 0.2, 0.0),
              (MC_N, MC_FEAT, 64, MC_K, 8, 1.0, 0.0),
              (MC_N, MC_FEAT, 64, MC_K, 16, 0.2, 0.02)]
    for (n, f, b, t, m, inactive, oob) in cases:
        variants = [("int", False), ("fp32", True), ("bf16", True)]
        if m in (1, 32) or b != 64 or oob:
            variants += [("fp32", False), ("bf16", False)]
        for mode, dyadic in variants:
            e = batched_case(torch, kb, cuda_hist, n, f, b, t, m, mode,
                             dyadic, seed=m * 7 + b + t, dev=dev,
                             inactive=inactive, oob=oob)
            key = mode + ("" if dyadic or mode == "int" else "_random_gh")
            errs[key] = max(errs.get(key, 0.0), e)
        print(f"[K3] N={n} F={f} B={b} T={t} n_node={m} inactive={inactive} "
              f"bins>=B {oob}: int8 bitwise and each tree == solo K1, "
              "fp32/bf16 bitwise on dyadic gh"
              + (", within bound on random gh" if len(variants) > 3 else ""),
              flush=True)
    print(f"[K3] max |kernel - plain| by mode: {json.dumps(errs)}",
          flush=True)


def phase_k2(torch, kn, dev):
    """K2 at the depth-0 path's shapes (T = 1 and 6 trees of 200k rows),
    with more nodes, and at the exact and refresh paths' shapes (T = 1
    and 20 trees of 1,000,000 rows at 64 nodes): dyadic gh bitwise,
    random gh within the f32 summation bound, and the same bits on a
    second launch.  Times the new shapes (events) beside the plain
    version."""
    max_err = 0.0
    for T, M, N in ((1, 1, MC_N), (MC_K, 1, MC_N), (MC_K, 8, MC_N),
                    (2, 20, MC_N), (1, 64, N_TRAIN), (20, 64, N_TRAIN)):
        g = torch.Generator(device=dev).manual_seed(T * 31 + M)
        pos = torch.randint(0, M, (T, N), generator=g, device=dev,
                            dtype=torch.int32)
        pos[torch.rand(T, N, generator=g, device=dev) < 0.2] = -1
        dy = torch.randint(-512, 512, (T, N, 2), generator=g, device=dev,
                           dtype=torch.int32).to(torch.float32) / 256.0
        tag = f"K2 N={N} T={T} n_node={M}"
        got = kn.node_stats(dy, pos, M)
        if got.shape != (T, M, 2) or not torch.equal(
                got, kn.node_stats_plain(dy, pos, M)):
            fail(f"{tag}: not bitwise equal to the plain version on "
                 "dyadic gh")
        gh = torch.randn(T, N, 2, generator=g, device=dev)
        got = kn.node_stats(gh, pos, M)
        want = kn.node_stats_plain(gh, pos, M)
        n = kn.node_stats_plain(torch.ones_like(gh), pos, M)
        a = kn.node_stats_plain(gh.abs(), pos, M)
        torch.cuda.synchronize()
        if not sum_bound_ok(torch, got, want, n, a):
            fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x|")
        if not torch.equal(kn.node_stats(gh, pos, M), got):
            fail(f"{tag}: two launches gave different bits")
        max_err = max(max_err, float((got - want).abs().max()))
        extra = ""
        if N == N_TRAIN:
            ms = cuda_ms(torch, lambda: kn.node_stats(gh, pos, M), 20)
            plain = cuda_ms(torch, lambda: kn.node_stats_plain(gh, pos, M),
                            5)
            nbytes = T * N * 12 + T * M * 8
            extra = (f"; {ms:.4f} ms (plain {plain:.4f}, bound "
                     f"{nbytes / PEAK_BYTES_S * 1e3:.4f} bytes)")
        print(f"[K2] N={N} T={T} n_node={M}: bitwise on dyadic gh, "
              f"within bound on random gh, deterministic{extra}", flush=True)
    print(f"[K2] max |kernel - plain| on random gh: {max_err}", flush=True)


def lanes_case(torch, k4, cuda_hist, L, L_real, N, F, B, M, mode, dyadic,
               seed, dev, oob=0.0):
    """One K4 comparison on the same CUDA tensors: L lanes, the first
    L_real real with their own row counts (pad rows past them), the rest
    pad lanes, ``oob`` of the bins planted at B or above.  In int mode
    also each lane against a solo K1 launch on its unpadded rows.
    Returns max |kernel - plain|."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (L, N, F), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    pos = torch.randint(0, M, (L, N), generator=g, device=dev,
                        dtype=torch.int32)
    pos[torch.rand(L, N, generator=g, device=dev) < 0.2] = -1
    bins = plant_bins(torch, bins, B, oob, g, dev)
    if dyadic:  # multiples of 1/256: f32 sums exact in any order
        gh = torch.randint(-512, 512, (L, N, 2), generator=g, device=dev,
                           dtype=torch.int32).to(torch.float32) / 256.0
    else:
        gh = torch.randn(L, N, 2, generator=g, device=dev)
    n_real = [int(n) for n in np.random.RandomState(seed).randint(
        N // 2, N + 1, L)]
    n_real = [N] + n_real[1:L_real] + [0] * (L - L_real)
    real = (torch.arange(N, device=dev)[None, :]
            < torch.tensor(n_real, device=dev)[:, None])
    pos = torch.where(real, pos, -1)
    gh = torch.where(real[..., None], gh, 0.0)
    if mode == "int":
        gh, _ = cuda_hist.quantize_gh(gh)      # per-lane scales
    got = k4.level_histogram_lanes(bins, gh, pos, M, B, mode)
    want = k4.level_histogram_lanes_plain(bins, gh, pos, M, B, mode)
    torch.cuda.synchronize()
    tag = (f"K4 {mode} L={L} ({L_real} real) N={N} F={F} B={B} "
           f"n_node={M} dyadic={dyadic} oob={oob}")
    if got.shape != (F, B, 2, L * M) or got.dtype != want.dtype:
        fail(f"{tag}: shape {tuple(got.shape)} {got.dtype}")
    if mode == "int":
        for lane, n in enumerate(n_real):
            sl = got[..., lane * M:(lane + 1) * M]
            if n == 0:
                if bool(sl.any()):
                    fail(f"{tag}: pad lane {lane} is not zero")
                continue
            solo = cuda_hist.level_histogram(
                bins[lane, :n].contiguous(), gh[lane, :n].contiguous(),
                pos[lane, :n].contiguous(), M, B, "int")
            if not torch.equal(sl, solo):
                fail(f"{tag}: lane {lane} differs from a solo K1 launch")
    if mode == "int" or dyadic:
        if not torch.equal(got, want):
            fail(f"{tag}: not bitwise equal to the plain version")
        return 0.0
    src = gh.to(torch.bfloat16).to(torch.float32) if mode == "bf16" else gh
    n = k4.level_histogram_lanes_plain(bins, torch.ones_like(gh), pos, M, B,
                                       "fp32")
    a = k4.level_histogram_lanes_plain(bins, src.abs(), pos, M, B, "fp32")
    if not sum_bound_ok(torch, got, want, n, a):
        fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x|")
    return float((got - want).abs().max())


def phase_k4(torch, k4, cuda_hist, dev):
    """K4 at the lanes path's level shapes (64 lanes, 48 real, of 16,384
    rows; the atomic flush at the shallow levels, the store flush at the
    deep ones), with F = 93, B = 7 and 256, node tiles past 64 nodes,
    one lane and three, a tiny odd shape, and 2% of the bins planted at
    B or above; pad rows in every real lane but the first."""
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    errs = {}
    cases = [(LANE_STACK, LANES_N, 16384, N_FEAT, 64, m, 0.0)
             for m in (1, 8, 16, 32)]
    cases += [(LANE_STACK, LANES_N, 16384, N_FEAT, 64, 32, 0.02),
              (LANE_STACK, LANES_N, 16384, N_FEAT, 64, 2, 0.02),
              (8, 8, 16384, OTTO_FEAT, 64, 4, 0.0),
              (3, 3, 20000, N_FEAT, 256, 64, 0.0),
              (3, 2, 3001, 6, 7, 128, 0.02),
              (1, 1, 50000, N_FEAT, 64, 128, 0.02),
              (LANE_STACK, 40, 2048, N_FEAT, 256, 128, 0.0),
              (4, 3, 1000, 3, 7, 3, 0.02)]
    for (L, Lr, n, f, b, m, oob) in cases:
        variants = [("int", False), ("fp32", True), ("bf16", True)]
        if m in (1, 32, 128) or b != 64 or oob:
            variants += [("fp32", False), ("bf16", False)]
        for mode, dyadic in variants:
            e = lanes_case(torch, k4, cuda_hist, L, Lr, n, f, b, m, mode,
                           dyadic, seed=L * 13 + m + b, dev=dev, oob=oob)
            key = mode + ("" if dyadic or mode == "int" else "_random_gh")
            errs[key] = max(errs.get(key, 0.0), e)
        flush = "store" if kb.launch_plan("hist_lanes", n, f, b, L, m, "int",
                                          dev).store else "atomic"
        print(f"[K4] L={L} ({Lr} real, pad rows) N={n} F={f} B={b} "
              f"n_node={m} bins>=B {oob} ({flush} flush): int8 bitwise and "
              "each lane == solo K1, pad lanes zero, fp32/bf16 bitwise on "
              "dyadic gh"
              + (", within bound on random gh" if len(variants) > 3 else ""),
              flush=True)
    print(f"[K4] max |kernel - plain| by mode: {json.dumps(errs)}",
          flush=True)


# ------------------------------------------------------------- phase 4
def phase_main(torch, xt, cuda_hist, kernels, device, card):
    from xgboost_tpu_torch.metrics import auc

    t0 = time.perf_counter()
    X, y = make_higgs_like(N_TRAIN + N_TEST)
    dtrain = xt.DMatrix(X[:N_TRAIN], label=y[:N_TRAIN])
    dtest = xt.DMatrix(X[N_TRAIN:], label=y[N_TRAIN:])
    print(f"[main] data {N_TRAIN} + {N_TEST} x {N_FEAT}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the counted run: counts to 0 just before, read just after
    reset_counts(kernels)
    t0 = time.perf_counter()
    bst = xt.train(PARAMS, dtrain, ROUNDS, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    launches = counts["hist_level"]
    print(f"[main] train {ROUNDS} rounds (cuts and binning included): "
          f"{train_s:.2f} s; hist_level launches {launches}; all counts "
          f"{json.dumps(counts)}", flush=True)
    if counts != only(kernels, hist_level=ROUNDS * DEPTH):
        fail(f"launch counts {counts}: want hist_level {ROUNDS * DEPTH}, "
             "the others 0")
    B = bst.gbtree.cuts.max_bin
    print(f"[main] bins B={B} (hist_bin_align auto -> 32 on the GPU)",
          flush=True)

    pred = bst.predict(dtest)
    if pred.shape != (N_TEST,) or not np.isfinite(pred).all():
        fail(f"holdout predictions: shape {pred.shape}, finite "
             f"{np.isfinite(pred).all()}")
    score = auc(pred, y[N_TRAIN:], np.ones(N_TEST, np.float32))
    print(f"[main] holdout AUC {score:.6f} (floor {AUC_FLOOR})", flush=True)
    if not score >= AUC_FLOOR:
        fail(f"holdout AUC {score} < {AUC_FLOOR}")
    raw = bst.save_raw()

    # ms per round: a second booster, round 0 (cuts, binning) untimed
    bst2 = xt.Booster(PARAMS, cache=[dtrain], device=device)
    bst2.update(dtrain, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst2.update_many(dtrain, 1, ROUNDS - 1)
    torch.cuda.synchronize()
    ms_round = (time.perf_counter() - t0) * 1e3 / (ROUNDS - 1)
    print(f"[main] {ms_round:.3f} ms per round ({N_TRAIN / ms_round * 1e3:.4g}"
          f" rows/s) | {card}", flush=True)
    if bst2.save_raw() != raw:
        fail("a second int8 run gave different model bytes")

    # the same rounds with the plain histogram forced on the card
    kernel_fn = cuda_hist.level_histogram
    cuda_hist.level_histogram = cuda_hist.level_histogram_plain
    try:
        plain = xt.train(PARAMS, dtrain, ROUNDS, device=device)
    finally:
        cuda_hist.level_histogram = kernel_fn
    if plain.save_raw() != raw:
        fail("kernel and plain histograms grew different models")
    print("[main] plain-histogram run: identical model bytes", flush=True)

    path = os.path.join(HERE, ".smoke_out", "smoke_model.bin")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    bst.save_model(path)
    loaded = xt.Booster(model_file=path, device=device)
    if not np.array_equal(loaded.predict(dtest), pred):
        fail("predictions changed over save_model / load_model")
    print("[main] save/load: bitwise-equal predictions", flush=True)

    # every level's real inputs, captured from one more round
    captured = []

    def capture(bins, gh, pos, n_node, n_bin, mode):
        captured.append((bins, gh.clone(), pos.clone(), n_node, n_bin, mode))
        return kernel_fn(bins, gh, pos, n_node, n_bin, mode)
    cuda_hist.level_histogram = capture
    try:
        xt.train(PARAMS, dtrain, 1, device=device)
    finally:
        cuda_hist.level_histogram = kernel_fn
    max_err = 0.0
    for bins, gh, pos, M, nb, mode in captured:
        got = kernel_fn(bins, gh, pos, M, nb, mode)
        want = cuda_hist.level_histogram_plain(bins, gh, pos, M, nb, mode)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - want).abs().max()))
        if mode != "int" or not torch.equal(got, want):
            fail(f"main-path level n_node={M}: mode {mode}, kernel != plain")
    print(f"[main] kernel == plain, int8 bitwise, at all {len(captured)} "
          "main-path levels", flush=True)
    main_out = {"X": X, "y": y, "state": bst.gbtree.get_state(),
                "auc": score, "train_s": train_s, "ms_round": ms_round,
                "raw": raw}
    return launches, ms_round, captured, max_err, main_out


# ------------------------------------------------------------------ [cli]
CLI_LANES, CLI_LANE_ROUNDS = 8, 10


def run_cli(args):
    """``xgboost_tpu_torch.cli.main(args)`` in this process: (exit code,
    its standard error)."""
    import contextlib
    import io

    from xgboost_tpu_torch.cli import main as cli_main
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main(list(args))
    return rc, err.getvalue()


def write_conf(path, **kw):
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in kw.items()))
    return path


def write_libsvm_text(path, X, y):
    """Rows as libsvm text, values as ``{:.9g}`` (they read back as the
    same float32)."""
    with open(path, "w") as f:
        for row, label in zip(X.tolist(), y.tolist()):
            f.write(f"{label:g} " + " ".join(
                f"{j}:{v:.9g}" for j, v in enumerate(row)) + "\n")


def same_trees(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def phase_cli(torch, xt, kernels, device, card, main_out):
    """The command line on [main]'s data: buffers, ``task=train`` of the
    Higgs configuration, ``pred``, ``eval``, ``dump`` and ``lanes``, with
    every check of the module docstring."""
    import shutil

    from xgboost_tpu_torch.metrics import auc as auc_of
    from xgboost_tpu_torch.pipeline import (CallableDataSource,
                                            run_tenant_lanes)
    root = os.path.join(HERE, ".smoke_out", "cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    X, y = main_out["X"], main_out["y"]
    t_phase = time.perf_counter()

    # 1. buffers of [main]'s train set and holdout
    train_buf = os.path.join(root, "higgs-train.buffer")
    test_buf = os.path.join(root, "higgs-test.buffer")
    t0 = time.perf_counter()
    xt.DMatrix(X[:N_TRAIN], label=y[:N_TRAIN]).save_binary(train_buf)
    xt.DMatrix(X[N_TRAIN:], label=y[N_TRAIN:]).save_binary(test_buf)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dtrain = xt.DMatrix(train_buf)
    dtest = xt.DMatrix(test_buf)
    load_s = time.perf_counter() - t0
    if not (dtrain.num_row == N_TRAIN and dtrain.num_col == N_FEAT
            and np.array_equal(dtrain.values, X[:N_TRAIN].ravel())
            and np.array_equal(dtrain.get_label(), y[:N_TRAIN])
            and np.array_equal(dtest.values, X[N_TRAIN:].ravel())):
        fail("the train / holdout buffers do not hold [main]'s matrix")
    mb = sum(os.path.getsize(p) for p in (train_buf, test_buf)) / 2 ** 20
    print(f"[cli] buffers of [main]'s {N_TRAIN} + {N_TEST} x {N_FEAT} "
          f"rows ({mb:.1f} MiB): write {write_s:.2f} s, load {load_s:.2f} "
          "s; the same values and labels as [main]'s dense matrix",
          flush=True)

    # 2. task=train of the Higgs configuration (bench.py:394-401)
    ckpt = os.path.join(root, "ckpt")
    conf = write_conf(
        os.path.join(root, "higgs.conf"), task="train",
        objective="binary:logistic", max_depth=DEPTH, eta=0.1, max_bin=64,
        num_round=ROUNDS, data=train_buf, **{"eval[test]": test_buf},
        eval_metric="auc", save_period=10, model_dir=root,
        checkpoint_dir=ckpt, silent=0, device=device)
    reset_counts(kernels)
    t0 = time.perf_counter()
    rc, err = run_cli([conf])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    lines = [ln for ln in err.splitlines() if ln.startswith("[")]
    plan = [ln for ln in err.splitlines() if ln.startswith("fusing")]
    print(f"[cli] task=train: exit {rc}, {train_s:.2f} s (buffer load, "
          f"cuts, binning, {ROUNDS} rounds with their eval lines and saves);"
          f" {plan[0] if plan else 'no plan line'}; hist_level launches "
          f"{counts['hist_level']}; all counts {json.dumps(counts)}",
          flush=True)
    if rc != 0:
        fail(f"task=train exited {rc}: {err[-2000:]}")
    if counts != only(kernels, hist_level=ROUNDS * DEPTH):
        fail(f"task=train launch counts {counts}: want hist_level "
             f"{ROUNDS * DEPTH} as in [main], the others 0")
    model = os.path.join(root, f"{ROUNDS:04d}.model")
    ring = sorted(f for f in os.listdir(ckpt) if f.startswith("ckpt-"))
    for path in (os.path.join(root, "0010.model"), model):
        if not os.path.exists(path):
            fail(f"task=train left no {os.path.basename(path)}")
    if len(ring) != 2 or ring[-1] != f"ckpt-{ROUNDS:06d}.model":
        fail(f"checkpoint ring {ring}: want two members, the newest at "
             f"round {ROUNDS}")
    bst = xt.Booster(model_file=model, device=device)
    if not same_trees(bst.gbtree.get_state(), main_out["state"]):
        fail("the CLI's model differs from [main]'s: tree arrays, cuts "
             "and bins must be bitwise equal")
    want_auc = f"{main_out['auc']:.6f}"
    if len(lines) != ROUNDS or not lines[-1].startswith(f"[{ROUNDS - 1}]"):
        fail(f"task=train printed {len(lines)} eval lines: {lines[-3:]}")
    if lines[-1] != f"[{ROUNDS - 1}]\ttest-auc:{want_auc}":
        fail(f"last eval line {lines[-1]!r}: want test-auc {want_auc} "
             "([main]'s holdout AUC)")
    print(f"[cli] model == [main]'s, bitwise (tree arrays, cuts); last eval "
          f"line {lines[-1]!r} == [main]'s AUC {want_auc}; 0010.model, "
          f"0020.model and ring {ring} written", flush=True)
    print(f"[cli] {train_s * 1e3 / ROUNDS:.3f} ms per round through the "
          f"CLI (everything above included) against [main]'s "
          f"{main_out['train_s'] * 1e3 / ROUNDS:.3f} (train() with cuts "
          f"and binning) and {main_out['ms_round']:.3f} (rounds alone) | "
          f"{card}", flush=True)

    # 3. task=pred on the holdout as libsvm text
    text = os.path.join(root, "higgs-test.libsvm")
    t0 = time.perf_counter()
    write_libsvm_text(text, X[N_TRAIN:], y[N_TRAIN:])
    text_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = xt.DMatrix(text)
    parse_s = time.perf_counter() - t0
    if not np.array_equal(parsed.values, dtest.values):
        fail("the holdout's libsvm text does not read back as its buffer")
    print(f"[cli] holdout as libsvm text: write {text_write_s:.2f} s, "
          f"parse {parse_s:.2f} s, against {load_s:.2f} s to load both "
          "buffers", flush=True)
    reset_counts(kernels)
    for margin in (0, 1):
        out = os.path.join(root, f"pred{margin}.txt")
        t0 = time.perf_counter()
        rc, err = run_cli([conf, "task=pred", f"model_in={model}",
                           f"test:data={text}", f"name_pred={out}",
                           f"pred_margin={margin}", "silent=1"])
        pred_s = time.perf_counter() - t0
        want = bst.predict(dtest, output_margin=bool(margin))
        with open(out) as f:
            got = f.read().splitlines()
        if rc != 0 or got != [f"{p:g}" for p in want]:
            fail(f"task=pred pred_margin={margin}: exit {rc}, lines != "
                 "Booster.predict on the buffer")
        print(f"[cli] task=pred pred_margin={margin}: {pred_s:.2f} s "
              f"(parse included); {len(got)} lines == f'{{p:g}}' of "
              "Booster.predict on the buffer", flush=True)

    # 4. task=eval
    t0 = time.perf_counter()
    rc, err = run_cli([conf, "task=eval", f"model_in={model}", "silent=1"])
    eval_s = time.perf_counter() - t0
    want = xt.Booster(model_file=model, device=device).eval_set(
        [(dtest, "test")], 0)
    got = [ln for ln in err.splitlines() if ln.startswith("[")]
    if rc != 0 or got != [want]:
        fail(f"task=eval printed {got}: want [{want!r}]")
    print(f"[cli] task=eval: {eval_s:.2f} s; {got[0]!r} == eval_set's line",
          flush=True)

    # 5. task=dump with stats and a 28-line fmap
    fmap = os.path.join(root, "featmap.txt")
    with open(fmap, "w") as f:
        f.write("".join(f"{i}\thiggs{i}\tq\n" for i in range(N_FEAT)))
    dump = os.path.join(root, "dump.txt")
    t0 = time.perf_counter()
    rc, err = run_cli([conf, "task=dump", f"model_in={model}",
                       f"fmap={fmap}", "dump_stats=1", f"name_dump={dump}",
                       "silent=1"])
    dump_s = time.perf_counter() - t0
    with open(dump) as f:
        text_dump = f.read()
    want = "".join(f"booster[{i}]:\n{d}"
                   for i, d in enumerate(bst.get_dump(fmap, True)))
    if rc != 0 or text_dump != want or text_dump.count("booster[") != ROUNDS:
        fail(f"task=dump: exit {rc}, {text_dump.count('booster[')} "
             "boosters, or text != get_dump of the loaded model")
    counts = read_counts(kernels)
    if counts != only(kernels):
        fail(f"pred / eval / dump launched a histogram kernel: {counts}")
    print(f"[cli] task=dump: {dump_s:.2f} s; {ROUNDS} boosters == get_dump "
          f"with stats and the fmap; pred / eval / dump launched no "
          "histogram kernel", flush=True)

    # 6. task=lanes on 8 of [lanes]'s tenants, as per-lane buffers
    names = [f"tenant{i:02d}" for i in range(CLI_LANES)]
    arrays = [tenant_arrays(i) for i in range(CLI_LANES)]
    for name, (Xl, yl, Xh, yh) in zip(names, arrays):
        xt.DMatrix(Xl, label=yl).save_binary(
            os.path.join(root, f"{name}-train.buffer"))
        xt.DMatrix(Xh, label=yh).save_binary(
            os.path.join(root, f"{name}-hold.buffer"))
    lanes_dir = os.path.join(root, "lanes")
    lconf = write_conf(
        os.path.join(root, "lanes.conf"), task="lanes", silent=1,
        objective="binary:logistic", max_depth=DEPTH, eta=0.1, max_bin=64,
        lanes=",".join(f"{n}={os.path.join(lanes_dir, n, 'model.bin')}"
                       for n in names),
        lanes_dir=lanes_dir,
        lane_data=os.path.join(root, "{lane}-train.buffer"),
        lane_holdout=os.path.join(root, "{lane}-hold.buffer"),
        lane_stack=1, lane_rounds_per_cycle=CLI_LANE_ROUNDS, lane_cycles=1,
        pipeline_metric="auc", lane_window_ms=300000, device=device)
    reset_counts(kernels)
    t0 = time.perf_counter()
    rc, err = run_cli([lconf])
    torch.cuda.synchronize()
    lanes_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    print(f"[cli] task=lanes, {CLI_LANES} tenants, 1 cycle of "
          f"{CLI_LANE_ROUNDS} rounds, lane_stack=1: exit {rc}, "
          f"{lanes_s:.2f} s; hist_lanes launches {counts['hist_lanes']}; "
          f"all counts {json.dumps(counts)}", flush=True)
    if rc != 0:
        fail(f"task=lanes exited {rc}: {err[-2000:]}")
    if counts["hist_lanes"] <= 0 or counts != only(
            kernels, hist_lanes=counts["hist_lanes"]):
        fail(f"task=lanes launch counts {counts}: want K4, and no K1")
    api = {}
    for name, (Xl, yl, Xh, yh) in zip(names, arrays):
        pair = (xt.DMatrix(Xl, label=yl), xt.DMatrix(Xh, label=yh))
        d = os.path.join(root, "api", name)
        api[name] = {"publish_path": os.path.join(d, "model.bin"),
                     "workdir": d,
                     "source": CallableDataSource(lambda c, p=pair: p),
                     "rounds_per_cycle": CLI_LANE_ROUNDS, "cycles": 1,
                     "metric": "auc", "params": dict(LANE_PARAMS, seed=0)}
    res = run_tenant_lanes(api, quiet=True, stacked=True, window_sec=300.0,
                           device=device)
    if any(r["status"] != "ok" for r in res.values()):
        fail(f"API lanes not ok: {res}")
    aucs = []
    for i, name in enumerate(names):
        cli_model = os.path.join(lanes_dir, name, "model.bin")
        if not os.path.exists(cli_model):
            fail(f"task=lanes: {name} published nothing")
        b = xt.Booster(model_file=cli_model, device=device)
        ref = xt.Booster(model_file=api[name]["publish_path"], device=device)
        if not same_trees(b.gbtree.get_state(), ref.gbtree.get_state()):
            fail(f"task=lanes: {name}'s trees differ from run_tenant_lanes'")
        Xh, yh = arrays[i][2], arrays[i][3]
        aucs.append(auc_of(b.predict(xt.DMatrix(Xh)), yh,
                           np.ones(len(yh), np.float32)))
    print(f"[cli] task=lanes: every tenant published, trees == "
          f"run_tenant_lanes through the API, bitwise; holdout AUC min "
          f"{min(aucs):.6f} | {card}", flush=True)
    print(f"[cli] phase {time.perf_counter() - t_phase:.1f} s: train "
          f"{train_s:.2f}, eval {eval_s:.2f}, dump {dump_s:.2f}, lanes "
          f"{lanes_s:.2f} s", flush=True)
    return counts["hist_lanes"]


# ----------------------------------------------------------------- [dist]
# row-split training (xgboost_tpu_torch.parallel) on [main]'s data from
# [cli]'s buffers: W ranks on this one card over gloo, each launched by
# the port's launcher, the CLI or the worker entry of this script
DIST_WORLDS = (2, 4)
# each launch's limit, about three times its seconds on an H100 at 700 W
# (PERF.md section 6): the CLI launches that run at once 42-86 s, the
# checks worker 43-60 s; dist_wait allows DIST_GRACE_S more
DIST_LIMIT_S = 240
DIST_CHECK_LIMIT_S = 180
DIST_GRACE_S = 10
DIST_MC_N = 200_000
DIST_PARAMS = {**PARAMS, "dsplit": "row", "device_sketch": 0}
# (g): [main]'s configuration by features; (h): exact column split on
# [main]'s first rows; (i): rank:ndcg under row split on make_rank's
# generator, 2,000 groups of 100 rows
DIST_COL_PARAMS = {**PARAMS, "dsplit": "col"}
DIST_EXACT_N, DIST_EXACT_ROUNDS = 200_000, 3
DIST_EXACT_PARAMS = {**PARAMS, "updater": "grow_colmaker", "dsplit": "col"}
DIST_RANK_N, DIST_RANK_ROUNDS = 200_000, 5
DIST_RANK_PARAMS = {"objective": "rank:ndcg", "max_depth": DEPTH,
                    "eta": 0.1, "max_bin": 64, "dsplit": "row",
                    "device_sketch": 0}


def dist_launch(n, cmd, cwd, limit=DIST_LIMIT_S):
    """``python -m xgboost_tpu_torch.parallel.launch -n n cmd`` from
    ``cwd``, started; the launcher ends its ranks past ``limit`` s."""
    env = dict(os.environ, PYTHONPATH=HERE)
    proc = start_child(
        [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch", "-n",
         str(n), "--timeout-sec", str(limit), *cmd], cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.t0, proc.limit = time.perf_counter(), limit
    return proc


def dist_wait(procs):
    """Wait for launches ``{name: proc}`` at once: ``{name: (stdout,
    stderr, seconds from its start to its end)}``.  Any failed rank, a
    hang or a launcher past its limit fails the phase (gate f)."""
    done = {}

    def wait(name, proc):
        try:
            out, err = proc.communicate(timeout=proc.limit + DIST_GRACE_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        done[name] = (out, err, time.perf_counter() - proc.t0)
    threads = [threading.Thread(target=wait, args=item)
               for item in procs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print("[dist] launches: " + ", ".join(
        f"{name} {done[name][2]:.1f} s (limit {proc.limit} s)"
        for name, proc in procs.items()), flush=True)
    for name, proc in procs.items():
        if proc.returncode != 0:
            fail(f"[dist] {name}: launcher exit {proc.returncode} (124: a "
                 f"rank hung past {proc.limit} s): "
                 f"{done[name][1][-3000:]}")
    return done


def dist_eval_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith("[")
            and "\t" in ln]


def state_sha(state):
    """One hash of a model's tree arrays and cuts (``get_state``)."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode() + np.ascontiguousarray(state[k]).tobytes())
    return h.hexdigest()


def timed_rounds(torch, comm, kernels, bst, dtrain, rounds):
    """Rounds 1 to ``rounds - 1`` of a booster whose round 0 ran:
    (ms a round, launch counts, collectives a round)."""
    torch.cuda.synchronize()
    before = comm.totals()
    reset_counts(kernels)
    t0 = time.perf_counter()
    bst.update_many(dtrain, 1, rounds - 1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (rounds - 1)
    return ms, read_counts(kernels), comm_per(comm, before, rounds - 1)


def comm_per(comm, before, n):
    """The collectives since ``before`` (``comm.totals()``), per one of
    ``n`` rounds."""
    after = comm.totals()
    return {op: {k: (after[op][k] - before[op][k]) / n for k in after[op]}
            for op in after}


def dist_col_checks(torch, xt, kernels, dtrain, res):
    """Gates g-i on this rank: [main]'s rounds by features (round 0's K1
    on this rank's block == plain, rounds 1-19 timed); exact column
    split on DIST_EXACT_N of [main]'s rows, each K2 launch within its
    bound of the f64 sums; rank:ndcg under row split."""
    from xgboost_tpu_torch.obs import comm
    from xgboost_tpu_torch.ops import cuda_hist, cuda_node_stats
    kernel_fn = cuda_hist.level_histogram
    captured = []

    def capture(bins, gh, pos, n_node, n_bin, mode):
        captured.append((bins, gh.clone(), pos.clone(), n_node, n_bin, mode))
        return kernel_fn(bins, gh, pos, n_node, n_bin, mode)
    bst = xt.Booster(DIST_COL_PARAMS, cache=[dtrain])
    cuda_hist.level_histogram = capture
    try:
        bst.update(dtrain, 0)                  # cuts, binning: untimed
    finally:
        cuda_hist.level_histogram = kernel_fn
    res["col_levels"] = [
        [int(bins.shape[1]), M, bool(torch.equal(
            kernel_fn(bins, gh, pos, M, nb, mode),
            cuda_hist.level_histogram_plain(bins, gh, pos, M, nb, mode)))]
        for bins, gh, pos, M, nb, mode in captured]
    del captured
    res["col_ms"], res["col_counts"], res["col_comm"] = timed_rounds(
        torch, comm, kernels, bst, dtrain, ROUNDS)
    res["col_sha"] = state_sha(bst.gbtree.get_state())
    del bst
    # (h)
    X, y = make_higgs_like(N_TRAIN + N_TEST)
    dx = xt.DMatrix(X[:DIST_EXACT_N], label=y[:DIST_EXACT_N])
    del X, y
    k2_fn = cuda_node_stats.node_stats
    calls = []

    def capture2(gh, pos, n_node):
        calls.append((gh.clone(), pos.clone(), n_node))
        return k2_fn(gh, pos, n_node)
    before = comm.totals()
    reset_counts(kernels)
    cuda_node_stats.node_stats = capture2
    t0 = time.perf_counter()
    try:
        bx = xt.train(DIST_EXACT_PARAMS, dx, DIST_EXACT_ROUNDS)
    finally:
        cuda_node_stats.node_stats = k2_fn
    torch.cuda.synchronize()
    res["exact_s"] = time.perf_counter() - t0
    res["exact_counts"] = read_counts(kernels)
    res["exact_comm"] = comm_per(comm, before, DIST_EXACT_ROUNDS)
    res["exact_sha"] = hashlib_sha(bx.save_raw())
    res["exact_k2"] = []
    for gh, pos, M in calls:
        got, want = k2_fn(gh, pos, M), node_sums_f64(torch, gh, pos, M)
        res["exact_k2"].append([M, ratio(got, want, k2_bound(
            torch, gh, pos, M)), float((got.double() - want).abs().max())])
    del bx, dx, calls
    # (i)
    dr = rank_dmatrix(xt, *make_rank(DIST_RANK_N))
    before = comm.totals()
    reset_counts(kernels)
    t0 = time.perf_counter()
    br = xt.train(DIST_RANK_PARAMS, dr, DIST_RANK_ROUNDS)
    torch.cuda.synchronize()
    res["rank_s"] = time.perf_counter() - t0
    res["rank_counts"] = read_counts(kernels)
    res["rank_comm"] = comm_per(comm, before, DIST_RANK_ROUNDS)
    res["rank_sha"] = hashlib_sha(br.save_raw())


def hashlib_sha(raw: bytes) -> str:
    import hashlib
    return hashlib.sha256(raw).hexdigest()


def dist_worker(out_dir):
    """A rank of [dist]'s own checks (gates c, e, g-i), launched by the
    port's launcher: the timed Higgs rounds with this rank's launch
    counts and collective tallies, every level's K1 on
    this rank's block against the plain version, the reduced level
    against the plain histogram of all rows, a refresh pass's K2, the
    device sketch's cuts on this rank, a 6-class round (K3) and
    :func:`dist_col_checks`."""
    import hashlib

    import torch
    sys.path.insert(0, HERE)
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.obs import comm
    from xgboost_tpu_torch.ops import (cuda_hist, cuda_hist_batched,
                                       cuda_node_stats)
    from xgboost_tpu_torch.parallel.launch import init_worker
    from xgboost_tpu_torch.parallel.mesh import data_parallel_mesh
    init_worker()
    mesh = data_parallel_mesh("cuda")
    kernels = {"hist_level": cuda_hist, "hist_batched": cuda_hist_batched,
               "node_stats": cuda_node_stats}
    res = {"rank": mesh.rank, "world": mesh.world}
    dtrain = xt.DMatrix(os.path.join(HERE, ".smoke_out", "cli",
                                     "higgs-train.buffer"))
    bst = xt.Booster(DIST_PARAMS, cache=[dtrain])
    bst.update(dtrain, 0)                      # cuts, binning: untimed
    res["ms_round"], res["counts"], res["comm"] = timed_rounds(
        torch, comm, kernels, bst, dtrain, ROUNDS)
    P = DIST_PARAMS
    kernel_fn = cuda_hist.level_histogram
    captured = []

    def capture(bins, gh, pos, n_node, n_bin, mode):
        captured.append((bins, gh.clone(), pos.clone(), n_node, n_bin,
                         mode))
        return kernel_fn(bins, gh, pos, n_node, n_bin, mode)
    cuda_hist.level_histogram = capture
    try:
        b1 = xt.train(P, dtrain, 1)
    finally:
        cuda_hist.level_histogram = kernel_fn
    bins_all = torch.cat(mesh.all_gather(captured[0][0]))
    levels = []
    for bins, gh, pos, M, nb, mode in captured:
        got = kernel_fn(bins, gh, pos, M, nb, mode)
        want = cuda_hist.level_histogram_plain(bins, gh, pos, M, nb, mode)
        red = mesh.sum(got)
        all_gh = torch.cat(mesh.all_gather(gh))
        all_pos = torch.cat(mesh.all_gather(pos))
        want_all = cuda_hist.level_histogram_plain(bins_all, all_gh,
                                                   all_pos, M, nb, mode)
        levels.append([int(bins.shape[0]), M, mode,
                       bool(torch.equal(got, want)),
                       bool(torch.equal(red, want_all))])
    res["levels"] = levels
    # one refresh pass of b1's tree: each K2 call on this rank's
    # block against its rows' f64 sums, and the sums over the ranks
    # against all rows' f64 sums, each node within K2's own bound; a
    # planted fault (16 rows of the fullest node dropped) must fail
    # the same gate
    k2_fn = cuda_node_stats.node_stats
    calls = []

    def capture2(gh, pos, n_node):
        calls.append((gh.clone(), pos.clone(), n_node))
        return k2_fn(gh, pos, n_node)
    b1.set_param({"updater": "refresh"})
    cuda_node_stats.node_stats = capture2
    cuda_node_stats.reset_launches()
    try:
        b1.update(dtrain, 1)
    finally:
        cuda_node_stats.node_stats = k2_fn
    res["k2_launches"] = cuda_node_stats.launches
    k2 = []
    for gh, pos, M in calls:
        got = k2_fn(gh, pos, M)
        exact = node_sums_f64(torch, gh, pos, M)
        bound = k2_bound(torch, gh, pos, M)
        all_gh = torch.cat(mesh.all_gather(gh), dim=1)
        all_pos = torch.cat(mesh.all_gather(pos), dim=1)
        red = mesh.sum(got)
        exact_all = node_sums_f64(torch, all_gh, all_pos, M)
        bound_all = k2_bound(torch, all_gh, all_pos, M, gh.shape[1],
                             mesh.world - 1)
        count = torch.bincount(pos[(pos >= 0) & (pos < M)].long(),
                               minlength=M)
        rows = (pos == int(count.argmax())).nonzero()[:16]
        bad_pos = pos.clone()
        bad_pos[rows[:, 0], rows[:, 1]] = -1
        bad = k2_fn(gh, bad_pos, M)
        k2.append([M, ratio(got, exact, bound),
                   ratio(red, exact_all, bound_all),
                   ratio(bad, exact, bound),
                   float((got.double() - exact).abs().max()),
                   float((red.double() - exact_all).abs().max())])
    res["k2"] = k2
    # gate (b): the device sketch's cuts on this rank
    from xgboost_tpu_torch.parallel.sketch_device import sketch_cuts_mesh
    cuts = sketch_cuts_mesh(mesh, dtrain.to_dense(), None, PARAMS[
        "max_bin"])
    res["sketch_sha"] = hashlib.sha256(
        cuts.cut_values.tobytes() + cuts.n_cuts.tobytes()).hexdigest()
    # a 6-class round through K3
    Xm, ym = make_multiclass(DIST_MC_N)
    cuda_hist_batched.reset_launches()
    bm = xt.train({**MC_PARAMS, "dsplit": "row", "device_sketch": 0},
                  xt.DMatrix(Xm, label=ym), 1)
    res["k3_launches"] = cuda_hist_batched.launches
    res["k3_sha"] = hashlib.sha256(bm.save_raw()).hexdigest()
    del bm
    dist_col_checks(torch, xt, kernels, dtrain, res)
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    mesh.barrier()


def k2_bound(torch, gh, pos, n_node, block_rows=None, after=0):
    """K2's own error bound on each node and channel, gamma_L sum|x| over
    the node's rows (u = 2^-24, gamma_L = L u / (1 - L u)): in the
    kernel's fixed order (csrc/node_stats.cu) a term passes at most L f32
    additions, its thread's rows, five warp shuffles, the block's warps
    and the cluster's blocks, plus ``after`` more (the ranks' rank-order
    sum of blocks of ``block_rows`` rows); the f64 reference's own error,
    n 2^-53 sum|x|, is added."""
    from xgboost_tpu_torch.ops.cuda_node_stats import node_stats_plan
    n = gh.shape[1]
    p = node_stats_plan(block_rows or n, gh.shape[0], n_node)
    L = (-(-p.rows_per_block // p.threads) + 5 + p.threads // 32 - 1
         + p.cluster - 1 + after)
    gamma = L * 2.0 ** -24 / (1 - L * 2.0 ** -24) + n * 2.0 ** -53
    return gamma * node_sums_f64(torch, gh.abs(), pos, n_node)


def ratio(got, exact, bound):
    """max |got - exact| / bound: at most 1 passes K2's gate."""
    return float(((got.double() - exact).abs() / bound.clamp_min(
        1e-300)).max())


def node_sums_f64(torch, gh, pos, n_node):
    """K2's function in f64 (a reference for both f32 orders)."""
    T = gh.shape[0]
    slot = torch.where(pos < 0, n_node, pos).to(torch.int64)
    idx = slot + (n_node + 1) * torch.arange(
        T, dtype=torch.int64, device=gh.device)[:, None]
    out = torch.zeros((T * (n_node + 1), 2), dtype=torch.float64,
                      device=gh.device)
    out.index_add_(0, idx.reshape(-1), gh.double().reshape(-1, 2))
    return out.reshape(T, n_node + 1, 2)[:, :n_node]


def read_ranks(d, world):
    out = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_dist(torch, xt, kernels, card, main_out):
    """Row-split training on the card (gates a-f of the module
    docstring): W ranks over gloo through the port's launcher."""
    import hashlib
    import shutil

    from xgboost_tpu_torch.binning import pack_cuts
    from xgboost_tpu_torch.parallel.mesh import DataMesh
    from xgboost_tpu_torch.parallel import sketch_device as tsd
    cli_root = os.path.join(HERE, ".smoke_out", "cli")
    train_buf = os.path.join(cli_root, "higgs-train.buffer")
    test_buf = os.path.join(cli_root, "higgs-test.buffer")
    text = os.path.join(cli_root, "higgs-test.libsvm")
    root = os.path.join(HERE, ".smoke_out", "dist")
    shutil.rmtree(root, ignore_errors=True)
    conf = write_conf(
        os.path.join(HERE, ".smoke_out", "dist.conf"), task="train",
        objective="binary:logistic", max_depth=DEPTH, eta=0.1, max_bin=64,
        num_round=ROUNDS, data=train_buf, **{"eval[test]": test_buf},
        eval_metric="auc", silent=0, model_out="final.model")
    cli = [sys.executable, "-m", "xgboost_tpu_torch", conf]
    want_line = f"[{ROUNDS - 1}]\ttest-auc:{main_out['auc']:.6f}"
    dirs = {}

    def start(name, world, cmd, limit=DIST_LIMIT_S):
        d = dirs[name] = os.path.join(root, name)
        os.makedirs(d)
        return dist_launch(world, cmd, d, limit)

    # (a) W = 2 and 4 with the host sketch on every rank, (b) the
    # default device sketch, (d) the split load of libsvm text against
    # its replicated load: started at once (their times are not (e)'s)
    procs = {f"cli{w}": start(f"cli{w}", w, cli + ["device_sketch=0"])
             for w in DIST_WORLDS}
    procs.update({
        "col2": start("col2", 2, cli + ["dsplit=col"]),
        "sketch": start("sketch", 2, cli),
        "split": start("split", 2, cli + [f"data={text}",
                                          "device_sketch=1"]),
        "replicated": start("replicated", 2, cli + [
            f"data={text}", "device_sketch=1", "shard_load=0"]),
    })
    outs = dist_wait(procs)
    for world in DIST_WORLDS:
        name = f"cli{world}"
        lines = dist_eval_lines(outs[name][1])
        b = xt.Booster(model_file=os.path.join(dirs[name], "final.model"))
        if not same_trees(b.gbtree.get_state(), main_out["state"]):
            fail(f"[dist] W={world}: the model differs from [main]'s (tree "
                 "arrays, cuts)")
        if len(lines) != ROUNDS or lines[-1] != want_line:
            fail(f"[dist] W={world}: {len(lines)} eval lines, last "
                 f"{lines[-1:]}: want {want_line!r}")
        print(f"[dist] (a) W={world}: launch -n {world} python -m "
              f"xgboost_tpu_torch dist.conf device_sketch=0: "
              f"{outs[name][2]:.1f} s, beside the other launches (start, "
              f"buffer load, host sketch, binning, {ROUNDS} rounds); model "
              f"== [main]'s, bitwise (tree arrays, cuts); last eval line "
              f"{lines[-1]!r} == [main]'s", flush=True)
    # (c) and (e) at W = 2: the checks worker, alone on the card
    procs = {"check": start("check", 2, [
        sys.executable, os.path.join(HERE, "chip_smoke.py"),
        "--dist-worker", ""], DIST_CHECK_LIMIT_S)}
    outs.update(dist_wait(procs))
    # (b): the cuts of the CLI run against the device sketch on the CPU
    # over the same two blocks
    X = main_out["X"][:N_TRAIN]
    K = tsd.sketch_size(64, 0.03, 2.0)
    parts = []
    for r in range(2):
        start_r, stop_r, _ = DataMesh(r, 2, "cpu").block(N_TRAIN)
        blk = torch.from_numpy(np.ascontiguousarray(X[start_r:stop_r].T))
        parts.append(tsd.local_summary(blk, torch.ones(stop_r - start_r), K))
    cpu_cuts = tsd.propose_cuts_dev(tsd.fold_summaries(parts, K), 63).numpy()
    cpu_cuts = pack_cuts([c[np.isfinite(c)] for c in cpu_cuts])
    b = xt.Booster(model_file=os.path.join(dirs["sketch"], "final.model"))
    if not (np.array_equal(b.gbtree.cuts.cut_values, cpu_cuts.cut_values)
            and np.array_equal(b.gbtree.cuts.n_cuts, cpu_cuts.n_cuts)):
        fail("[dist] (b): the device sketch's cuts differ from the same "
             "sketch on the CPU over the same blocks")
    ranks = read_ranks(dirs["check"], 2)
    sha = hashlib.sha256(cpu_cuts.cut_values.tobytes()
                         + cpu_cuts.n_cuts.tobytes()).hexdigest()
    if any(r["sketch_sha"] != sha for r in ranks):
        fail("[dist] (b): a rank's device-sketch cuts differ")
    lines = dist_eval_lines(outs["sketch"][1])
    auc_b = float(lines[-1].rpartition(":")[2])
    print(f"[dist] (b) W=2, the default device sketch: {outs['sketch'][2]:.1f}"
          f" s; cuts == the device sketch on the CPU over the same blocks, "
          f"== on every rank; holdout AUC {auc_b:.6f} (floor {AUC_FLOOR})",
          flush=True)
    if not auc_b >= AUC_FLOOR:
        fail(f"[dist] (b): holdout AUC {auc_b} < {AUC_FLOOR}")
    # (d)
    bs, br = (xt.Booster(model_file=os.path.join(dirs[n], "final.model"))
              for n in ("split", "replicated"))
    if not same_trees(bs.gbtree.get_state(), br.gbtree.get_state()):
        fail("[dist] (d): the split-loaded model differs from the "
             "replicated load's")
    if dist_eval_lines(outs["split"][1]) != dist_eval_lines(
            outs["replicated"][1]):
        fail("[dist] (d): split-loaded eval lines differ")
    print(f"[dist] (d) W=2 on {N_TEST} rows of libsvm text: shard_load=1 "
          f"(each rank parses its block) == the replicated load with "
          f"device_sketch=1, bitwise; {outs['split'][2]:.1f} s and "
          f"{outs['replicated'][2]:.1f} s", flush=True)
    # (c)
    for r in ranks:
        bad = [lv for lv in r["levels"] if not (lv[3] and lv[4])]
        if len(r["levels"]) != DEPTH or bad:
            fail(f"[dist] (c) rank {r['rank']}: levels {r['levels']}")
        if r["k2_launches"] != len(r["k2"]) or not all(c[1] <= 1 and c[2] <= 1 < c[3]
                                  for c in r["k2"]):
            fail(f"[dist] (c) rank {r['rank']}: refresh K2 [nodes, block "
                 f"err / bound, reduced err / bound, planted fault err / "
                 f"bound, ...] {r['k2']}")
    mc = xt.train({**MC_PARAMS, "dsplit": "row", "device_sketch": 0},
                  xt.DMatrix(*make_multiclass(DIST_MC_N)), 1)
    mc_sha = hashlib.sha256(mc.save_raw()).hexdigest()
    if any(r["k3_sha"] != mc_sha or r["k3_launches"] != DEPTH
           for r in ranks):
        fail("[dist] (c): the 6-class round at W=2 differs from W=1 or "
             f"launched K3 {[r['k3_launches'] for r in ranks]} times")
    k2_err = max(max(c[4], c[5]) for r in ranks for c in r["k2"])
    k2_ratio = [max(c[i] for r in ranks for c in r["k2"]) for i in (1, 2)]
    k2_fault = min(c[3] for r in ranks for c in r["k2"])
    print(f"[dist] (c) W=2 round 0 on the card: K1 on each rank's block of "
          f"{ranks[0]['levels'][0][0]} rows == plain, int8 bitwise, at all "
          f"{DEPTH} levels; each reduced level == the plain histogram of all "
          f"{N_TRAIN} rows, bitwise; a refresh pass's {ranks[0]['k2_launches']} "
          f"K2 launches a rank, each node within K2's bound gamma_L "
          f"sum_node|x| of its f64 sums: a block's at most "
          f"{k2_ratio[0]:.4g} of the bound, the reduced sums of all rows "
          f"{k2_ratio[1]:.4g} (max |K2 - f64| {k2_err:.4g}); a planted "
          f"fault (16 rows of the fullest node dropped) reads at least "
          f"{k2_fault:.4g} of it and fails; 6-class round ({DIST_MC_N} x 28, K3 "
          f"{DEPTH} launches a rank) byte-equal to W=1", flush=True)
    col = dist_col_gates(xt, kernels, card, main_out, outs, dirs, ranks,
                         want_line)
    # (e): ms per round at W = 1 (this process: a world of one) and 2
    # (the checks worker), collectives, each rank's launches
    from xgboost_tpu_torch.obs import comm
    dtrain = xt.DMatrix(train_buf)
    b1 = xt.Booster(DIST_PARAMS, cache=[dtrain])
    b1.update(dtrain, 0)
    ms, counts, per_round = timed_rounds(torch, comm, kernels, b1, dtrain,
                                         ROUNDS)
    timing = {1: [{"rank": 0, "ms_round": ms, "counts": counts,
                   "comm": per_round}], 2: ranks}
    del dtrain, b1
    want_k1 = (ROUNDS - 1) * DEPTH
    for world, rs in sorted(timing.items()):
        for r in rs:
            want = dict(only(kernels, hist_level=want_k1)) if world == 1 \
                else {"hist_level": want_k1, "hist_batched": 0,
                      "node_stats": 0}
            if r["counts"] != want:
                fail(f"[dist] (e) W={world} rank {r['rank']}: counts "
                     f"{r['counts']}: want {want}")
        c = rs[0]["comm"]
        print(f"[dist] (e) W={world}: {max(r['ms_round'] for r in rs):.3f} "
              f"ms per round (slowest rank; rounds 1-{ROUNDS - 1}, host "
              f"clock to synchronize); per round: allreduce "
              f"{c['allreduce']['count']:.1f} calls, "
              f"{c['allreduce']['bytes'] / 2 ** 20:.3f} MiB, "
              f"{c['allreduce']['seconds'] * 1e3:.3f} ms; allgather "
              f"{c['allgather']['count']:.1f} calls, "
              f"{c['allgather']['bytes'] / 2 ** 20:.3f} MiB, "
              f"{c['allgather']['seconds'] * 1e3:.3f} ms; each rank's "
              f"launches {[r['counts'] for r in rs]} | {card}", flush=True)
    # the ranks' launches on [dist]'s counted paths: the timed rounds
    # (K1), the refresh pass (K2) and the 6-class round (K3) of W=2
    return {"hist_level": sum(r["counts"]["hist_level"] for r in ranks)
            + col["hist_level"],
            "hist_batched": sum(r["k3_launches"] for r in ranks),
            "node_stats": sum(r["k2_launches"] for r in ranks)
            + col["node_stats"],
            "node_stats_err": max(k2_err, col["node_stats_err"])}


def comm_text(c):
    """A round's collectives, from ``obs/comm.py`` totals' deltas."""
    return "; ".join(
        f"{op} {c[op]['count']:.1f} calls, {c[op]['bytes'] / 2 ** 10:.1f} "
        f"KiB, {c[op]['seconds'] * 1e3:.3f} ms" for op in sorted(c))


def dist_col_gates(xt, kernels, card, main_out, outs, dirs, ranks,
                   want_line):
    """Gates g-i of [dist] on the launches' outputs and the checks
    worker's ranks; the same runs at W = 1 in this process.  Returns the
    K1 and K2 launches of the counted paths (the timed column-split
    rounds, the exact trees, the rank rounds) and K2's largest error."""
    # (g) the CLI by features, and the worker's timed rounds
    lines = dist_eval_lines(outs["col2"][1])
    b = xt.Booster(model_file=os.path.join(dirs["col2"], "final.model"))
    if not same_trees(b.gbtree.get_state(), main_out["state"]):
        fail("[dist] (g): the dsplit=col model differs from [main]'s (tree "
             "arrays, cuts)")
    if len(lines) != ROUNDS or lines[-1] != want_line:
        fail(f"[dist] (g): {len(lines)} eval lines, last {lines[-1:]}: "
             f"want {want_line!r}")
    want_k1 = (ROUNDS - 1) * DEPTH
    sha = state_sha(main_out["state"])
    for r in ranks:
        if len(r["col_levels"]) != DEPTH or not all(
                lv[2] for lv in r["col_levels"]):
            fail(f"[dist] (g) rank {r['rank']}: K1 on the block [features, "
                 f"nodes, == plain] {r['col_levels']}")
        if r["col_sha"] != sha:
            fail(f"[dist] (g) rank {r['rank']}: the worker's dsplit=col "
                 "model differs from [main]'s")
        if r["col_counts"] != {"hist_level": want_k1, "hist_batched": 0,
                               "node_stats": 0}:
            fail(f"[dist] (g) rank {r['rank']}: counts {r['col_counts']}")
    print(f"[dist] (g) W=2 dsplit=col: launch -n 2 python -m "
          f"xgboost_tpu_torch dist.conf dsplit=col {outs['col2'][2]:.1f} s "
          f"(beside (a), (b), (d)); model == [main]'s, bitwise (tree "
          f"arrays, cuts); last eval line {lines[-1]!r} == [main]'s; "
          f"worker: K1 on each rank's {ranks[0]['col_levels'][0][0]} "
          f"features == plain at all {DEPTH} levels, int8 bitwise; "
          f"{max(r['col_ms'] for r in ranks):.3f} ms per round (slowest "
          f"rank, rounds 1-{ROUNDS - 1}), K1 {want_k1} launches a rank, a "
          f"round: {comm_text(ranks[0]['col_comm'])} | {card}", flush=True)
    # (h) exact column split against a world of one
    X, y = main_out["X"], main_out["y"]
    bx = xt.train(DIST_EXACT_PARAMS, xt.DMatrix(X[:DIST_EXACT_N],
                                                label=y[:DIST_EXACT_N]),
                  DIST_EXACT_ROUNDS)
    k2_want = DIST_EXACT_ROUNDS * (DEPTH + 1)
    for r in ranks:
        if r["exact_sha"] != hashlib_sha(bx.save_raw()):
            fail(f"[dist] (h) rank {r['rank']}: the exact dsplit=col model "
                 "differs from W=1's")
        if r["exact_counts"] != {"hist_level": 0, "hist_batched": 0,
                                 "node_stats": k2_want} or len(
                r["exact_k2"]) != k2_want:
            fail(f"[dist] (h) rank {r['rank']}: counts {r['exact_counts']}, "
                 f"{len(r['exact_k2'])} K2 calls")
        if not all(c[1] <= 1 for c in r["exact_k2"]):
            fail(f"[dist] (h) rank {r['rank']}: K2 [nodes, err / bound, "
                 f"max |err|] {r['exact_k2']}")
    k2_ratio = max(c[1] for r in ranks for c in r["exact_k2"])
    k2_err = max(c[2] for r in ranks for c in r["exact_k2"])
    print(f"[dist] (h) W=2 exact grow_colmaker dsplit=col on {DIST_EXACT_N} "
          f"of [main]'s rows, {DIST_EXACT_ROUNDS} rounds: model == W=1's, "
          f"byte for byte; {max(r['exact_s'] for r in ranks):.1f} s (rank "
          f"build included); K2 {k2_want} launches a rank, each node within "
          f"K2's bound of its f64 sums (at most {k2_ratio:.4g} of it, max "
          f"|K2 - f64| {k2_err:.4g}); a round: "
          f"{comm_text(ranks[0]['exact_comm'])} | {card}", flush=True)
    # (i) rank:ndcg under row split against a world of one
    br = xt.train(DIST_RANK_PARAMS, rank_dmatrix(xt, *make_rank(
        DIST_RANK_N)), DIST_RANK_ROUNDS)
    k1_rank = DIST_RANK_ROUNDS * DEPTH
    for r in ranks:
        if r["rank_sha"] != hashlib_sha(br.save_raw()):
            fail(f"[dist] (i) rank {r['rank']}: the rank:ndcg dsplit=row "
                 "model differs from W=1's")
        if r["rank_counts"] != {"hist_level": k1_rank, "hist_batched": 0,
                                "node_stats": 0}:
            fail(f"[dist] (i) rank {r['rank']}: counts {r['rank_counts']}")
    print(f"[dist] (i) W=2 rank:ndcg dsplit=row on {DIST_RANK_N} rows in "
          f"{DIST_RANK_N // RANK_GSIZE} groups, {DIST_RANK_ROUNDS} rounds: "
          f"model == W=1's, byte for byte; "
          f"{max(r['rank_s'] for r in ranks):.1f} s; K1 {k1_rank} launches "
          f"a rank; a round: {comm_text(ranks[0]['rank_comm'])} | {card}",
          flush=True)
    return {"hist_level": sum(r["col_counts"]["hist_level"]
                              + r["rank_counts"]["hist_level"]
                              for r in ranks),
            "node_stats": sum(r["exact_counts"]["node_stats"]
                              for r in ranks),
            "node_stats_err": k2_err}


def phase_multiclass(torch, xt, kernels, device, card):
    """``bench_multiclass`` at full width, all 60 rounds, through K3."""
    from xgboost_tpu_torch.metrics import merror
    from xgboost_tpu_torch.ops import cuda_hist
    kb = kernels["hist_batched"]

    t0 = time.perf_counter()
    X, y = make_multiclass(MC_N + MC_TEST)
    dtrain = xt.DMatrix(X[:MC_N], label=y[:MC_N])
    dtest = xt.DMatrix(X[MC_N:], label=y[MC_N:])
    print(f"[multiclass] data {MC_N} + {MC_TEST} x {MC_FEAT}, {MC_K} "
          f"classes: {time.perf_counter() - t0:.2f} s", flush=True)

    reset_counts(kernels)
    t0 = time.perf_counter()
    bst = xt.train(MC_PARAMS, dtrain, MC_ROUNDS, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    launches = counts["hist_batched"]
    want = MC_ROUNDS * DEPTH
    print(f"[multiclass] train {MC_ROUNDS} rounds (cuts and binning "
          f"included): {train_s:.2f} s; hist_batched launches {launches}; "
          f"all counts {json.dumps(counts)}", flush=True)
    if counts != only(kernels, hist_batched=want):
        fail(f"launch counts {counts}: want hist_batched {want} "
             f"({MC_ROUNDS} rounds x {DEPTH} levels), the others 0")
    if bst.gbtree.num_trees != MC_ROUNDS * MC_K:
        fail(f"{bst.gbtree.num_trees} trees, want {MC_ROUNDS * MC_K}")

    pred = bst.predict(dtest)
    if pred.shape != (MC_TEST,) or not np.isfinite(pred).all():
        fail(f"holdout class predictions: shape {pred.shape}")
    margin = bst.predict(dtest, output_margin=True)
    if margin.shape != (MC_TEST, MC_K) or not np.isfinite(margin).all():
        fail(f"holdout margins: shape {margin.shape}")
    onehot = np.eye(MC_K, dtype=np.float32)[pred.astype(np.int64)]
    err = merror(onehot, y[MC_N:], np.ones(MC_TEST, np.float32))
    print(f"[multiclass] holdout merror {err:.6f} (floor {MERROR_FLOOR}; "
          "the JAX package 0.1827)", flush=True)
    if not err <= MERROR_FLOOR:
        fail(f"holdout merror {err} > {MERROR_FLOOR}")
    raw = bst.save_raw()

    # ms per round: a second booster, round 0 (cuts, binning) untimed
    bst2 = xt.Booster(MC_PARAMS, cache=[dtrain], device=device)
    bst2.update(dtrain, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst2.update_many(dtrain, 1, MC_ROUNDS - 1)
    torch.cuda.synchronize()
    ms_round = (time.perf_counter() - t0) * 1e3 / (MC_ROUNDS - 1)
    print(f"[multiclass] {ms_round:.3f} ms per round of {MC_K} trees | "
          f"{card}", flush=True)
    if bst2.save_raw() != raw:
        fail("a second int8 multiclass run gave different model bytes")

    kernel_fn = kb.level_histogram_batched
    kb.level_histogram_batched = kb.level_histogram_batched_plain
    try:
        plain = xt.train(MC_PARAMS, dtrain, MC_ROUNDS, device=device)
    finally:
        kb.level_histogram_batched = kernel_fn
    if plain.save_raw() != raw:
        fail("kernel and plain batched histograms grew different models")
    print("[multiclass] plain-histogram run: identical model bytes",
          flush=True)

    path = os.path.join(HERE, ".smoke_out", "smoke_multiclass.bin")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    bst.save_model(path)
    loaded = xt.Booster(model_file=path, device=device)
    if not (np.array_equal(loaded.predict(dtest), pred) and np.array_equal(
            loaded.predict(dtest, output_margin=True), margin)):
        fail("multiclass predictions changed over save_model / load_model")
    print("[multiclass] save/load: bitwise-equal predictions and margins",
          flush=True)
    loaded.set_param("objective", "multi:softprob")
    prob = loaded.predict(dtest)
    if prob.shape != (MC_TEST, MC_K) or not np.allclose(prob.sum(1), 1.0,
                                                        atol=1e-5) \
            or not np.array_equal(prob.argmax(1), pred.astype(np.int64)):
        fail(f"softprob output: shape {prob.shape}")
    print(f"[multiclass] softprob output shape {prob.shape}, rows sum to "
          "1, argmax == softmax classes", flush=True)

    # every level's real inputs, captured from one more round
    captured = []

    def capture(bins, gh, pos, n_node, n_bin, mode):
        captured.append((bins, gh.clone(), pos.clone(), n_node, n_bin, mode))
        return kernel_fn(bins, gh, pos, n_node, n_bin, mode)
    kb.level_histogram_batched = capture
    try:
        xt.train(MC_PARAMS, dtrain, 1, device=device)
    finally:
        kb.level_histogram_batched = kernel_fn
    max_err = 0.0
    for bins, gh, pos, M, nb, mode in captured:
        got = kernel_fn(bins, gh, pos, M, nb, mode)
        want_h = kb.level_histogram_batched_plain(bins, gh, pos, M, nb, mode)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - want_h).abs().max()))
        if mode != "int" or not torch.equal(got, want_h):
            fail(f"multiclass level n_node={M}: mode {mode}, kernel != "
                 "plain")
        for t in range(gh.shape[0]):
            solo = cuda_hist.level_histogram(bins, gh[t].contiguous(),
                                             pos[t].contiguous(), M, nb,
                                             mode)
            if not torch.equal(got[..., t * M:(t + 1) * M], solo):
                fail(f"multiclass level n_node={M}: tree {t} != solo K1")
    print(f"[multiclass] K3 == plain and each tree == solo K1, int8 "
          f"bitwise, at all {len(captured)} levels of a round", flush=True)
    return launches, ms_round, captured, max_err, err


# ---------------------------------------------------------------- [serve]
SERVE_SIZES = (1, 5, 8, 100, 1000, 8192)     # (b): request sizes, Higgs
SERVE_MC_SIZES = (1, 100, 8192)               # (b): multiclass
SERVE_REQS = 200                              # requests a size, at most
SERVE_LAT_SIZES = (1, 64, 1024, 8192)         # p50 / p99 over 200 calls
SERVE_THREADS, SERVE_THREAD_REQS = 16, 50     # (d)
SERVE_STORE_IDS = 1000                        # (f)
SERVE_PHASE_S = 90.0                          # (g)


def pct_ms(xs):
    a = np.asarray(xs) * 1e3
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def timed_calls(fn, n):
    """Wall seconds of ``n`` calls of ``fn`` (each ends on a host copy or
    a synchronize)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def serve_requests(eng, X, ref, refm, sizes, tag):
    """(b): requests of each size over the holdout, margins and
    predictions, each against ``Booster.predict``'s rows byte for byte;
    then all rows at once."""
    n_all = X.shape[0]
    done = []
    for s in sizes:
        rows = min(n_all, s * SERVE_REQS)
        for o in range(0, rows, s):
            e = min(o + s, rows)
            for want, om in ((ref, False), (refm, True)):
                got = eng.predict(X[o:e], output_margin=om)
                if got.shape != want[o:e].shape or \
                        got.tobytes() != want[o:e].tobytes():
                    fail(f"[serve] {tag}: a {e - o}-row request at row {o} "
                         f"(output_margin={om}) != Booster.predict")
        done.append(f"{s} x {-(-rows // s)}")
    for want, om in ((ref, False), (refm, True)):
        if eng.predict(X, output_margin=om).tobytes() != want.tobytes():
            fail(f"[serve] {tag}: all {n_all} rows at once "
                 f"(output_margin={om}) != Booster.predict")
    return done


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def graph_vs_eager(torch, eng, X, tag):
    """(c): each bucket's graph replay against the eager margin function
    on the same rows, byte for byte; and the eager function's and the
    replay's ms (median of 20, synchronised) at the smallest and largest
    buckets."""
    fn = eng.margin_function()
    dev = eng.device
    times = {}
    for b in eng.buckets:
        x = torch.from_numpy(np.ascontiguousarray(X[:b])).to(dev)
        base = torch.full((b, eng._K), eng._base_scalar, device=dev)
        exe = eng._executable(b)
        with exe.lock:
            exe.x.copy_(x)
            got = exe.run().clone()
            want = fn(x, base)
            if got.cpu().numpy().tobytes() != want.cpu().numpy().tobytes():
                fail(f"[serve] {tag}: bucket {b}: graph replay != the "
                     "eager margin function")
            if b in (eng.buckets[0], eng.buckets[-1]):
                def run_graph():
                    exe.run()
                    sync(torch, dev)

                def run_eager():
                    fn(x, base)
                    sync(torch, dev)
                run_eager()
                times[b] = (float(np.median(timed_calls(run_eager, 20))),
                            float(np.median(timed_calls(run_graph, 20))))
    return times


def http_call(url, body=None, timeout=60.0):
    """(status, parsed JSON or {}, raw body) of a GET (body None) or a
    POST; an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw), raw
    except ValueError:
        return status, {}, raw


def http_post(url, body, timeout=60.0):
    """The JSON answer of a POST that must succeed."""
    status, js, raw = http_call(url, body, timeout)
    if status != 200:
        raise RuntimeError(f"POST {url}: HTTP {status} {raw[:200]!r}")
    return js


def http_get(url, timeout=60.0):
    """The body of a GET that must succeed."""
    status, _, raw = http_call(url, timeout=timeout)
    if status != 200:
        raise RuntimeError(f"GET {url}: HTTP {status} {raw[:200]!r}")
    return raw


def csv_body(X):
    return "\n".join(",".join(repr(float(v)) for v in row)
                     for row in X).encode()


def phase_serve(torch, xt, kernels, card, main_hold, device="cuda"):
    """Serving on the card: the engine's CUDA graphs, the batcher, the HTTP
    server with hot reload and rollback, and the feature store, on
    [main]'s and [multiclass]'s model files; gates (a)-(g) of the module
    docstring.  No kernel of the twelve may launch."""
    import shutil
    import threading

    from xgboost_tpu_torch.obs.metrics import predict_metrics
    from xgboost_tpu_torch.profiling import ServingMetrics
    from xgboost_tpu_torch.serving import (FeatureStore, MicroBatcher,
                                           PredictEngine, predict_by_id,
                                           run_server)
    t_phase = time.perf_counter()
    out = os.path.join(HERE, ".smoke_out")
    root = os.path.join(out, "serve")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    main_path = os.path.join(root, "higgs.bin")
    mc_path = os.path.join(root, "multiclass.bin")
    shutil.copyfile(os.path.join(out, "smoke_model.bin"), main_path)
    shutil.copyfile(os.path.join(out, "smoke_multiclass.bin"), mc_path)
    v10_path = os.path.join(out, "cli", "0010.model")
    Xh = np.ascontiguousarray(main_hold)
    Xm = np.ascontiguousarray(make_multiclass(MC_N + MC_TEST)[0][MC_N:])

    reset_counts(kernels)
    bst = xt.Booster(model_file=main_path, device=device)
    mc = xt.Booster(model_file=mc_path, device=device)
    ref, refm = bst.predict(Xh), bst.predict(Xh, output_margin=True)
    mref, mrefm = mc.predict(Xm), mc.predict(Xm, output_margin=True)
    if mref.shape != (MC_TEST,) or mrefm.shape != (MC_TEST, MC_K):
        fail(f"[serve] multiclass Booster.predict shapes {mref.shape}, "
             f"{mrefm.shape}")
    # Booster.predict runs the chunked traversal here (pred_chunk 32);
    # hold it against the per-tree path (pred_chunk 0) on the same rows
    for tag, bb, X, want in (("higgs", bst, Xh, (ref, refm)),
                             ("multiclass", mc, Xm, (mref, mrefm))):
        if bb.gbtree.pred_chunk != 32:
            fail(f"[serve] {tag}: Booster pred_chunk "
                 f"{bb.gbtree.pred_chunk}, want 32 on the card")
        bb.gbtree.pred_chunk = 0
        try:
            per_tree = (bb.predict(X), bb.predict(X, output_margin=True))
        finally:
            bb.gbtree.pred_chunk = 32
        if any(p.shape != w.shape or p.tobytes() != w.tobytes()
               for p, w in zip(per_tree, want)):
            fail(f"[serve] {tag}: chunked (32) predictions or margins != "
                 "the per-tree path's (pred_chunk 0)")
    print(f"[serve] Booster.predict chunked (pred_chunk 32) == the per-tree "
          f"path (pred_chunk 0), predictions and margins byte for byte: "
          f"higgs {Xh.shape[0]} rows, multiclass {Xm.shape[0]} rows",
          flush=True)

    # (a) the default ladder 8-8192: 11 captures in warmup, none after
    engines = {}
    for tag, path, b in (("higgs", main_path, bst), ("multiclass", mc_path,
                                                     mc)):
        sync(torch, device)
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        eng = PredictEngine(path, warmup=True, device=device)
        sync(torch, device)
        warm_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        # what the engine keeps: its model, static buffers and graph pools
        reserved = torch.cuda.memory_reserved() - r0
        pools = [e.pool for e in eng._compiled.values()]
        if min(pools) <= 0:
            fail(f"[serve] {tag}: a graph's pool read {min(pools)} bytes "
                 "at capture")
        pools = sum(pools)
        d = eng.describe()
        if eng.compile_count != 11 or d["compiled"] != eng.buckets \
                or eng.buckets != [8 << i for i in range(11)] \
                or d["graphs"] != (device == "cuda"):
            fail(f"[serve] {tag}: warmup captured {eng.compile_count} "
                 f"graphs ({d}), want the 11 buckets 8-8192")
        print(f"[serve] {tag}: {d['num_trees']} trees, tree_chunk "
              f"{d['tree_chunk']} ({d['tree_chunks']} chunks), fused "
              f"{d['fused']}: warmup captured {eng.compile_count} CUDA "
              f"graphs (buckets 8-8192) in {warm_s:.2f} s; device_bytes "
              f"{eng.device_bytes() / 2 ** 20:.1f} MiB (graph pools "
              f"{pools / 2 ** 20:.1f} MiB); memory_reserved grew "
              f"{reserved / 2 ** 20:.1f} MiB over load and warmup (cache "
              f"emptied before and after)",
              flush=True)
        engines[tag] = eng
    eng, meng = engines["higgs"], engines["multiclass"]

    # (b) requests of every size, and all at once, == Booster.predict
    t0 = time.perf_counter()
    done = serve_requests(eng, Xh, ref, refm, SERVE_SIZES, "higgs")
    mdone = serve_requests(meng, Xm, mref, mrefm, SERVE_MC_SIZES,
                           "multiclass")
    print(f"[serve] (b) predictions and margins == Booster.predict byte for "
          f"byte: higgs requests (rows x count) {', '.join(done)} and all "
          f"{Xh.shape[0]} rows at once; multiclass {', '.join(mdone)} and "
          f"all {Xm.shape[0]} at once (multi:softmax shape "
          f"{meng.predict(Xm[:3]).shape}); {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (c) every graph replay == the eager margin function
    ge = {tag: graph_vs_eager(torch, e, X, tag)
          for tag, e, X in (("higgs", eng, Xh), ("multiclass", meng, Xm))}
    for tag, t in ge.items():
        print(f"[serve] (c) {tag}: each of the 11 graph replays == the "
              "eager margin function, byte for byte; margin ms (median of "
              "20, synchronised) " + "; ".join(
                  f"{b} rows eager {e * 1e3:.3f} graph {g * 1e3:.3f}"
                  for b, (e, g) in sorted(t.items())) + f" | {card}",
              flush=True)

    # latency of engine.predict (host rows in, numpy out)
    for tag, e, X in (("higgs", eng, Xh), ("multiclass", meng, Xm)):
        parts = []
        for n in SERVE_LAT_SIZES:
            xs = X[:n]
            p50, p99 = pct_ms(timed_calls(lambda: e.predict(xs), 200))
            parts.append(f"{n} rows p50 {p50:.3f} p99 {p99:.3f}")
            if n == 8192:
                rate = 8192 / (p50 / 1e3)
        print(f"[serve] {tag} engine.predict ms over 200 calls: "
              + "; ".join(parts) + f"; {rate:.4g} rows/s at 8192 | {card}",
              flush=True)
    if eng.compile_count != 11 or meng.compile_count != 11:
        fail(f"[serve] captures after warmup: {eng.compile_count}, "
             f"{meng.compile_count}")

    # (d) 16 threads x 50 requests through MicroBatcher
    metrics = ServingMetrics()
    batcher = MicroBatcher(eng.predict, max_batch_rows=1024, max_wait_ms=2,
                           max_queue_rows=1 << 16, metrics=metrics)
    bad, lock = [], threading.Lock()

    def client(seed):
        rng = np.random.RandomState(seed)
        for _ in range(SERVE_THREAD_REQS):
            n = int(rng.randint(1, 65))
            o = int(rng.randint(0, Xh.shape[0] - n))
            got = batcher.submit(Xh[o:o + n], timeout=60.0)
            if got.tobytes() != ref[o:o + n].tobytes():
                with lock:
                    bad.append((seed, o, n))
    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(i,))
          for i in range(SERVE_THREADS)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    batcher.close()
    reqs = SERVE_THREADS * SERVE_THREAD_REQS
    flushes = int(metrics.batches.value)
    if bad or any(t.is_alive() for t in ts) or not flushes < reqs \
            or metrics.requests.value != reqs:
        fail(f"[serve] (d) batcher: {len(bad)} wrong answers {bad[:3]}, "
             f"{flushes} flushes for {reqs} requests")
    print(f"[serve] (d) {SERVE_THREADS} threads x {SERVE_THREAD_REQS} "
          f"requests of 1-64 rows through MicroBatcher: each == "
          f"Booster.predict, {flushes} flushes for {reqs} requests, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # (f) the feature store: predict_by_id of 1,000 ids == predict
    store = FeatureStore(eng.num_feature, budget_mb=64.0, device=device)
    ids = [f"e{i}" for i in range(SERVE_STORE_IDS)]
    store.put(ids, Xh[:SERVE_STORE_IDS])
    b0 = predict_metrics().transfer_bytes.value
    got = predict_by_id(eng, store, ids)
    moved = predict_metrics().transfer_bytes.value - b0
    if got.tobytes() != ref[:SERVE_STORE_IDS].tobytes() or moved != 0:
        fail(f"[serve] (f) predict_by_id != predict, or {moved} feature "
             "bytes uploaded")
    p50, p99 = pct_ms(timed_calls(lambda: predict_by_id(eng, store,
                                                        ids[:64]), 200))
    print(f"[serve] (f) predict_by_id of {SERVE_STORE_IDS} resident ids == "
          f"predict of their rows, 0 feature bytes uploaded; 64 ids p50 "
          f"{p50:.3f} p99 {p99:.3f} ms | {card}", flush=True)

    # (e) the HTTP server: predict, healthz, metrics, reload, rollback
    srv = run_server(main_path, port=0, poll_sec=0.2, max_wait_ms=1,
                     quiet=True, block=False, device=device)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        body = csv_body(Xh[:1000])
        resp = http_post(base + "/predict", body)
        got = np.asarray(resp["predictions"], np.float32)
        if got.tobytes() != ref[:1000].tobytes() or resp["rows"] != 1000 \
                or resp["model_version"] != 1:
            fail(f"[serve] (e) /predict of 1,000 CSV rows != "
                 f"Booster.predict (rows {resp['rows']}, model_version "
                 f"{resp['model_version']})")
        h = json.loads(http_get(base + "/healthz"))
        mtext = http_get(base + "/metrics").decode()
        names = ("xgbtpu_serving_requests_total", "xgbtpu_serving_rows_total",
                 "xgbtpu_serving_padded_rows_total",
                 "xgbtpu_serving_batches_total",
                 "xgbtpu_serving_compiles_total",
                 "xgbtpu_serving_latency_p99_seconds",
                 "xgbtpu_predict_transfer_bytes_total")
        missing = [m for m in names if m not in mtext]
        if h.get("status") != "ok" or h.get("buckets_compiled") != 11 \
                or missing:
            fail(f"[serve] (e) /healthz {h} or /metrics missing {missing}")
        one = csv_body(Xh[:1])
        lat1 = timed_calls(lambda: http_post(base + "/predict", one), 200)
        lat1k = timed_calls(lambda: http_post(base + "/predict", body), 50)
        # overwrite the watched file with the CLI phase's 0010.model while
        # a client keeps asking: the poll thread captures the new graphs
        # while the batcher replays the old ones
        v10 = xt.Booster(model_file=v10_path, device=device)
        ref10 = v10.predict(Xh[:1000])
        stop, errs = threading.Event(), []

        def hammer():
            while not stop.is_set():
                try:
                    r = http_post(base + "/predict", one)
                    p = np.asarray(r["predictions"], np.float32)
                    if p.tobytes() not in (ref[:1].tobytes(),
                                           ref10[:1].tobytes()):
                        errs.append(r)
                except Exception as e:  # noqa: BLE001 -- failed below
                    errs.append(e)
        th = threading.Thread(target=hammer)
        th.start()
        t0 = time.perf_counter()
        shutil.copyfile(v10_path, main_path + ".tmp")
        os.replace(main_path + ".tmp", main_path)
        while json.loads(http_get(base + "/healthz"))["model_version"] != 2:
            if time.perf_counter() - t0 > 60:
                stop.set()
                fail("[serve] (e) model_version did not move within 60 s "
                     "of overwriting the model file")
            time.sleep(0.05)
        reload_s = time.perf_counter() - t0
        stop.set()
        th.join(60)
        resp = http_post(base + "/predict", body)
        if errs or np.asarray(resp["predictions"], np.float32).tobytes() \
                != ref10.tobytes() or resp["model_version"] != 2:
            fail(f"[serve] (e) after the reload: {len(errs)} bad answers "
                 f"({errs[:2]}) or predictions != 0010.model's")
        rb = http_post(base + "/-/rollback", b"")
        resp = http_post(base + "/predict", body)
        if not rb["rolled_back"] or np.asarray(
                resp["predictions"], np.float32).tobytes() \
                != ref[:1000].tobytes():
            fail(f"[serve] (e) rollback {rb}: predictions != the first "
                 "model's")
        a, b = pct_ms(lat1), pct_ms(lat1k)
        print(f"[serve] (e) HTTP on port {srv.port}: 1,000-row CSV "
              f"/predict == Booster.predict; /healthz ok, /metrics holds "
              f"the serve counters; overwrite with 0010.model -> "
              f"model_version 2 in {reload_s:.2f} s (reload captured under "
              f"traffic), predictions == 0010.model's; rollback -> "
              f"model_version {rb['model_version']}, the first model's "
              f"predictions; round trip ms p50 / p99: 1 row {a[0]:.3f} / "
              f"{a[1]:.3f} (200 calls), 1,000 rows {b[0]:.3f} / {b[1]:.3f} "
              f"(50 calls) | {card}", flush=True)
    finally:
        srv.shutdown()

    counts = read_counts(kernels)
    if counts != only(kernels):
        fail(f"[serve] launch counts {counts}: serving runs none of the "
             "twelve kernels")
    secs = time.perf_counter() - t_phase
    print(f"[serve] all counts {json.dumps(counts)}; phase {secs:.1f} s "
          f"(limit {SERVE_PHASE_S:.0f})", flush=True)
    if secs > SERVE_PHASE_S:
        fail(f"[serve] phase took {secs:.1f} s > {SERVE_PHASE_S} s")
    engine_bytes = {tag: e.device_bytes() for tag, e in engines.items()}
    for e in engines.values():
        e.release()
    return engine_bytes



# ---------------------------------------------------------------- [fleet]
FLEET_LEASE_S, FLEET_HC_S = 3.0, 0.5       # router lease and health pass
FLEET_ROTATION_S = 10.0                    # (a)
FLEET_SIZES = (1, 64, 1000)                # (b)
FLEET_IDS = 1000                           # (c)
FLEET_CAND_N, FLEET_CAND_ROUNDS = 200_000, 10   # (d)
# (e): the router sends a request to the least-loaded replica, ties to
# r0, so r1 sees traffic only while r0 is busy: 16 threads keep enough
# requests in flight that r1 is dispatched to between its kill and its
# ejection (8 threads once left that window without one, and so with no
# retry to count)
FLEET_KILL_THREADS, FLEET_KILL_REQS = 16, 400
FLEET_READMIT_S = 15.0   # (e): the longest wait for r1's readmission
FLEET_SHED_INFLIGHT, FLEET_SHED_S, FLEET_SHED_REQS = 2, 0.2, 16   # (f)
FLEET_PHASE_S = 120.0


def start_router(*params):
    """``python -m xgboost_tpu_torch task=fleet_router fleet_port=0`` as a
    subprocess: (process, base URL read from its banner, its stderr
    lines)."""
    import threading
    proc = start_child(
        [sys.executable, "-m", "xgboost_tpu_torch", "task=fleet_router",
         "fleet_port=0", f"fleet_lease_sec={FLEET_LEASE_S}",
         f"fleet_hc_sec={FLEET_HC_S}", *params],
        cwd=HERE, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    lines = []

    def drain():
        for line in proc.stderr:
            lines.append(line.rstrip())
    threading.Thread(target=drain, daemon=True).start()
    return proc, lines


def router_url(proc, lines, timeout=90.0):
    import re
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        for line in lines:
            m = re.search(r"router on (http://[0-9.]+:\d+)", line)
            if m:
                return m.group(1)
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    fail(f"[fleet] the router did not start: rc {proc.poll()}, stderr "
         f"{lines[-5:]}")


def kill_now(srv, killed):
    """The ``replica_kill`` fault's ``on_kill``: stop the server with no
    drain and no deregistration (the router must notice by itself), and
    never leave the process."""
    killed.setdefault("t", time.perf_counter())
    srv.lease_client = None
    srv.shutdown()


def members(base):
    return http_call(base + "/fleet/members")[1]


def wait_rotation(base, want, timeout):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        m = members(base)
        ids = sorted(r["replica_id"] for r in m["replicas"]
                     if r["in_rotation"])
        if ids == want:
            return time.perf_counter() - t0
        time.sleep(0.05)
    fail(f"[fleet] rotation {ids} != {want} within {timeout} s")


def phase_fleet(torch, xt, kernels, card, main_hold, fleet_train,
                engine_bytes, device="cuda"):
    """The fleet on the card: a router subprocess over two replicas of
    [main]'s model in this process (``run_server(..., router_url=)``);
    gates (a)-(g) of the module docstring.  Only the candidate's
    training launches a kernel (K1)."""
    import hashlib
    import shutil
    import threading

    from xgboost_tpu_torch.fleet import HashRing, scrape_samples
    from xgboost_tpu_torch.placer import run_placer
    from xgboost_tpu_torch.reliability import faults
    from xgboost_tpu_torch.serving import run_server
    t_phase = time.perf_counter()
    out = os.path.join(HERE, ".smoke_out")
    root = os.path.join(out, "fleet")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    first = os.path.join(out, "smoke_model.bin")
    paths = {}
    for rid in ("r0", "r1", "r-shed"):
        paths[rid] = os.path.join(root, f"{rid}.bin")
        shutil.copyfile(first, paths[rid])
    tenants = {"higgs": os.path.join(root, "tenant-higgs.bin"),
               "multiclass": os.path.join(root, "tenant-multiclass.bin")}
    shutil.copyfile(first, tenants["higgs"])
    shutil.copyfile(os.path.join(out, "smoke_multiclass.bin"),
                    tenants["multiclass"])
    # each replica's catalog holds its default model and one tenant, in
    # the bytes [serve] measured on this card (graph pools included)
    eh, em = engine_bytes["higgs"], engine_bytes["multiclass"]
    budget = eh + max(eh, em) + min(eh, em) // 2
    catalog_mb = budget / 1e6
    Xh = np.ascontiguousarray(main_hold)
    Xm = np.ascontiguousarray(make_multiclass(MC_N + MC_TEST)[0][MC_N:])

    procs, servers = [], []
    reset_counts(kernels)
    try:
        procs.append(start_router())
        procs.append(start_router(f"fleet_inflight={FLEET_SHED_INFLIGHT}"))
        # (d)'s candidate: 10 rounds on [main]'s first 200,000 rows, K1 only
        t0 = time.perf_counter()
        Xc, yc = fleet_train
        cand = xt.train(PARAMS, xt.DMatrix(Xc, label=yc), FLEET_CAND_ROUNDS,
                        device=device)
        torch.cuda.synchronize()
        counts = read_counts(kernels)
        if counts != only(kernels, hist_level=FLEET_CAND_ROUNDS * DEPTH):
            fail(f"[fleet] candidate launch counts {counts}: want "
                 f"hist_level {FLEET_CAND_ROUNDS * DEPTH}, the others 0")
        cand_path = os.path.join(root, "candidate.bin")
        cand.save_model(cand_path)
        print(f"[fleet] candidate: {FLEET_CAND_ROUNDS} rounds on "
              f"{FLEET_CAND_N} rows in {time.perf_counter() - t0:.2f} s, "
              f"hist_level launches {counts['hist_level']}", flush=True)
        bst = xt.Booster(model_file=first, device=device)
        mc = xt.Booster(model_file=tenants["multiclass"], device=device)
        ref = bst.predict(Xh[:FLEET_IDS])
        cref = cand.predict(Xh[:FLEET_IDS])
        mref = mc.predict(Xm[:100])
        base = router_url(*procs[0])
        shed_base = router_url(*procs[1])

        killed = {}

        def replica(rid, url):
            srv = run_server(paths[rid], port=0, poll_sec=0, max_wait_ms=1,
                             featurestore_mb=64.0, catalog_mb=catalog_mb,
                             quiet=True, block=False, device=device,
                             router_url=url, replica_id=rid)
            srv.lease_client.on_kill = lambda: kill_now(srv, killed)
            servers.append(srv)
            return srv

        # (a) both replicas in rotation within 10 s
        t0 = time.perf_counter()
        r0, r1 = replica("r0", base), replica("r1", base)
        rot_s = wait_rotation(base, ["r0", "r1"], max(
            0.1, FLEET_ROTATION_S - (time.perf_counter() - t0)))
        print(f"[fleet] (a) r0, r1 started (11 graphs each) and in "
              f"rotation {time.perf_counter() - t0:.2f} s after the first "
              f"start, {rot_s:.2f} s after the second's registration; "
              f"router {base} (a subprocess), catalog budget "
              f"{budget / 2 ** 20:.1f} MiB a replica from [serve]'s "
              f"engines ({eh / 2 ** 20:.1f} / {em / 2 ** 20:.1f} MiB)",
              flush=True)

        # (b) routed bodies == direct bodies, predictions == Booster's
        direct = f"http://127.0.0.1:{r0.port}"
        lat = {}
        for n in FLEET_SIZES:
            body = csv_body(Xh[:n])
            seen = set()
            for _ in range(4):
                st, js, raw = http_call(base + "/predict", body)
                sd, _, rawd = http_call(direct + "/predict", body)
                if st != 200 or sd != 200 or raw != rawd:
                    fail(f"[fleet] (b) {n} rows: router {st} != direct "
                         f"{sd}, or the bodies differ")
                seen.add(raw)
            if len(seen) != 1 or np.asarray(
                    js["predictions"], np.float32).tobytes() \
                    != ref[:n].tobytes():
                fail(f"[fleet] (b) {n} rows: predictions != Booster.predict")
            if n in (1, 1000):
                calls = 200 if n == 1 else 50
                lat[n] = (pct_ms(timed_calls(
                    lambda: http_call(base + "/predict", body), calls)),
                    pct_ms(timed_calls(
                        lambda: http_call(direct + "/predict", body),
                        calls)))
        print(f"[fleet] (b) /predict of {', '.join(map(str, FLEET_SIZES))} "
              "CSV rows through the router == the same request to r0, "
              "byte for byte, == Booster.predict; ms p50 / p99, router | "
              "direct: " + "; ".join(
                  f"{n} row{'s' if n > 1 else ''} {a[0]:.3f} / {a[1]:.3f} "
                  f"| {b[0]:.3f} / {b[1]:.3f}" for n, (a, b)
                  in sorted(lat.items())) + f" | {card}", flush=True)

        # (c) 1,000 ids through the router, each on its ring owner
        ids = [f"u{i}" for i in range(FLEET_IDS)]
        st, js, _ = http_call(base + "/featurestore/put", json.dumps(
            {"ids": ids, "rows": Xh[:FLEET_IDS].tolist()}).encode())
        if st != 200:
            fail(f"[fleet] (c) put {st} {js}")
        ring = HashRing(64)
        ring.rebuild(["r0", "r1"])
        owner = {i: ring.route(i, {"r0", "r1"}) for i in ids}
        for rid, srv in (("r0", r0), ("r1", r1)):
            held = set(ids) - set(srv.featurestore.missing(ids))
            if held != {i for i in ids if owner[i] == rid}:
                fail(f"[fleet] (c) {rid} holds {len(held)} ids, not "
                     "exactly its HashRing keys")
        for _ in range(3):
            st, js, _ = http_call(base + "/predict_by_id",
                                  json.dumps({"ids": ids}).encode())
            if st != 200 or np.asarray(js["predictions"], np.float32) \
                    .tobytes() != ref.tobytes():
                fail(f"[fleet] (c) merged predict_by_id {st}: != /predict")
            for i in range(0, FLEET_IDS, 50):
                st, js, _ = http_call(base + "/predict_by_id",
                                      json.dumps({"ids": [ids[i]]}).encode())
                if st != 200 or np.float32(js["predictions"][0]) != ref[i]:
                    fail(f"[fleet] (c) {ids[i]} not answered by its owner "
                         f"{owner[i]} ({st})")
        n0 = sum(1 for i in ids if owner[i] == "r0")
        print(f"[fleet] (c) {FLEET_IDS} ids put through the router: {n0} on "
              f"r0, {FLEET_IDS - n0} on r1, each on its HashRing owner only; "
              "3 repeats of the merged request == /predict of the rows and "
              "20 single ids a repeat answered by their owners", flush=True)

        # (g) the placer: a two-model catalog onto r0 and r1
        t0 = time.perf_counter()
        ctl = run_placer(base, tenants, block=False, placer_id="smoke",
                         lease_sec=30.0, replication=1, hot_replication=1)
        report = {}
        while time.perf_counter() - t0 < 60.0:
            report = ctl.tick()
            if report.get("converged"):
                break
            time.sleep(0.5)
        if not report.get("converged"):
            fail(f"[fleet] (g) the placer did not converge: {report}")
        place_s = time.perf_counter() - t0
        m = members(base)
        hosted = {t: sorted(r["replica_id"] for r in m["replicas"]
                            if t in r["models"]) for t in tenants}
        per_rep = {r["replica_id"]: sorted(set(r["models"]) & set(tenants))
                   for r in m["replicas"]}
        if any(not h for h in hosted.values()) \
                or sorted(len(v) for v in per_rep.values()) != [1, 1]:
            fail(f"[fleet] (g) hosting {hosted}, per replica {per_rep}")
        for t, X, want in (("higgs", Xh[:1000], ref),
                           ("multiclass", Xm[:100], mref)):
            st, js, _ = http_call(base + f"/predict?model={t}", csv_body(X))
            if st != 200 or np.asarray(js["predictions"], np.float32) \
                    .tobytes() != want.tobytes():
                fail(f"[fleet] (g) /predict?model={t} through the router "
                     f"({st} {str(js)[:200]}) != Booster.predict")
        # the advertisement once both tenants are resident (a heartbeat
        # after their admissions): bytes within each replica's budget
        t1 = time.perf_counter()
        while True:
            m = members(base)
            adv = {r["replica_id"]: r["device"] for r in m["replicas"]}
            if all(((r["models_detail"].get(t) or {}).get("bytes") or 0) > 0
                   for r in m["replicas"] for t in per_rep[r["replica_id"]]):
                break
            if time.perf_counter() - t1 > 10.0:
                fail(f"[fleet] (g) tenants not resident after 10 s: {m}")
            time.sleep(0.1)
        if any(d["used_bytes"] > d["budget_bytes"] for d in adv.values()):
            fail(f"[fleet] (g) advertised device bytes over budget: {adv}")
        torch.cuda.synchronize()
        print(f"[fleet] (g) placer converged in {place_s:.2f} s: "
              f"{json.dumps(hosted)}; advertised bytes " + "; ".join(
                  f"{rid} {d['used_bytes'] / 2 ** 20:.1f} of "
                  f"{d['budget_bytes'] / 2 ** 20:.1f} MiB"
                  for rid, d in sorted(adv.items()))
              + f" (sum {sum(d['used_bytes'] for d in adv.values()) / 2 ** 20:.1f}"
              f" MiB) beside torch.cuda.memory_reserved "
              f"{torch.cuda.memory_reserved() / 2 ** 20:.1f} MiB for the "
              "whole process; /predict?model= == Booster.predict for both "
              f"| {card}", flush=True)

        # (d) canary rollout and rollback under traffic
        h_first = http_call(direct + "/healthz")[1]["model_hash"]
        with open(cand_path, "rb") as f:
            h_cand = hashlib.sha256(f.read()).hexdigest()
        stop, errs = threading.Event(), []
        one = csv_body(Xh[:1])

        def hammer():
            while not stop.is_set():
                try:
                    st, js, _ = http_call(base + "/predict", one)
                except OSError as e:
                    errs.append(repr(e))
                    continue
                p = np.asarray(js.get("predictions", []), np.float32)
                if st != 200 or p.tobytes() not in (ref[:1].tobytes(),
                                                     cref[:1].tobytes()):
                    errs.append((st, js))
        th = threading.Thread(target=hammer)
        th.start()
        t0 = time.perf_counter()
        st, rep, _ = http_call(base + "/fleet/rollout", json.dumps(
            {"model_path": cand_path, "canaries": 1, "soak_sec": 2.0,
             "gate_p99_ms": 1000.0}).encode(), timeout=120.0)
        roll_s = time.perf_counter() - t0
        hashes = [http_call(f"http://127.0.0.1:{s.port}/healthz")[1][
            "model_hash"] for s in (r0, r1)]
        st2, js, _ = http_call(base + "/predict", csv_body(Xh[:1000]))
        if st != 200 or rep.get("status") != "ok" or hashes != [h_cand] * 2 \
                or st2 != 200 or np.asarray(js["predictions"], np.float32) \
                .tobytes() != cref.tobytes():
            stop.set()
            fail(f"[fleet] (d) rollout {st} {rep}; replica hashes {hashes}; "
                 f"/predict after it {st2} {str(js)[:300]}; {len(errs)} bad "
                 f"answers under traffic {errs[:3]}")
        t1 = time.perf_counter()
        st, rb, _ = http_call(base + "/fleet/rollback", b"", timeout=120.0)
        back_s = time.perf_counter() - t1
        stop.set()
        th.join(60)
        hashes = [http_call(f"http://127.0.0.1:{s.port}/healthz")[1][
            "model_hash"] for s in (r0, r1)]
        st2, js, _ = http_call(base + "/predict", csv_body(Xh[:1000]))
        if st != 200 or rb.get("status") != "rolled_back" \
                or hashes != [h_first] * 2 or errs or st2 != 200 \
                or np.asarray(js["predictions"], np.float32).tobytes() \
                != ref.tobytes():
            fail(f"[fleet] (d) rollback {st} {rb}; hashes {hashes}; "
                 f"/predict after it {st2} {str(js)[:300]}; {len(errs)} bad "
                 f"answers under traffic {errs[:2]}")
        print(f"[fleet] (d) rollout of the candidate (canary "
              f"{rep.get('canaries')}, soak 2 s, captured under traffic): "
              f"{roll_s:.2f} s, both replicas on its sha256, answers == its "
              f"Booster.predict; rollback {back_s:.2f} s, the first hash and "
              f"answers back; no bad answer under traffic | {card}",
              flush=True)

        # (e) replica_kill on r1 during 400 requests from 16 threads.
        # A replica latency-ejected during (d)'s reload takes no traffic
        # until a probe readmits it after the cooldown, and a kill of a
        # replica that takes none leaves nothing to retry: first let r1
        # back into the least-loaded pool.  The probe goes to r1 only
        # while r0 is busy (ties go to r0), so the traffic comes in bursts
        t_wait = time.perf_counter()
        while time.perf_counter() - t_wait < FLEET_READMIT_S:
            reps = {r["replica_id"]: r for r in members(base)["replicas"]}
            if reps.get("r1", {}).get("in_rotation") \
                    and not reps["r1"].get("ejected"):
                break
            burst = [threading.Thread(target=http_call, args=(
                base + "/predict", csv_body(Xh[:1]))) for _ in range(4)]
            for t in burst:
                t.start()
            for t in burst:
                t.join(30)
            time.sleep(0.1)
        r1_wait = time.perf_counter() - t_wait
        results, lock = [], threading.Lock()

        def client(k):
            for j in range(FLEET_KILL_REQS // FLEET_KILL_THREADS):
                i = (k * 31 + j * 7) % FLEET_IDS
                st, js, _ = http_call(base + "/predict",
                                      csv_body(Xh[i:i + 1]))
                ok = st == 200 and np.asarray(
                    js["predictions"], np.float32).tobytes() \
                    == ref[i:i + 1].tobytes()
                with lock:
                    results.append((ok, st, time.perf_counter(),
                                    None if ok else str(js)[:160]))
                time.sleep(0.1)
        faults.inject("replica_kill", path_sub="r1", times=1)
        ts = [threading.Thread(target=client, args=(k,))
              for k in range(FLEET_KILL_THREADS)]
        for t in ts:
            t.start()
        t_out = None
        while any(t.is_alive() for t in ts) or (t_out is None
                                                 and "t" in killed):
            if "t" in killed and t_out is None:
                rot = [r["replica_id"] for r in members(base)["replicas"]
                       if r["in_rotation"]]
                if "r1" not in rot:
                    t_out = time.perf_counter()
            if "t" in killed and time.perf_counter() - killed["t"] > 30:
                break
            time.sleep(0.02)
        for t in ts:
            t.join(60)
        faults.clear_faults()
        last = max(r[2] for r in results) if results else 0.0
        bad = [r for r in results if not r[0]]
        if "t" not in killed or killed["t"] > last or bad \
                or len(results) != FLEET_KILL_REQS or t_out is None:
            fail(f"[fleet] (e) kill fired {killed} (last request at "
                 f"{last}); {len(bad)} client errors {bad[:3]}; "
                 f"{len(results)} answers; left rotation {t_out}; "
                 f"members {members(base)}")
        eject_s = t_out - killed["t"]
        if eject_s > FLEET_LEASE_S + FLEET_HC_S:
            fail(f"[fleet] (e) r1 left rotation {eject_s:.2f} s after the "
                 f"kill > lease {FLEET_LEASE_S} + health {FLEET_HC_S} s")
        sm = scrape_samples(http_call(base + "/metrics")[2].decode())
        if sm.get("xgbtpu_fleet_retries_total", 0) < 1 \
                or "xgbtpu_fleet_breaker_trips_total" not in sm:
            fail("[fleet] (e) the router's /metrics lack the retry or "
                 f"breaker counters (r1 readmitted after {r1_wait:.2f} s: "
                 f"{members(base)})")
        t0 = time.perf_counter()
        r1 = replica("r1", base)
        back = wait_rotation(base, ["r0", "r1"], FLEET_ROTATION_S)
        print(f"[fleet] (e) r1 in the least-loaded pool after {r1_wait:.2f} "
              f"s; replica_kill on r1 during {len(results)} "
              f"requests from {FLEET_KILL_THREADS} threads: no client error, "
              f"r1 out of rotation {eject_s:.3f} s after the kill (limit "
              f"{FLEET_LEASE_S + FLEET_HC_S:.1f}); retries "
              f"{sm['xgbtpu_fleet_retries_total']:.0f}, breaker trips "
              f"{sm['xgbtpu_fleet_breaker_trips_total']:.0f}; restarted "
              f"under its id, in rotation {time.perf_counter() - t0:.2f} s "
              f"later ({back:.2f} s after registering)", flush=True)

        # (f) shedding: 16 concurrent requests, budget 2, a 0.2 s wedge
        replica("r-shed", shed_base)
        wait_rotation(shed_base, ["r-shed"], FLEET_ROTATION_S)
        faults.inject("slow_replica", FLEET_SHED_S, path_sub="r-shed",
                      times=1000)
        shed = []

        def shed_client():
            st, js, _ = http_call(shed_base + "/predict", one)
            with lock:
                shed.append((st, js))
        ts = [threading.Thread(target=shed_client)
              for _ in range(FLEET_SHED_REQS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        faults.clear_faults()
        codes = sorted(st for st, _ in shed)
        wrong = [js for st, js in shed if st == 200 and np.asarray(
            js["predictions"], np.float32).tobytes() != ref[:1].tobytes()]
        unshed = [js for st, js in shed if st == 503 and not js.get("shed")]
        if not set(codes) <= {200, 503} or 200 not in codes \
                or 503 not in codes or wrong or unshed:
            fail(f"[fleet] (f) codes {codes}; {len(wrong)} wrong 200s; "
                 f"503s without shed {unshed[:2]}")
        print(f"[fleet] (f) fleet_inflight {FLEET_SHED_INFLIGHT}, "
              f"slow_replica {FLEET_SHED_S} s, {FLEET_SHED_REQS} concurrent "
              f"requests: {codes.count(200)} answered (each == "
              f"Booster.predict), {codes.count(503)} shed with 503 "
              f"\"shed\"", flush=True)
    except SystemExit:
        for _, lines in procs:
            print("[fleet] router stderr, last lines:\n  "
                  + "\n  ".join(lines[-40:]), file=sys.stderr, flush=True)
        raise
    finally:
        faults.clear_faults()
        for srv in servers:
            try:
                srv.shutdown()
            except Exception as e:  # noqa: BLE001 -- best-effort stop
                print(f"[fleet] shutdown: {e}", flush=True)
        for proc, _ in procs:
            proc.terminate()
            try:
                proc.wait(15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(15)

    counts = read_counts(kernels)
    if counts != only(kernels, hist_level=FLEET_CAND_ROUNDS * DEPTH):
        fail(f"[fleet] launch counts {counts}: serving launched a kernel")
    secs = time.perf_counter() - t_phase
    print(f"[fleet] all counts {json.dumps(counts)} (the candidate's "
          f"training only); phase {secs:.1f} s (limit {FLEET_PHASE_S:.0f})",
          flush=True)
    if secs > FLEET_PHASE_S:
        fail(f"[fleet] phase took {secs:.1f} s > {FLEET_PHASE_S} s")


def phase_otto(torch, xt, kernels, device, card):
    """``bench_otto`` (93 features, 9 classes) cut to 10 rounds."""
    from xgboost_tpu_torch.metrics import mlogloss
    X, y = make_otto(OTTO_N + MC_TEST)
    dtrain = xt.DMatrix(X[:OTTO_N], label=y[:OTTO_N])
    dtest = xt.DMatrix(X[OTTO_N:], label=y[OTTO_N:])
    reset_counts(kernels)
    t0 = time.perf_counter()
    bst = xt.train(OTTO_PARAMS, dtrain, OTTO_ROUNDS, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    want = OTTO_ROUNDS * DEPTH
    if counts != only(kernels, hist_batched=want):
        fail(f"otto launch counts {counts}: want hist_batched {want}")
    prob = bst.predict(dtest)
    if prob.shape != (MC_TEST, OTTO_K) or not np.isfinite(prob).all():
        fail(f"otto softprob output: shape {prob.shape}")
    ll = mlogloss(prob, y[OTTO_N:], np.ones(MC_TEST, np.float32))
    print(f"[otto] {OTTO_N} x {OTTO_FEAT}, {OTTO_K} classes, "
          f"{OTTO_ROUNDS} rounds: {train_s:.2f} s (cuts and binning "
          f"included); hist_batched launches {counts['hist_batched']}; "
          f"holdout mlogloss {ll:.6f} (uniform {np.log(OTTO_K):.6f}) | "
          f"{card}", flush=True)
    if not ll < np.log(OTTO_K):
        fail(f"otto mlogloss {ll} is no better than uniform")


def depth0_margin_bound(torch, kn, captured):
    """The stated bound on depth-0 margins, K2 run against plain run.
    Per round and tree the two node sums differ by at most
    eG = 2 n 2^-24 sum|g| (eH likewise, the bound of [K2]); the leaf
    w = -eta G / (H + lambda) then moves by at most
    eta (eG (H + lambda) + |G| eH) / ((H + lambda) (H + lambda - eH)).
    Summed over the rounds and doubled for the first-order effect of a
    margin difference on the next round's gradients (a Newton step
    carries an offset d into the next leaf as about -eta d / 2 of its
    own class, and less of the others')."""
    eta, lam = D0_PARAMS["eta"], 1.0
    total = 0.0
    for gh, pos, M in captured:
        s = kn.node_stats_plain(gh, pos, M).double()
        n = kn.node_stats_plain(torch.ones_like(gh), pos, M).double()
        a = kn.node_stats_plain(gh.abs(), pos, M).double()
        e = 2.0 * n * 2.0 ** -24 * a
        G, H = s[..., 0].abs(), s[..., 1] + lam
        dw = eta * (e[..., 0] * H + G * e[..., 1]) / (H * (H - e[..., 1]))
        total += float(dw.max())
    return 2.0 * total


def phase_depth0(torch, xt, kernels, device):
    """A max_depth=0 6-class booster: node statistics through K2."""
    kn = kernels["node_stats"]
    X, y = make_multiclass(MC_N)
    dtrain = xt.DMatrix(X, label=y)
    reset_counts(kernels)
    bst = xt.train(D0_PARAMS, dtrain, D0_ROUNDS, device=device)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    launches = counts["node_stats"]
    print(f"[depth0] {D0_ROUNDS} rounds of {MC_K} single-leaf trees; "
          f"node_stats launches {launches}; all counts "
          f"{json.dumps(counts)}", flush=True)
    if counts != only(kernels, node_stats=D0_ROUNDS):
        fail(f"depth-0 launch counts {counts}: want node_stats "
             f"{D0_ROUNDS}, the others 0")
    margin = bst.predict(dtrain, output_margin=True)
    kernel_fn = kn.node_stats
    captured = []

    def plain(gh, pos, n_node):
        captured.append((gh.clone(), pos.clone(), n_node))
        return kn.node_stats_plain(gh, pos, n_node)
    kn.node_stats = plain
    try:
        ref = xt.train(D0_PARAMS, dtrain, D0_ROUNDS, device=device)
    finally:
        kn.node_stats = kernel_fn
    diff = float(np.abs(ref.predict(dtrain, output_margin=True)
                        - margin).max())
    bound = depth0_margin_bound(torch, kn, captured)
    print(f"[depth0] margins vs the plain-node-stats run: max |diff| "
          f"{diff:.3e} (bound {bound:.3e})", flush=True)
    if not diff <= bound or not np.isfinite(margin).all():
        fail(f"depth-0 margins differ from the plain run by {diff} > "
             f"{bound}")
    again = xt.train(D0_PARAMS, dtrain, D0_ROUNDS, device=device)
    if again.save_raw() != bst.save_raw():
        fail("two depth-0 runs gave different model bytes")
    print("[depth0] a second run: identical model bytes (K2 sums in a "
          "fixed order)", flush=True)
    max_err = err_k2 = err_plain = 0.0
    for gh, pos, M in captured:
        got = kernel_fn(gh, pos, M)
        want = kn.node_stats_plain(gh, pos, M)
        n = kn.node_stats_plain(torch.ones_like(gh), pos, M)
        a = kn.node_stats_plain(gh.abs(), pos, M)
        torch.cuda.synchronize()
        if not sum_bound_ok(torch, got, want, n, a):
            fail("depth-0 node stats: |K2 - plain| beyond the bound")
        max_err = max(max_err, float((got - want).abs().max()))
        # which of the two is nearer the exact sums: float64 index_add_
        T, N, _ = gh.shape
        slot = torch.where(pos < 0, M, pos).to(torch.int64)
        idx = slot + (M + 1) * torch.arange(
            T, device=gh.device, dtype=torch.int64)[:, None]
        exact = torch.zeros((T * (M + 1), 2), dtype=torch.float64,
                            device=gh.device).index_add_(
            0, idx.reshape(-1), gh.reshape(-1, 2).double()).reshape(
            T, M + 1, 2)[:, :M]
        err_k2 = max(err_k2, float((got.double() - exact).abs().max()))
        err_plain = max(err_plain,
                        float((want.double() - exact).abs().max()))
    print(f"[depth0] K2 within 2 n 2^-24 sum|x| of plain at all "
          f"{len(captured)} rounds' inputs (max |diff| {max_err:.3e}); "
          f"max |error| against float64 sums: K2 {err_k2:.3e}, plain "
          f"{err_plain:.3e}", flush=True)
    return launches, captured[:1], max_err


def lane_runs(root, data, mode, params=LANE_PARAMS, cycles=LANE_CYCLES,
              rounds=LANE_ROUNDS):
    """``run_tenant_lanes`` kwargs of the tenants of ``data`` under
    ``root/mode``: a CallableDataSource each (the same pair every cycle),
    the holdout gate on AUC."""
    import shutil

    from xgboost_tpu_torch.pipeline import CallableDataSource
    base = os.path.join(root, mode)
    shutil.rmtree(base, ignore_errors=True)   # no state from an old run
    lanes = {}
    for i, pair in enumerate(data):
        d = os.path.join(base, f"tenant{i:02d}")
        lanes[f"tenant{i:02d}"] = {
            "publish_path": os.path.join(d, "model.bin"),
            "workdir": os.path.join(d, "work"),
            "source": CallableDataSource(lambda c, p=pair: p),
            "rounds_per_cycle": rounds, "cycles": cycles,
            "metric": "auc", "params": dict(params)}
    return lanes


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def gate_verdicts(events):
    """{(lane, cycle): (passed, metric, candidate, incumbent)} of the
    ``pipeline.gate`` events."""
    out = {}
    for e in events:
        if e["kind"] == "event" and e["name"] == "pipeline.gate":
            a = e["attrs"]
            out[(a["lane"], a["cycle"])] = (a["passed"], a["metric"],
                                            a["candidate"], a["incumbent"])
    return out


def run_lanes(torch, kernels, root, data, mode, device, params=LANE_PARAMS,
              cycles=LANE_CYCLES, rounds=LANE_ROUNDS):
    """One ``run_tenant_lanes`` over the tenants, counts set to 0 just
    before and read just after, its events logged to a file of its own.
    The log keeps its events without round phases
    (``XGBTPU_OBS_PHASES=0``): a configured log otherwise times each
    round's phases, which keeps every lane's rounds solo, as in the JAX
    package.  Returns (lanes, results, launch counts, lane-metric
    deltas, events, seconds)."""
    from xgboost_tpu_torch.obs import configure_log, lane_metrics
    from xgboost_tpu_torch.pipeline import run_tenant_lanes
    lanes = lane_runs(root, data, mode, params, cycles, rounds)
    log = os.path.join(root, f"events-{mode}.jsonl")
    if os.path.exists(log):
        os.remove(log)
    lm = lane_metrics()
    before = (lm.dispatches.value, lm.stacked.value, lm.padded.value,
              lm.restacks.value, lm.solo.values())
    configure_log(log)
    os.environ["XGBTPU_OBS_PHASES"] = "0"
    try:
        reset_counts(kernels)
        t0 = time.perf_counter()
        # every tenant must reach the rendezvous before its window
        # closes: 48 lanes' host phases (cuts, binning) take seconds
        res = run_tenant_lanes(lanes, quiet=True, window_sec=300.0,
                               device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(kernels)
    finally:
        configure_log(None)
        os.environ.pop("XGBTPU_OBS_PHASES", None)
    solo = {k: v - before[4].get(k, 0.0) for k, v in lm.solo.values().items()}
    delta = {"dispatches": lm.dispatches.value - before[0],
             "stacked": lm.stacked.value - before[1],
             "padded": lm.padded.value - before[2],
             "restacks": lm.restacks.value - before[3],
             "solo": {k: v for k, v in solo.items() if v}}
    return lanes, res, counts, delta, read_events(log), seconds



def phase_lanes(torch, xt, kernels, device, card):
    """``run_tenant_lanes`` on 48 tenants, stacked (K4) and as the host
    loop (K1), with every check of the module docstring."""
    from xgboost_tpu_torch.metrics import auc
    root = os.path.join(HERE, ".smoke_out", "lanes")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    arrays = [tenant_arrays(i) for i in range(LANES_N)]
    data = [(xt.DMatrix(X, label=y), xt.DMatrix(Xh, label=yh))
            for X, y, Xh, yh in arrays]
    rows = [a[0].shape[0] for a in arrays]
    print(f"[lanes] data: {LANES_N} tenants of {min(rows)}-{max(rows)} x "
          f"{N_FEAT} rows, {LANE_HOLD} holdout rows each: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 1. stacked (the default)
    os.environ.pop("XGBTPU_LANE_STACK", None)
    s_lanes, s_res, counts, delta, s_events, s_sec = run_lanes(
        torch, kernels, root, data, "stacked", device)
    want = LANE_CYCLES * LANE_ROUNDS * DEPTH
    print(f"[lanes] stacked run: {s_sec:.2f} s; hist_lanes launches "
          f"{counts['hist_lanes']}; all counts {json.dumps(counts)}; lane "
          f"metrics {json.dumps(delta)} | {card}", flush=True)
    bad = {n: r for n, r in s_res.items() if r["status"] != "ok"}
    if bad or len(s_res) != LANES_N:
        fail(f"stacked lanes not ok: {bad}")
    if counts != only(kernels, hist_lanes=want):
        fail(f"stacked launch counts {counts}: want hist_lanes {want} "
             f"({LANE_CYCLES} cycles x {LANE_ROUNDS} rounds x {DEPTH} "
             "levels), the others 0")
    stack_errors = [e for e in s_events
                    if e["name"] in ("lanes.stack_error", "lanes.solo")]
    if delta["solo"] or stack_errors:
        fail(f"a lane ran solo in the stacked run: {delta['solo']} "
             f"{stack_errors[:3]}")
    want_delta = {"dispatches": LANE_CYCLES,
                  "stacked": LANES_N * LANE_CYCLES,
                  "padded": (LANE_STACK - LANES_N) * LANE_CYCLES}
    if any(delta[k] != v for k, v in want_delta.items()):
        fail(f"lane dispatch accounting {delta}: want {want_delta}")
    for name, kw in s_lanes.items():
        with open(os.path.join(kw["workdir"], "gated.log")) as f:
            cycles = [int(line.split()[0]) for line in f]
        if not cycles or cycles[0] != 0:
            fail(f"{name} did not publish its cycle-0 model: {cycles}")
    spans = {}
    for e in s_events:
        if e["kind"] == "span":
            spans.setdefault(e["name"], []).append(e["dur_ms"])
    print("[lanes] stacked run spans, ms summed over the lane threads "
          "(they overlap): " + json.dumps(
              {k: round(sum(v), 1) for k, v in sorted(spans.items())})
          + "; lanes.dispatch each: "
          + json.dumps(spans.get("lanes.dispatch", [])), flush=True)
    print(f"[lanes] {LANES_N} tenants ok, each published its cycle-0 model; "
          f"{delta['dispatches']} dispatches carried {delta['stacked']} "
          f"lane-segments and {delta['padded']} pad lanes; no solo lane, "
          "no stack error", flush=True)

    # 2. the host loop, same tenants
    os.environ["XGBTPU_LANE_STACK"] = "0"
    try:
        h_lanes, h_res, h_counts, _, h_events, h_sec = run_lanes(
            torch, kernels, root, data, "host", device)
    finally:
        os.environ.pop("XGBTPU_LANE_STACK", None)
    want_k1 = LANES_N * want
    print(f"[lanes] host loop: {h_sec:.2f} s; all counts "
          f"{json.dumps(h_counts)} | {card}", flush=True)
    if h_counts != only(kernels, hist_level=want_k1):
        fail(f"host-loop launch counts {h_counts}: want hist_level "
             f"{want_k1}, the others 0")
    if any(r["status"] != "ok" for r in h_res.values()):
        fail("host-loop lanes not ok")
    for name in s_lanes:
        logs = []
        for lanes in (s_lanes, h_lanes):
            with open(lanes[name]["publish_path"], "rb") as f:
                raw = f.read()
            with open(os.path.join(lanes[name]["workdir"],
                                   "gated.log")) as f:
                logs.append((raw, f.read()))
        if logs[0] != logs[1]:
            fail(f"{name}: stacked and host-loop published models differ")
    sv, hv = gate_verdicts(s_events), gate_verdicts(h_events)
    if sv != hv or len(sv) != LANES_N * LANE_CYCLES:
        fail(f"gate verdicts differ: {len(sv)} stacked, {len(hv)} host")
    print(f"[lanes] stacked == host loop: every tenant's published model "
          f"bytes and ledger (its published bytes in each cycle) "
          f"identical, all {len(sv)} gate verdicts identical", flush=True)

    # 3. quality on each tenant's holdout
    aucs = []
    for i, (name, kw) in enumerate(s_lanes.items()):
        bst = xt.Booster(model_file=kw["publish_path"], device=device)
        pred = bst.predict(data[i][1])
        if pred.shape != (LANE_HOLD,) or not np.isfinite(pred).all():
            fail(f"{name}: holdout predictions {pred.shape}")
        aucs.append(auc(pred, arrays[i][3], np.ones(LANE_HOLD, np.float32)))
    print(f"[lanes] holdout AUC min {min(aucs):.6f} mean "
          f"{float(np.mean(aucs)):.6f} max {max(aucs):.6f} (floor "
          f"{LANE_AUC_FLOOR:.6f}: the JAX package's lowest "
          f"{LANE_JAX_AUC_MIN} - 0.005)",
          flush=True)
    if not min(aucs) >= LANE_AUC_FLOOR:
        fail(f"tenant holdout AUC {min(aucs)} < {LANE_AUC_FLOOR}")
    return counts["hist_lanes"], data, rows, (s_sec, h_sec), min(aucs)


def lanes_round_inputs(torch, xt, k4, data, device):
    """Every level's K4 inputs of one stacked round of all tenants."""
    from xgboost_tpu_torch.pipeline.lanes import LaneGang, _Arrival, _bucket_of
    kernel_fn = k4.level_histogram_lanes
    captured = []

    def capture(bins, gh, pos, n_node, n_bin, mode):
        captured.append((bins, gh.clone(), pos.clone(), n_node, n_bin, mode))
        return kernel_fn(bins, gh, pos, n_node, n_bin, mode)
    arrs = []
    for i, (d, _) in enumerate(data):
        bst = xt.Booster(LANE_PARAMS, [d], device=device)
        spec, why = bst.fused_lane_spec(d, 0, 1)
        if spec is None:
            fail(f"tenant {i} declined stacking: {why}")
        arrs.append(_Arrival(f"tenant{i:02d}", spec, lambda it: None))
    k4.level_histogram_lanes = capture
    try:
        LaneGang(expected=0)._dispatch_bucket(_bucket_of(arrs[0].spec), arrs)
    finally:
        k4.level_histogram_lanes = kernel_fn
    if any(a.exc is not None for a in arrs) or len(captured) != DEPTH:
        fail(f"one stacked round: {len(captured)} K4 levels, errors "
             f"{[a.exc for a in arrs if a.exc is not None][:2]}")
    return captured


def check_lanes_levels(torch, k4, cuda_hist, captured, rows):
    """At every level of one stacked round, on its real inputs: K4 ==
    plain, each tenant's slice == a solo K1 launch on its unpadded rows,
    the pad lanes' slices zero."""
    max_err = 0.0
    for bins, gh, pos, M, nb, mode in captured:
        got = k4.level_histogram_lanes(bins, gh, pos, M, nb, mode)
        want = k4.level_histogram_lanes_plain(bins, gh, pos, M, nb, mode)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - want).abs().max()))
        if mode != "int" or not torch.equal(got, want):
            fail(f"lanes level n_node={M}: mode {mode}, K4 != plain")
        for lane in range(bins.shape[0]):
            sl = got[..., lane * M:(lane + 1) * M]
            if lane >= len(rows):
                if bool(sl.any()):
                    fail(f"lanes level n_node={M}: pad lane {lane} not 0")
                continue
            n = rows[lane]
            solo = cuda_hist.level_histogram(
                bins[lane, :n].contiguous(), gh[lane, :n].contiguous(),
                pos[lane, :n].contiguous(), M, nb, mode)
            if not torch.equal(sl, solo):
                fail(f"lanes level n_node={M}: tenant {lane} != solo K1")
    print(f"[lanes] K4 == plain and each tenant == solo K1 on its "
          f"unpadded rows, int8 bitwise, pad lanes zero, at all "
          f"{len(captured)} levels of a stacked round", flush=True)
    return max_err


# ------------------------------------------------------------- phase 5
def plan_text(kb, name, N, F, nb, T, M, mode, dev):
    """The scatter launch plan K1, K3 or K4 takes at this level."""
    p = kb.launch_plan(name, N, F, nb, T, M, mode, dev)
    return (f"plan f_tile {p.f_tile} t_tile {p.t_tile} m_tile {p.m_tile} "
            f"units {p.n_units} copies {p.copies} blocks {p.grid} rows a "
            f"step {p.rows_per_step} {'store' if p.store else 'atomic'} "
            "flush")


def phase_times(torch, cuda_hist, captured, card):
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    rows = []
    for bins, gh, pos, M, nb, mode in captured:
        N, F = bins.shape
        active = int((pos >= 0).sum())
        ms = cuda_ms(torch, lambda: cuda_hist.level_histogram(
            bins, gh, pos, M, nb, mode), 20)
        dev_ms, _ = profiled_ms(torch, lambda: cuda_hist.level_histogram(
            bins, gh, pos, M, nb, mode))
        plain_ms = cuda_ms(torch, lambda: cuda_hist.level_histogram_plain(
            bins, gh, pos, M, nb, mode), 5)
        # one PyTorch call for the same sums: index_add_ on flat cell
        # indices computed beforehand (inactive rows to a dump cell)
        f_ids = torch.arange(F, device=bins.device, dtype=torch.int64)
        base = ((f_ids[None, :] * nb + bins.to(torch.int64)) * 2) * M \
            + pos.to(torch.int64)[:, None]
        idx = base[:, :, None] + torch.tensor([0, M], device=bins.device)
        idx = torch.where((pos >= 0)[:, None, None], idx, F * nb * 2 * M)
        idx = idx.reshape(-1)
        src = gh[:, None, :].expand(N, F, 2).reshape(-1)
        out = torch.zeros(F * nb * 2 * M + 1, dtype=gh.dtype,
                          device=bins.device)
        lib_ms = cuda_ms(torch, lambda: out.index_add_(0, idx, src), 5)
        # least work: every row's pos, the active rows' bins and gh, the
        # histogram written once; one addition per (active row, feature,
        # channel)
        nbytes = 4 * N + active * (F + 8) + F * nb * 2 * M * 4
        ops = active * F * 2
        bound_ms = max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S) * 1e3
        by = "bytes" if nbytes / PEAK_BYTES_S >= ops / PEAK_OPS_S \
            else "operations"
        plan = plan_text(kb, "hist_level", N, F, nb, 1, M, mode, bins.device)
        rows.append(dict(n_node=M, active_rows=active, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
        print(f"[time] K1 n_node={M}: {ms:.4f} ms, device {dev_ms:.4f} ms "
              f"(bound {bound_ms:.4f} ms, {by}; plain {plain_ms:.4f} ms; "
              f"index_add_ {lib_ms:.4f} ms; {plan}) | {card}", flush=True)
    return rows


def bound_of(nbytes, ops):
    """(least ms, what bounds it) for moving ``nbytes`` and doing ``ops``
    f32 operations at the card's peak rates."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_k3(torch, kb, captured, card):
    rows = []
    for bins, gh, pos, M, nb, mode in captured:
        N, F = bins.shape
        T = gh.shape[0]
        act = pos >= 0
        pairs = int(act.sum())
        any_rows = int(act.any(dim=0).sum())
        ms = cuda_ms(torch, lambda: kb.level_histogram_batched(
            bins, gh, pos, M, nb, mode), 20)
        dev_ms, _ = profiled_ms(torch, lambda: kb.level_histogram_batched(
            bins, gh, pos, M, nb, mode))
        plain_ms = cuda_ms(torch, lambda: kb.level_histogram_batched_plain(
            bins, gh, pos, M, nb, mode), 5)
        # one PyTorch call for the same sums: index_add_ over flat cell
        # indices of all T trees computed beforehand (inactive to a dump)
        cells = F * nb * 2 * T * M
        f_ids = torch.arange(F, device=bins.device, dtype=torch.int64)
        col = (torch.arange(T, device=bins.device, dtype=torch.int64)[:, None]
               * M + pos.to(torch.int64))                      # (T, N)
        base = ((f_ids[None, None, :] * nb + bins.to(torch.int64)[None])
                * 2) * (T * M) + col[:, :, None]               # (T, N, F)
        idx = base[..., None] + torch.tensor([0, T * M], device=bins.device)
        idx = torch.where(act[:, :, None, None], idx, cells).reshape(-1)
        src = gh[:, :, None, :].expand(T, N, F, 2).reshape(-1)
        out = torch.zeros(cells + 1, dtype=gh.dtype, device=bins.device)
        lib_ms = cuda_ms(torch, lambda: out.index_add_(0, idx, src), 5)
        del idx, src, base
        # least work: every tree's pos, the bins of rows active in some
        # tree, the active (tree, row) pairs' gh, the histogram written
        # once; one addition per (active pair, feature, channel)
        bound_ms, by = bound_of(4 * T * N + any_rows * F + 8 * pairs
                                + cells * 4, pairs * F * 2)
        plan = plan_text(kb, "hist_batched", N, F, nb, T, M, mode,
                         bins.device)
        rows.append(dict(n_node=M, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=by))
        print(f"[time] K3 T={T} n_node={M}: {ms:.4f} ms, device "
              f"{dev_ms:.4f} ms (bound {bound_ms:.4f} ms, {by}; plain "
              f"{plain_ms:.4f} ms; index_add_ {lib_ms:.4f} ms; {plan}) | "
              f"{card}", flush=True)
    return rows


def time_k2(torch, kn, captured, card):
    rows = []
    for gh, pos, M in captured:
        T, N, _ = gh.shape
        active = int((pos >= 0).sum())
        ms = cuda_ms(torch, lambda: kn.node_stats(gh, pos, M), 20)
        dev_ms, acts = profiled_ms(torch, lambda: kn.node_stats(gh, pos, M))
        if len(acts) != 1 or list(acts.values()) != [1.0] \
                or "node_stats" not in next(iter(acts)):
            fail(f"K2 T={T} n_node={M}: a call issued {acts}, not one "
                 "kernel")
        plain_ms = cuda_ms(torch, lambda: kn.node_stats_plain(gh, pos, M),
                           20)
        slot = torch.where(pos < 0, M, pos).to(torch.int64)
        idx = (slot + (M + 1) * torch.arange(
            T, device=gh.device, dtype=torch.int64)[:, None]).reshape(-1)
        src = gh.reshape(-1, 2)
        out = torch.zeros((T * (M + 1), 2), dtype=torch.float32,
                          device=gh.device)
        lib_ms = cuda_ms(torch, lambda: out.index_add_(0, idx, src), 20)
        bound_ms, by = bound_of(4 * T * N + 8 * active + T * M * 8,
                                2 * active)
        rows.append(dict(n_node=M, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=by))
        print(f"[time] K2 T={T} n_node={M}: {ms:.4f} ms, device "
              f"{dev_ms:.4f} ms, one kernel a call (bound {bound_ms:.4f} "
              f"ms, {by}; plain {plain_ms:.4f} ms; index_add_ "
              f"{lib_ms:.4f} ms) | {card}", flush=True)
    return rows


def time_k4(torch, k4, captured, card):
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    rows = []
    for bins, gh, pos, M, nb, mode in captured:
        L, N, F = bins.shape
        active = int((pos >= 0).sum())
        ms = cuda_ms(torch, lambda: k4.level_histogram_lanes(
            bins, gh, pos, M, nb, mode), 20)
        dev_ms, _ = profiled_ms(torch, lambda: k4.level_histogram_lanes(
            bins, gh, pos, M, nb, mode))
        plain_ms = cuda_ms(torch, lambda: k4.level_histogram_lanes_plain(
            bins, gh, pos, M, nb, mode), 5)
        # one PyTorch call for the same sums: index_add_ over all lanes'
        # flat cell indices computed beforehand (inactive to a dump cell)
        cells = F * nb * 2 * L * M
        idx = k4.lane_cell_index(bins, pos, M, nb).reshape(-1)
        src = gh[:, :, None, :].expand(L, N, F, 2).reshape(-1)
        out = torch.zeros(cells + 1, dtype=gh.dtype, device=bins.device)
        lib_ms = cuda_ms(torch, lambda: out.index_add_(0, idx, src), 5)
        del idx, src
        # least work: every row's pos, the active rows' bins and gh, the
        # histogram written once; one addition per (active row, feature,
        # channel)
        bound_ms, by = bound_of(4 * L * N + active * (F + 8) + cells * 4,
                                active * F * 2)
        plan = plan_text(kb, "hist_lanes", N, F, nb, L, M, mode,
                         bins.device)
        rows.append(dict(n_node=M, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=by))
        print(f"[time] K4 L={L} n_node={M}: {ms:.4f} ms, device "
              f"{dev_ms:.4f} ms (bound {bound_ms:.4f} ms, {by}; plain "
              f"{plain_ms:.4f} ms; index_add_ {lib_ms:.4f} ms; {plan}) | "
              f"{card}", flush=True)
    return rows


def time_lane_cycles(torch, xt, data, device, card):
    """The training step the lane dispatcher changes, as
    ``tools/bench_lanes.py`` times it (gate, publish and ledger left
    out): per cycle, the 48 tenants' boosters each advance LANE_ROUNDS
    rounds, as 48 ``update_many`` calls (the host loop's boost path) or
    as one ``LaneGang`` bucket dispatch (rendezvous cost aside: the
    lanes are handed over at once).  Cycle 0 (cuts, binning, first
    launches) is left out; the LANE_TIMED_CYCLES after it alternate host
    loop and stacked on one card.  Both end with the same model bytes per
    tenant."""
    from xgboost_tpu_torch.pipeline.lanes import LaneGang, _Arrival, _bucket_of

    def boosters():
        return [(xt.Booster(LANE_PARAMS, [d], device=device), d)
                for d, _ in data]
    host, stacked = boosters(), boosters()
    gang = LaneGang(expected=0)
    host_ts, stacked_ts = [], []
    for c in range(LANE_TIMED_CYCLES + 1):
        it0 = c * LANE_ROUNDS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b, d in host:
            b.update_many(d, it0, LANE_ROUNDS)
        torch.cuda.synchronize()
        host_ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        arrs = [_Arrival(f"tenant{i:02d}",
                         b.fused_lane_spec(d, it0, LANE_ROUNDS)[0],
                         lambda it: None)
                for i, (b, d) in enumerate(stacked)]
        gang._dispatch_bucket(_bucket_of(arrs[0].spec), arrs)
        torch.cuda.synchronize()
        stacked_ts.append(time.perf_counter() - t0)
        if any(a.exc is not None for a in arrs):
            fail(f"bench cycle {c}: a lane failed")
    if any(bs.save_raw() != bh.save_raw()
           for (bs, _), (bh, _) in zip(stacked, host)):
        fail("bench: stacked and host-loop boosters differ in bytes")
    h_ms = [t * 1e3 for t in host_ts[1:]]
    s_ms = [t * 1e3 for t in stacked_ts[1:]]
    h, st = float(np.mean(h_ms)), float(np.mean(s_ms))
    print(f"[time] lanes cycle ({LANES_N} tenants x {LANE_ROUNDS} rounds, "
          f"gate and publish left out): host loop {h:.3f} ms "
          f"({[round(x, 3) for x in h_ms]}; {LANES_N / h * 1e3:.4g} "
          f"tenants/s), stacked {st:.3f} ms ({[round(x, 3) for x in s_ms]}; "
          f"{LANES_N / st * 1e3:.4g} tenants/s); cycle 0 (setup) host "
          f"{host_ts[0] * 1e3:.1f} ms, stacked {stacked_ts[0] * 1e3:.1f} "
          f"ms; identical model bytes | {card}", flush=True)
    return h, st


# ------------------------------------------------------------- [sample]
def auc_of(xt, bst, dmat, y):
    from xgboost_tpu_torch.metrics import auc
    pred = bst.predict(dmat)
    if pred.shape != (len(y),) or not np.isfinite(pred).all():
        fail(f"holdout predictions: shape {pred.shape}")
    return auc(pred, y, np.ones(len(y), np.float32))


def round_ms(torch, xt, params, dtrain, device):
    """ms per round of ``params`` on ``dtrain``: a booster's rounds 1 to
    ROUNDS - 1, round 0 (cuts, binning) untimed; and its model bytes."""
    bst = xt.Booster(params, cache=[dtrain], device=device)
    bst.update(dtrain, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst.update_many(dtrain, 1, ROUNDS - 1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (ROUNDS - 1), bst.save_raw()


def phase_sample(torch, xt, cuda_hist, kernels, device, card, main_out):
    """[main]'s Higgs data with row and column sampling."""
    from xgboost_tpu_torch import random as prng
    from xgboost_tpu_torch.models import tree as tt
    X, y = main_out["X"], main_out["y"]
    dtrain = xt.DMatrix(X[:N_TRAIN], label=y[:N_TRAIN])
    dtest = xt.DMatrix(X[N_TRAIN:], label=y[N_TRAIN:])
    dev = torch.device(device)

    reset_counts(kernels)
    t0 = time.perf_counter()
    bst = xt.train(SAMPLE_PARAMS, dtrain, ROUNDS, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    print(f"[sample] train {ROUNDS} rounds (subsample, colsample_bytree "
          f"and colsample_bylevel 0.8; cuts and binning included): "
          f"{train_s:.2f} s; hist_level launches {counts['hist_level']}; all "
          f"counts {json.dumps(counts)}", flush=True)
    if counts != only(kernels, hist_level=ROUNDS * DEPTH):
        fail(f"sampled launch counts {counts}: want hist_level "
             f"{ROUNDS * DEPTH}, the others 0")
    raw = bst.save_raw()

    # the draws of rounds 0-2 on the card == those on the CPU, same keys
    cfg = bst.gbtree.cfg
    for r in range(3):
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(0), r), 0)[None]
        on_card = tt.draw_masks(key, N_TRAIN, N_FEAT, cfg, dev)
        on_cpu = tt.draw_masks(key, N_TRAIN, N_FEAT, cfg, "cpu")
        kept = float(on_card.keep.float().mean())
        if not (torch.equal(on_card.keep.cpu(), on_cpu.keep)
                and torch.equal(on_card.fmask.cpu(), on_cpu.fmask)):
            fail(f"round {r}: the card's row or feature masks != the CPU's")
        print(f"[sample] round {r}: row mask ({kept:.4f} kept) and the "
              f"{DEPTH} levels' feature masks (features a level "
              f"{on_cpu.fmask.sum(-1).flatten().tolist()}) bitwise == the "
              "CPU's draws", flush=True)

    score = auc_of(xt, bst, dtest, y[N_TRAIN:])
    floor = SAMPLE_AUC_JAX - 0.005
    print(f"[sample] holdout AUC {score:.6f} (floor {floor:.6f}: the JAX "
          f"package's {SAMPLE_AUC_JAX} on the CPU - 0.005)", flush=True)
    if not score >= floor:
        fail(f"sampled holdout AUC {score} < {floor}")

    ms, raw2 = round_ms(torch, xt, SAMPLE_PARAMS, dtrain, device)
    if raw2 != raw:
        fail("a second sampled run gave different model bytes")
    key = prng.PRNGKey(0)
    draw_ms = cuda_ms(torch, lambda: prng.uniform_rows(key, N_TRAIN, dev),
                      20)
    print(f"[sample] {ms:.3f} ms per round ([main] {main_out['ms_round']:.3f}"
          f"); one {N_TRAIN}-row uniform draw {draw_ms:.4f} ms | {card}",
          flush=True)

    kernel_fn = cuda_hist.level_histogram
    cuda_hist.level_histogram = cuda_hist.level_histogram_plain
    try:
        plain = xt.train(SAMPLE_PARAMS, dtrain, ROUNDS, device=device)
    finally:
        cuda_hist.level_histogram = kernel_fn
    if plain.save_raw() != raw:
        fail("sampled: kernel and plain histograms grew different models")
    print("[sample] plain-histogram run: identical model bytes", flush=True)
    return counts["hist_level"], ms, draw_ms, score


# ------------------------------------------------------------ [subtract]
def phase_subtract(torch, xt, cuda_hist, kernels, device, card, main_out):
    """[main]'s configuration under XGBTPU_HIST_SUBTRACTION=1: per level
    from 1 on, K2 counts each child's rows, K1 builds the smaller
    children on the compacted rows, the siblings are parent - small."""
    from xgboost_tpu_torch.models import tree as tt
    from xgboost_tpu_torch.ops import histogram as th
    kn = kernels["node_stats"]
    X, y = main_out["X"], main_out["y"]
    dtrain = xt.DMatrix(X[:N_TRAIN], label=y[:N_TRAIN])
    dtest = xt.DMatrix(X[N_TRAIN:], label=y[N_TRAIN:])
    os.environ["XGBTPU_HIST_SUBTRACTION"] = "1"
    try:
        reset_counts(kernels)
        t0 = time.perf_counter()
        bst = xt.train(PARAMS, dtrain, ROUNDS, device=device)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_counts(kernels)
        if not bst.gbtree.cfg.hist_subtraction:
            fail("XGBTPU_HIST_SUBTRACTION=1 did not reach the grow config")
        want = only(kernels, hist_level=ROUNDS * DEPTH,
                    node_stats=ROUNDS * (DEPTH - 1))
        print(f"[subtract] train {ROUNDS} rounds: {train_s:.2f} s; all "
              f"counts {json.dumps(counts)}", flush=True)
        if counts != want:
            fail(f"subtraction launch counts {counts}: want hist_level "
                 f"{ROUNDS * DEPTH} (6 a tree) and node_stats "
                 f"{ROUNDS * (DEPTH - 1)} (levels 1-5), the others 0")
        score = auc_of(xt, bst, dtest, y[N_TRAIN:])
        print(f"[subtract] holdout AUC {score:.6f} ([main] "
              f"{main_out['auc']:.6f}, bound 0.002)", flush=True)
        if not abs(score - main_out["auc"]) <= 0.002:
            fail(f"subtracted AUC {score} is not within 0.002 of "
                 f"{main_out['auc']}")
        ms, _ = round_ms(torch, xt, PARAMS, dtrain, device)
        print(f"[subtract] {ms:.3f} ms per round ([main] "
              f"{main_out['ms_round']:.3f}) | {card}", flush=True)

        # one tree's subtracted levels, their inputs captured
        sub_fn, k1_fn, k2_fn = (tt._subtracted_level_hist,
                                cuda_hist.level_histogram, kn.node_stats)
        levels, k1_calls, k2_calls = [], [], []

        def sub(*args, **kw):
            levels.append(args)
            return sub_fn(*args, **kw)

        def k1(bins, gh, pos, n_node, n_bin, mode):
            k1_calls.append((bins, gh, pos, n_node, n_bin, mode))
            return k1_fn(bins, gh, pos, n_node, n_bin, mode)

        def k2(gh, pos, n_node):
            k2_calls.append((gh, pos, n_node))
            return k2_fn(gh, pos, n_node)
        tt._subtracted_level_hist = sub
        cuda_hist.level_histogram, kn.node_stats = k1, k2
        try:
            xt.train(PARAMS, dtrain, 1, device=device)
        finally:
            tt._subtracted_level_hist = sub_fn
            cuda_hist.level_histogram, kn.node_stats = k1_fn, k2_fn
    finally:
        os.environ.pop("XGBTPU_HIST_SUBTRACTION", None)
    if len(levels) != DEPTH - 1 or len(k1_calls) != DEPTH \
            or len(k2_calls) != DEPTH - 1:
        fail(f"one subtracted tree: {len(levels)} levels, {len(k1_calls)} "
             f"K1 and {len(k2_calls)} K2 calls")
    cap = max(256, -(-(N_TRAIN // 2) // 256) * 256)
    for bins, gh, pos, M, nb, mode in k1_calls[1:]:
        if bins.shape[0] != cap:
            fail(f"K1 at n_node={M} ran on {bins.shape[0]} rows, not the "
                 f"{cap} compacted ones")
        got, want = (k1_fn(bins, gh, pos, M, nb, mode),
                     cuda_hist.level_histogram_plain(bins, gh, pos, M, nb,
                                                     mode))
        if mode != "int" or not torch.equal(got, want):
            fail(f"subtraction's compacted K1 n_node={M} != plain")
    for gh, pos, M in k2_calls:
        got, want = k2_fn(gh, pos, M), kn.node_stats_plain(gh, pos, M)
        n = kn.node_stats_plain(torch.ones_like(gh), pos, M)
        if not sum_bound_ok(torch, got, want, n, want.abs()):
            fail(f"subtraction's K2 row counts n_node={M} != plain")
    # each subtracted level against the same subtraction on the plain
    # versions (int8: bitwise) and against the plain full build.  Every
    # value the two hold is within the root's sum |gh| in its cell, A:
    # level 0 and each small child round once (<= 2^-24 A), each of the
    # d subtractions once more, and the full build once, so they differ
    # by at most (2 d + 2) 2^-24 A, and one more 2^-24 A for A's own
    # rounding
    max_err = 0.0
    for d, (binned, prep, pos, M, nb, parent, split) in enumerate(levels, 1):
        got = sub_fn(binned, prep, pos, M, nb, parent, split)
        cuda_hist.level_histogram, kn.node_stats = (
            cuda_hist.level_histogram_plain, kn.node_stats_plain)
        try:
            same = sub_fn(binned, prep, pos, M, nb, parent, split)
            full = th.build_level_histogram(binned, prep, pos[0], M, nb)
            root = th.build_level_histogram(
                binned, th.HistPrep(prep.gh_in.abs(), prep.scale, prep.mode),
                torch.zeros_like(pos[0]), 1, nb)
        finally:
            cuda_hist.level_histogram, kn.node_stats = k1_fn, k2_fn
        if not torch.equal(got, same):
            fail(f"subtracted level n_node={M}: kernels != plain versions")
        bound = (2 * d + 3) * 2.0 ** -24 * root
        err = (got - full).abs()
        max_err = max(max_err, float(err.max()))
        if bool((err > bound).any()):
            fail(f"subtracted level n_node={M} beyond its bound of the "
                 "full build")
    print(f"[subtract] K1 on {cap} compacted rows == plain (int8 bitwise) "
          f"at levels 1-{DEPTH - 1}; K2 row counts == plain; each "
          "subtracted level == the same subtraction on the plain versions "
          "and within (2 d + 3) 2^-24 of the root's sum |gh| of the full "
          f"build (max |diff| {max_err:.3e})", flush=True)
    return counts["hist_level"], counts["node_stats"], ms, score


# -------------------------------------------------------------- [forest]
def phase_forest(torch, xt, kernels, device, card):
    """bench_multiclass's data as a sampled random forest: 6 classes x 2
    parallel trees a round through K3, each tree its own masks."""
    from xgboost_tpu_torch import random as prng
    from xgboost_tpu_torch.metrics import merror
    from xgboost_tpu_torch.models import tree as tt
    from xgboost_tpu_torch.models.gbtree import tree_keys
    kb = kernels["hist_batched"]
    X, y = make_multiclass(MC_N + MC_TEST)
    dtrain = xt.DMatrix(X[:MC_N], label=y[:MC_N])
    dtest = xt.DMatrix(X[MC_N:], label=y[MC_N:])
    T = MC_K * FOREST_NPAR
    reset_counts(kernels)
    t0 = time.perf_counter()
    bst = xt.train(FOREST_PARAMS, dtrain, FOREST_ROUNDS, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    want = FOREST_ROUNDS * DEPTH
    print(f"[forest] {FOREST_ROUNDS} rounds of {T} trees: {train_s:.2f} s "
          f"(cuts and binning included); all counts {json.dumps(counts)}",
          flush=True)
    if counts != only(kernels, hist_batched=want):
        fail(f"forest launch counts {counts}: want hist_batched {want}")
    if bst.gbtree.num_trees != FOREST_ROUNDS * T:
        fail(f"{bst.gbtree.num_trees} trees, want {FOREST_ROUNDS * T}")
    draws = tt.draw_masks(tree_keys(prng.fold_in(prng.PRNGKey(0), 0), T),
                          MC_N, MC_FEAT, bst.gbtree.cfg, torch.device(device))
    masks = {bytes(m.cpu().numpy()) for m in draws.keep}
    if len(masks) != T:
        fail(f"round 0's {T} trees drew {len(masks)} distinct row masks")
    pred = bst.predict(dtest)
    onehot = np.eye(MC_K, dtype=np.float32)[pred.astype(np.int64)]
    err = merror(onehot, y[MC_N:], np.ones(MC_TEST, np.float32))
    ceiling = FOREST_MERROR_JAX + FOREST_MERROR_BOUND
    print(f"[forest] holdout merror {err:.6f} (ceiling {ceiling:.6f}: the "
          f"JAX package's {FOREST_MERROR_JAX} on the CPU + "
          f"{FOREST_MERROR_BOUND}); round 0's {T} trees drew {T} distinct "
          f"row masks | {card}", flush=True)
    if not err <= ceiling:
        fail(f"forest merror {err} > {ceiling}")
    kernel_fn = kb.level_histogram_batched
    kb.level_histogram_batched = kb.level_histogram_batched_plain
    try:
        plain = xt.train(FOREST_PARAMS, dtrain, FOREST_ROUNDS, device=device)
    finally:
        kb.level_histogram_batched = kernel_fn
    if plain.save_raw() != bst.save_raw():
        fail("forest: kernel and plain batched histograms grew different "
             "models")
    print("[forest] plain-histogram run: identical model bytes", flush=True)
    return counts["hist_batched"], err


# ------------------------------------------------------ [subtract] (mc)
def phase_subtract_multiclass(torch, xt, kernels, device, card, mc_ms):
    """The multiclass data under XGBTPU_HIST_SUBTRACTION=1: a round's 6
    trees build level 0 with K3, then per level K2 counts each child's
    rows and K4 builds the small children on each tree's compacted rows
    (the trees as lanes).  The plain versions must grow the same bytes."""
    from xgboost_tpu_torch.metrics import merror
    kb, k4, kn = (kernels["hist_batched"], kernels["hist_lanes"],
                  kernels["node_stats"])
    X, y = make_multiclass(MC_N + MC_TEST)
    dtrain = xt.DMatrix(X[:MC_N], label=y[:MC_N])
    dtest = xt.DMatrix(X[MC_N:], label=y[MC_N:])
    R = SUB_MC_ROUNDS
    os.environ["XGBTPU_HIST_SUBTRACTION"] = "1"
    try:
        reset_counts(kernels)
        t0 = time.perf_counter()
        bst = xt.train(MC_PARAMS, dtrain, R, device=device)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_counts(kernels)
        want = only(kernels, hist_batched=R, hist_lanes=R * (DEPTH - 1),
                    node_stats=R * (DEPTH - 1))
        pred = bst.predict(dtest)
        onehot = np.eye(MC_K, dtype=np.float32)[pred.astype(np.int64)]
        err = merror(onehot, y[MC_N:], np.ones(MC_TEST, np.float32))
        print(f"[subtract] multiclass, {R} rounds of {MC_K} trees: "
              f"{train_s:.2f} s (cuts and binning included); all counts "
              f"{json.dumps(counts)}; holdout merror {err:.6f} | {card}",
              flush=True)
        if counts != want:
            fail(f"multiclass subtraction launch counts {counts}: want "
                 f"hist_batched {R} (level 0), hist_lanes and node_stats "
                 f"{R * (DEPTH - 1)} (levels 1-5)")
        ms, _ = round_ms(torch, xt, MC_PARAMS, dtrain, device)
        print(f"[subtract] multiclass {ms:.3f} ms per round ([multiclass] "
              f"{mc_ms:.3f}) | {card}", flush=True)
        saved = (kb.level_histogram_batched, k4.level_histogram_lanes,
                 kn.node_stats)
        kb.level_histogram_batched = kb.level_histogram_batched_plain
        k4.level_histogram_lanes = k4.level_histogram_lanes_plain
        kn.node_stats = kn.node_stats_plain
        try:
            plain = xt.train(MC_PARAMS, dtrain, R, device=device)
        finally:
            (kb.level_histogram_batched, k4.level_histogram_lanes,
             kn.node_stats) = saved
    finally:
        os.environ.pop("XGBTPU_HIST_SUBTRACTION", None)
    if plain.save_raw() != bst.save_raw():
        fail("multiclass subtraction: kernels and plain versions grew "
             "different models")
    print("[subtract] multiclass plain K3, K4 and K2: identical model bytes",
          flush=True)
    return (counts["hist_batched"], counts["hist_lanes"],
            counts["node_stats"], ms)


# ------------------------------------------------------- [lanes-sampled]
def phase_lanes_sampled(torch, xt, kernels, device, card):
    """8 of [lanes]' tenants with subsample 0.8, stacked and as the host
    loop, 1 cycle of 10 rounds.  The row draw is N-shaped, so a sampled
    bucket holds one row count (``lanes.py:72-80``): each tenant's first
    LANE_ROWS0 rows, all 8 in one bucket."""
    root = os.path.join(HERE, ".smoke_out", "lanes_sampled")
    os.makedirs(root, exist_ok=True)
    data = []
    for i in range(SL_LANES):
        X, y, Xh, yh = tenant_arrays(i)
        data.append((xt.DMatrix(X[:LANE_ROWS0], label=y[:LANE_ROWS0]),
                     xt.DMatrix(Xh, label=yh)))
    want = SL_ROUNDS * DEPTH
    s_lanes, s_res, counts, delta, s_events, s_sec = run_lanes(
        torch, kernels, root, data, "stacked", device, SL_PARAMS, 1,
        SL_ROUNDS)
    print(f"[lanes-sampled] stacked run: {s_sec:.2f} s; all counts "
          f"{json.dumps(counts)}; lane metrics {json.dumps(delta)}",
          flush=True)
    if any(r["status"] != "ok" for r in s_res.values()):
        fail(f"sampled stacked lanes not ok: {s_res}")
    if counts != only(kernels, hist_lanes=want) or delta["solo"] \
            or delta["dispatches"] != 1:
        fail(f"sampled stacked run: counts {counts}, lane metrics {delta}: "
             f"want hist_lanes {want} in one dispatch, no K1, no solo lane")
    os.environ["XGBTPU_LANE_STACK"] = "0"
    try:
        h_lanes, h_res, h_counts, _, h_events, h_sec = run_lanes(
            torch, kernels, root, data, "host", device, SL_PARAMS, 1,
            SL_ROUNDS)
    finally:
        os.environ.pop("XGBTPU_LANE_STACK", None)
    if h_counts != only(kernels, hist_level=SL_LANES * want) \
            or any(r["status"] != "ok" for r in h_res.values()):
        fail(f"sampled host loop: counts {h_counts}")
    for name in s_lanes:
        logs = []
        for lanes in (s_lanes, h_lanes):
            with open(lanes[name]["publish_path"], "rb") as f:
                raw = f.read()
            with open(os.path.join(lanes[name]["workdir"],
                                   "gated.log")) as f:
                logs.append((raw, f.read()))
        if logs[0] != logs[1]:
            fail(f"{name}: sampled stacked and host-loop models differ")
    sv, hv = gate_verdicts(s_events), gate_verdicts(h_events)
    if sv != hv or len(sv) != SL_LANES:
        fail(f"sampled gate verdicts differ: {len(sv)} stacked, {len(hv)}")
    print(f"[lanes-sampled] host loop: {h_sec:.2f} s, hist_level "
          f"{h_counts['hist_level']}; stacked == host loop: {SL_LANES} "
          f"tenants' model bytes, ledgers and {len(sv)} gate verdicts "
          f"identical | {card}", flush=True)
    return counts["hist_lanes"]


# --------------------------------------------------------------- [roots]
def phase_roots(torch, xt, cuda_hist, kernels, device, card, main_out):
    """200,000 of [main]'s rows in two regimes, one tree root each: the
    label is flipped where ``X[:, 20] > 0.5`` (a uniform feature) and
    that is each row's ``root_index``."""
    n = ROOTS_N
    X, y = main_out["X"], main_out["y"]
    root = (X[:, 20] > 0.5).astype(np.uint32)
    y = np.where(root == 1, 1.0 - y, y).astype(np.float32)

    def dm(lo, hi, r):
        d = xt.DMatrix(X[lo:hi], label=y[lo:hi])
        if r is not None:
            d.set_uint_info("root_index", r[lo:hi])
        return d
    dtrain = dm(0, n, root)
    reset_counts(kernels)
    bst = xt.train(ROOTS_PARAMS, dtrain, ROOTS_ROUNDS, device=device)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    want = ROOTS_ROUNDS * DEPTH
    if counts != only(kernels, hist_level=want):
        fail(f"multi-root launch counts {counts}: want hist_level {want}")
    cap = bst.gbtree.get_state()["tree_feature"].shape[1]
    if cap != 2 ** (1 + DEPTH + 1) - 1:
        fail(f"multi-root trees hold {cap} nodes")
    dtest = dm(N_TRAIN, N_TRAIN + N_TEST, root)
    flipped = dm(N_TRAIN, N_TRAIN + N_TEST, 1 - root)
    score = auc_of(xt, bst, dtest, y[N_TRAIN:])
    score_flip = auc_of(xt, bst, flipped, y[N_TRAIN:])
    pred = bst.predict(dtest)
    floor = ROOTS_AUC_JAX - 0.005
    print(f"[roots] {n} rows, num_roots 2, {ROOTS_ROUNDS} rounds: all counts "
          f"{json.dumps(counts)}; trees of {cap} nodes; holdout AUC "
          f"{score:.6f} (floor {floor:.6f}: the JAX package's "
          f"{ROOTS_AUC_JAX} on the CPU - 0.005), with every root flipped "
          f"{score_flip:.6f} | {card}", flush=True)
    if not score >= floor:
        fail(f"multi-root AUC {score} < {floor}")
    if not score_flip < 0.5 or np.array_equal(bst.predict(flipped), pred):
        fail(f"flipped roots predict as well: AUC {score_flip}")
    path = os.path.join(HERE, ".smoke_out", "smoke_roots.bin")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    bst.save_model(path)
    loaded = xt.Booster(model_file=path, device=device)
    if not (np.array_equal(loaded.predict(dtest), pred) and np.array_equal(
            loaded.predict(dtest, pred_leaf=True),
            bst.predict(dtest, pred_leaf=True))):
        fail("multi-root predictions changed over save_model / load_model")
    kernel_fn = cuda_hist.level_histogram
    cuda_hist.level_histogram = cuda_hist.level_histogram_plain
    try:
        plain = xt.train(ROOTS_PARAMS, dtrain, ROOTS_ROUNDS, device=device)
    finally:
        cuda_hist.level_histogram = kernel_fn
    if plain.save_raw() != bst.save_raw():
        fail("multi-root: kernel and plain histograms grew different models")
    print("[roots] save/load: bitwise-equal predictions and leaves; "
          "plain-histogram run: identical model bytes", flush=True)

    # two trees a round: K3 on the root slots copied per tree
    kb = kernels["hist_batched"]
    reset_counts(kernels)
    forest = xt.train(ROOTS_FOREST_PARAMS, dtrain, ROOTS_ROUNDS,
                      device=device)
    torch.cuda.synchronize()
    f_counts = read_counts(kernels)
    if f_counts != only(kernels, hist_batched=want):
        fail(f"multi-root forest launch counts {f_counts}: want "
             f"hist_batched {want}")
    f_score = auc_of(xt, forest, dtest, y[N_TRAIN:])
    f_flip = auc_of(xt, forest, flipped, y[N_TRAIN:])
    # no JAX figure for the forest: it is held to the one-tree run's AUC
    # on the same rows, less 0.01
    f_floor = score - 0.01
    print(f"[roots] forest (num_parallel_tree 2, subsample 0.8): all counts "
          f"{json.dumps(f_counts)}; holdout AUC {f_score:.6f} (floor "
          f"{f_floor:.6f}: the one-tree run's - 0.01), with every root "
          f"flipped {f_flip:.6f} | {card}", flush=True)
    if not (f_score >= f_floor and f_flip < 0.5):
        fail(f"multi-root forest AUC {f_score} (floor {f_floor}), flipped "
             f"{f_flip}")
    kernel_fn = kb.level_histogram_batched
    kb.level_histogram_batched = kb.level_histogram_batched_plain
    try:
        plain = xt.train(ROOTS_FOREST_PARAMS, dtrain, ROOTS_ROUNDS,
                         device=device)
    finally:
        kb.level_histogram_batched = kernel_fn
    if plain.save_raw() != forest.save_raw():
        fail("multi-root forest: kernel and plain batched histograms grew "
             "different models")
    print("[roots] forest plain-histogram run: identical model bytes",
          flush=True)
    return counts["hist_level"], f_counts["hist_batched"]


# ------------------------------------------------------------- [profile]
def phase_profile(torch, xt, kernels, device, card, main_out):
    """[main]'s configuration with profile=1 (20 rounds, the holdout as
    a watchlist), then 3 rounds with profile=2 and its torch.profiler
    trace read back."""
    import contextlib
    import io
    import shutil
    X, y = main_out["X"], main_out["y"]
    dtrain = xt.DMatrix(X[:N_TRAIN], label=y[:N_TRAIN])
    dtest = xt.DMatrix(X[N_TRAIN:], label=y[N_TRAIN:])
    reset_counts(kernels)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        bst = xt.train(dict(PARAMS, profile=1), dtrain, ROUNDS,
                       evals=[(dtest, "test")], verbose_eval=False,
                       device=device)
    counts = read_counts(kernels)
    if counts != only(kernels, hist_level=ROUNDS * DEPTH):
        fail(f"profiled launch counts {counts}")
    lines = [ln for ln in err.getvalue().splitlines()
             if ln.startswith("[prof]")]
    if sum(ln.startswith("[prof] round ") for ln in lines) != ROUNDS:
        fail(f"profile=1 printed {len(lines)} [prof] lines")
    rounds = bst.profiler.rounds
    phases = {k: sum(r["phases"].get(k, 0.0) for r in rounds) * 1e3
              / len(rounds) for k in ("predict", "gradient", "grow", "eval")}
    print("[profile] profile=1, ms per round: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()) + f" (sum "
        f"{sum(phases.values()):.3f}; [main] unprofiled "
        f"{main_out['ms_round']:.3f}) | {card}", flush=True)
    for ln in lines[-5:]:
        print(f"[profile]   {ln}", flush=True)
    bst.set_param("profile", 0)
    if bst.save_raw() != main_out["raw"]:
        fail("profile=1 changed the model bytes")
    print("[profile] model bytes == [main]'s (the profile parameter "
          "reset: the header records it)", flush=True)

    out_dir = os.path.join(HERE, ".smoke_out", "profile")
    shutil.rmtree(out_dir, ignore_errors=True)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        b2 = xt.train(dict(PARAMS, profile=2, profile_dir=out_dir), dtrain,
                      PROFILE2_ROUNDS, device=device)
    if f"trace written to {out_dir}" not in err.getvalue():
        fail("profile=2 wrote no trace")
    with open(os.path.join(out_dir, "xgtpu_trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kern = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            k = kern.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1e3
    if not kern:
        fail("the profile=2 trace holds no CUDA activity")
    n = PROFILE2_ROUNDS
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:10]
    total = sum(v[1] for v in kern.values()) / n
    count = sum(v[0] for v in kern.values()) / n
    wall = sum(sum(r["phases"].values()) for r in b2.profiler.rounds
               ) * 1e3 / n
    print(f"[profile] profile=2, {n} rounds: device time {total:.3f} ms a "
          f"round over {count:.0f} CUDA activities, of {wall:.3f} ms of "
          f"traced round time (device idle {100 * (1 - total / wall):.1f}%);"
          " the ten largest, ms and count a round:", flush=True)
    for name, (cnt, ms) in top:
        print(f"[profile]   {ms / n:8.4f} ms  {cnt / n:6.1f}x  {name[:110]}",
              flush=True)
    k1_ms = sum(v[1] for k, v in kern.items()
                if "hist_scatter::kernel" in k) / n
    grow = sum(r["phases"].get("grow", 0.0) for r in b2.profiler.rounds
               ) * 1e3 / n
    print(f"[profile] K1 (hist_scatter::kernel) {k1_ms:.4f} ms of grow's "
          f"{grow:.3f} ms a round ({100 * k1_ms / grow:.1f}%) | {card}",
          flush=True)
    return counts["hist_level"], phases, k1_ms, grow


# ------------------------------------------------------------- [onehot]
# The one-hot tensor-core kernels (T5, T3, T2, T7; the bf16 family T1,
# T4a, T4b, T6) and the TPU prototypes they replace (the Pallas kernel
# body of each)
# ------------------------------------------------------------------ [rank]
def phase_updaters(torch, xt, kernels, device, card, main_out):
    """ROADMAP item 9 on [main]'s data, every run's launch counts set to
    0 just before and read just after: (a) exact ``grow_colmaker``, (b)
    ``grow_skmaker`` (Higgs, then [multiclass]'s data), (c) ``refresh``
    of [main]'s model on a fresh draw, then ``grow_histmaker,refresh``.
    Returns {kernel: launches} summed over the phase and its times."""
    from xgboost_tpu_torch.metrics import auc
    from xgboost_tpu_torch.models import colmaker

    X, y = main_out["X"], main_out["y"]
    dtrain = xt.DMatrix(X[:N_TRAIN], label=y[:N_TRAIN])
    dtest = xt.DMatrix(X[N_TRAIN:], label=y[N_TRAIN:])
    ones = np.ones(N_TEST, np.float32)
    total = {name: 0 for name in kernels}
    times = {}

    def counted(want, fn):
        reset_counts(kernels)
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts(kernels)
        if counts != only(kernels, **want):
            fail(f"[updaters] launch counts {counts}: want {want}, the "
                 "others 0")
        for name, n in counts.items():
            total[name] += n
        return out

    def rounds(params, dmat, n, want):
        """``n`` rounds: round 0 (entry, cuts or ranks) apart, the rest
        timed, host clock ending in a synchronize."""
        bst = xt.Booster(params, cache=[dmat], device=device)

        def run():
            t0 = time.perf_counter()
            bst.update(dmat, 0)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            bst.update_many(dmat, 1, n - 1)
            torch.cuda.synchronize()
            return first, (time.perf_counter() - t0) * 1e3 / (n - 1)
        first, ms = counted(want, run)
        return bst, first, ms

    # (a) exact: K2 at every level, D + 1 a tree; the one-off rank build
    rank_s = []
    real_ranks = colmaker.build_exact_ranks

    def timed_ranks(Xh):
        t0 = time.perf_counter()
        out = real_ranks(Xh)
        rank_s.append(time.perf_counter() - t0)
        return out
    colmaker.build_exact_ranks = timed_ranks
    try:
        bst, first, ms = rounds(EXACT_PARAMS, dtrain, UPD_EXACT_ROUNDS,
                                {"node_stats": UPD_EXACT_ROUNDS
                                 * (DEPTH + 1)})
    finally:
        colmaker.build_exact_ranks = real_ranks
    if not bst.gbtree.exact_raw or len(rank_s) != 1:
        fail(f"[updaters] exact: exact_raw {bst.gbtree.exact_raw}, rank "
             f"builds {len(rank_s)}")
    pred = bst.predict(dtest)
    score = auc(pred, y[N_TRAIN:], ones)
    floor = EXACT_AUC_JAX - 0.005
    print(f"[updaters] exact {UPD_EXACT_ROUNDS} rounds: K2 "
          f"{UPD_EXACT_ROUNDS * (DEPTH + 1)} launches; holdout AUC "
          f"{score:.6f} (floor {floor:.6f}); {ms:.3f} ms per round; round "
          f"0 {first:.2f} s with the rank build {rank_s[0]:.2f} s | {card}",
          flush=True)
    if not score >= floor:
        fail(f"[updaters] exact holdout AUC {score} < {floor}")
    times.update(exact_ms=ms, exact_rank_s=rank_s[0])
    # the model saved on the card predicts the same on the CPU
    cpu = xt.Booster(device="cpu")
    cpu.load_raw(bst.save_raw())
    hold = X[N_TRAIN:]
    m_card = bst.predict(hold, output_margin=True)
    m_cpu = cpu.predict(hold, output_margin=True)
    if not np.allclose(m_cpu, m_card, rtol=0, atol=1e-6) or not \
            np.array_equal(cpu.predict(hold, pred_leaf=True),
                           bst.predict(hold, pred_leaf=True)):
        fail("[updaters] exact: the card's model predicts otherwise on the "
             f"CPU (max |margin diff| {np.abs(m_cpu - m_card).max()})")
    print("[updaters] exact model on the CPU: margins within 1e-6 "
          f"(max {np.abs(m_cpu - m_card).max()}), pred_leaf equal",
          flush=True)
    del bst, cpu

    # (b) skmaker: K1 at levels 0-5, K2 at the terminal level
    bst, _, ms = rounds(SK_PARAMS, dtrain, UPD_SK_ROUNDS,
                        {"hist_level": UPD_SK_ROUNDS * DEPTH,
                         "node_stats": UPD_SK_ROUNDS})
    score = auc(bst.predict(dtest), y[N_TRAIN:], ones)
    floor = SK_AUC_JAX - 0.005
    print(f"[updaters] skmaker {UPD_SK_ROUNDS} rounds: K1 "
          f"{UPD_SK_ROUNDS * DEPTH}, K2 {UPD_SK_ROUNDS}; holdout AUC "
          f"{score:.6f} (floor {floor:.6f}); {ms:.3f} ms per round | {card}",
          flush=True)
    if not score >= floor:
        fail(f"[updaters] skmaker holdout AUC {score} < {floor}")
    times["skmaker_ms"] = ms
    del bst
    Xm, ym = make_multiclass(MC_N + MC_TEST)
    dmc = xt.DMatrix(Xm[:MC_N], label=ym[:MC_N])
    bst, _, ms = rounds({**MC_PARAMS, "updater": "grow_skmaker"}, dmc,
                        UPD_SK_MC_ROUNDS,
                        {"hist_batched": UPD_SK_MC_ROUNDS * DEPTH,
                         "node_stats": UPD_SK_MC_ROUNDS})
    merr = float(np.mean(bst.predict(Xm[MC_N:]) != ym[MC_N:]))
    print(f"[updaters] skmaker multiclass {UPD_SK_MC_ROUNDS} rounds of "
          f"{MC_K} trees: K3 {UPD_SK_MC_ROUNDS * DEPTH}, K2 "
          f"{UPD_SK_MC_ROUNDS} ({MC_K} trees a launch); holdout merror "
          f"{merr:.4f}; {ms:.3f} ms per round | {card}", flush=True)
    if not merr < 1.0 - 1.0 / MC_K:
        fail(f"[updaters] skmaker multiclass merror {merr}: no better than "
             "chance")
    times["skmaker_mc_ms"] = ms
    del bst, dmc, Xm, ym

    # (c) refresh: [main]'s 20 trees on a fresh draw, one K2 a level
    Xf, yf = make_higgs_like(N_TRAIN, seed=UPD_REFRESH_SEED)
    dfresh = xt.DMatrix(Xf, label=yf)
    bst = xt.Booster(device=device)
    bst.load_raw(main_out["raw"])
    bst.set_param({"updater": "refresh"})
    before = bst.gbtree.get_state()
    it = bst.gbtree.num_boosted_rounds
    counted({"node_stats": DEPTH + 1}, lambda: bst.update(dfresh, it))
    after = bst.gbtree.get_state()
    for f in ("feature", "cut_index", "threshold", "default_left",
              "is_leaf"):
        if not np.array_equal(after["tree_" + f], before["tree_" + f]):
            fail(f"[updaters] refresh changed the trees' {f}")
    # the same pass on the CPU, on the card's gradients: leaf values
    # within rtol 1e-5 plus the f32 summation bound of their node sums
    # (the kernel and index_add_ add in different orders)
    from xgboost_tpu_torch.models.updaters import refresh_trees
    entry = bst._entry(dfresh)
    model0 = xt.Booster(device=device)
    model0.load_raw(main_out["raw"])
    st0, _ = model0.gbtree._stack(0)
    T = st0.feature.shape[0]
    sp, depth = bst.gbtree.cfg.split, bst.gbtree.cfg.max_depth
    gh = bst.obj.get_gradient(model0.gbtree.predict_margin(
        entry.binned, entry.base), dfresh.info, it)
    g = gh[:, 0, 0][None].expand(T, -1)
    h = gh[:, 0, 1][None].expand(T, -1)
    st0_cpu = type(st0)(*(x.cpu() for x in st0))
    want = refresh_trees(st0_cpu, entry.binned.cpu(),
                         torch.stack([g, h], -1).cpu(), sp, depth)

    def node_sums(v):       # (T, n_nodes) sums of a per-row value
        return refresh_trees(st0, entry.binned, torch.stack(
            [v, v], -1).contiguous(), sp, depth).sum_hess.cpu()
    G, n, s_abs = node_sums(g), node_sums(torch.ones_like(g)), \
        node_sums(g.abs())
    H = want.sum_hess
    eps = 2.0 * n * 2.0 ** -24
    dG, dH = eps * s_abs, eps * H
    hl = (H + sp.reg_lambda - dH).clamp_min(1e-30)
    tol = (sp.eta * (dG / hl + G.abs() * dH / (hl * (H + sp.reg_lambda)))
           + 1e-5 * want.leaf_value.abs())
    got_leaf = torch.from_numpy(after["tree_leaf_value"])
    diff = (got_leaf - want.leaf_value).abs()
    rel = float((diff / want.leaf_value.abs().clamp_min(1e-30))[
        want.leaf_value != 0].max())
    print(f"[updaters] refresh vs the CPU's on the card's gradients: max "
          f"|leaf diff| {float(diff.max()):.3g}, max relative {rel:.3g} "
          f"(rtol 1e-5 alone holds: "
          f"{bool((diff <= 1e-5 * want.leaf_value.abs()).all())})",
          flush=True)
    if not bool((diff <= tol).all()):
        fail("[updaters] refreshed leaf values beyond rtol 1e-5 plus the "
             "f32 summation bound of the CPU's")
    del model0, st0, st0_cpu, want
    # ms a pass: the refresh alone, K2 7 launches for all 20 trees
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        bst.gbtree.do_refresh(entry.binned, gh, root=entry.root)
    torch.cuda.synchronize()
    pass_ms = (time.perf_counter() - t0) * 1e3 / reps
    times["refresh_ms"] = pass_ms
    print(f"[updaters] refresh of {T} trees on "
          f"{N_TRAIN} rows: K2 {DEPTH + 1} launches; structure unchanged; "
          f"{pass_ms:.3f} ms a pass | {card}", flush=True)
    # grow_histmaker,refresh: K1 6 and K2 7 a round
    bst.set_param({"updater": "grow_histmaker,refresh"})
    n = UPD_GROW_REFRESH_ROUNDS
    counted({"hist_level": n * DEPTH, "node_stats": n * (DEPTH + 1)},
            lambda: bst.update_many(dfresh, it + 1, n))
    if bst.gbtree.num_trees != 20 + n:
        fail(f"[updaters] grow_histmaker,refresh: {bst.gbtree.num_trees} "
             f"trees, want {20 + n}")
    print(f"[updaters] grow_histmaker,refresh {n} rounds: K1 {n * DEPTH}, "
          f"K2 {n * (DEPTH + 1)}", flush=True)
    return total, times


def make_rank(n=RANK_N):
    """``bench.py:bench_rank``'s data: relevance 0-2 from a noisy score
    of three features, groups of RANK_GSIZE rows."""
    rng = np.random.RandomState(11)
    X = rng.randn(n, N_FEAT).astype(np.float32)
    rel = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.randn(n)
    y = np.clip((rel > 0.5) + (rel > 1.5), 0, 2).astype(np.float32)
    return X, y, np.full(n // RANK_GSIZE, RANK_GSIZE, np.int64)


def rank_dmatrix(xt, X, y, group):
    d = xt.DMatrix(X, label=y)
    d.set_group(group)
    return d


def boost_told(torch, kernels, xt, params, d, rounds, device,
               wrap_first=None):
    """The path's counted run: a Booster's round 0 (cuts, binning, the
    layout; under ``wrap_first``, a context) and, timed, rounds 1 to
    ``rounds - 1`` (``update_many``), with every launch count set to 0
    just before and read just after and stderr captured and echoed:
    (booster, ms per timed round, counts, the ``[rank]`` path lines)."""
    import contextlib
    import io
    err = io.StringIO()
    reset_counts(kernels)
    with contextlib.redirect_stderr(err):
        bst = xt.Booster(params, cache=[d], device=device)
        with wrap_first() if wrap_first else contextlib.nullcontext():
            bst.update(d, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst.update_many(d, 1, rounds - 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (rounds - 1)
    counts = read_counts(kernels)
    sys.stderr.write(err.getvalue())
    return bst, ms, counts, [ln for ln in err.getvalue().splitlines()
                             if ln.startswith("[rank] LambdaRank gradient")]


def ndcg_of(bst, d):
    from xgboost_tpu_torch.metrics import ndcg
    p = bst.predict(d)
    if p.shape != (d.num_row,) or not np.isfinite(p).all():
        fail(f"rank predictions: shape {p.shape}")
    return ndcg(p, d.get_label(), None, d.info.group_ptr)


def rank_grad_bound(torch, want, n_other):
    """``tests/test_torch_rank.py``'s bound on one round's gradient pairs
    (one pair draw, no list weight) against another device's: 16 ulp of
    the value plus 2^-21 (1 + n_other).  The two devices' log and exp
    differ by an ulp or two; the NDCG weight is a difference of two such
    sums over the IDCG, and a row adds its own side and up to n_other
    times the side it receives."""
    a = want.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return 16 * ulp + 2.0 ** -21 * (1.0 + n_other)[:, None]


def phase_rank(torch, xt, cuda_hist, kernels, device, card):
    """bench_rank on the group-padded layout (K1 on 1,040,000 slots)."""
    import contextlib
    from xgboost_tpu_torch import rank_device as rd
    t0 = time.perf_counter()
    X, y, group = make_rank()
    d = rank_dmatrix(xt, X, y, group)
    print(f"[rank] data {RANK_N} x {N_FEAT}, {len(group)} groups of "
          f"{RANK_GSIZE}: {time.perf_counter() - t0:.2f} s", flush=True)

    # round 0's levels captured as K1 runs them (the capture adds no
    # launch); the comparisons below come after the counts are read
    kernel_fn = cuda_hist.level_histogram
    captured = []

    def capture(bins, gh, pos, n_node, n_bin, mode):
        captured.append((bins, gh.clone(), pos.clone(), n_node, n_bin, mode))
        return kernel_fn(bins, gh, pos, n_node, n_bin, mode)

    @contextlib.contextmanager
    def capturing():
        cuda_hist.level_histogram = capture
        try:
            yield
        finally:
            cuda_hist.level_histogram = kernel_fn
    t0 = time.perf_counter()
    bst, ms, counts, told = boost_told(torch, kernels, xt, RANK_PARAMS, d,
                                       RANK_ROUNDS, device, capturing)
    secs = time.perf_counter() - t0
    entry = bst._cache[id(d)]
    prep = entry.rank_pad_prep
    print(f"[rank] {RANK_ROUNDS} rounds (cuts, binning and the padded "
          f"layout in round 0): {secs:.2f} s; hist_level launches "
          f"{counts['hist_level']}; all counts {json.dumps(counts)}",
          flush=True)
    if counts != only(kernels, hist_level=RANK_ROUNDS * DEPTH):
        fail(f"rank launch counts {counts}: want hist_level "
             f"{RANK_ROUNDS * DEPTH}, the others 0")
    if len(told) != 1 or "group-padded" not in told[0] or prep is None:
        fail(f"rank path lines {told}: want one naming group-padded")
    slots = prep.G * prep.L + prep.n_tail
    print(f"[rank] layout: {prep.G} groups x L = {prep.L} lanes = {slots} "
          f"slots ({slots / RANK_N:.3f}x the rows)", flush=True)
    score = ndcg_of(bst, d)
    floor = RANK_NDCG_JAX - 0.005
    print(f"[rank] training NDCG {score:.6f} (floor {floor:.6f}: the JAX "
          f"package's {RANK_NDCG_JAX:.6f} on the CPU - 0.005)", flush=True)
    if not score >= floor:
        fail(f"rank NDCG {score} < {floor}")
    raw = bst.save_raw()

    max_err = 0.0
    for bins, gh, pos, M, nb, mode in captured:
        got = kernel_fn(bins, gh, pos, M, nb, mode)
        want = cuda_hist.level_histogram_plain(bins, gh, pos, M, nb, mode)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - want).abs().max()))
        if mode != "int" or not torch.equal(got, want):
            fail(f"rank level n_node={M}: mode {mode}, kernel != plain")
    inactive = float((captured[0][2] < 0).float().mean())
    print(f"[rank] kernel == plain, int8 bitwise, at all {len(captured)} "
          f"levels of round 0 on the padded layout ({inactive:.4f} of the "
          "slots padding, pos -1)", flush=True)
    del captured

    # one round's gradient on the card against the CPU's on its margin
    bst._sync_margin(entry)
    margin = entry.margin
    key = bst.obj.round_key(RANK_ROUNDS)
    grad_ms = cuda_ms(torch, lambda: bst.obj.get_gradient(
        margin, d.info, RANK_ROUNDS, pad_prep=prep), 20)
    on_card = bst.obj.get_gradient(margin, d.info, RANK_ROUNDS,
                                   pad_prep=prep)[:, 0].cpu()
    cpu_prep = rd.PadRankPrep(*(x.cpu() if torch.is_tensor(x) else x
                                for x in prep))
    on_cpu = rd.rank_gradient_padded(margin[:, 0].cpu(), key, cpu_prep,
                                     "ndcg")
    if not torch.equal(rd.pad_partners(key, 0, prep).cpu(),
                       rd.pad_partners(key, 0, cpu_prep)):
        fail("rank: the card's partner lanes != the CPU's")
    n_other = torch.clamp_min(cpu_prep.g_size - cpu_prep.b_sz, 1).reshape(
        -1).float()
    n_other = torch.cat([n_other, torch.zeros(prep.n_tail)])
    err = (on_card - on_cpu).abs()
    if not bool((err <= rank_grad_bound(torch, on_cpu, n_other)).all()):
        fail(f"rank: the card's gradient != the CPU's within the bound "
             f"(max abs err {float(err.max()):.3g})")
    print(f"[rank] round {RANK_ROUNDS}'s gradient: partner lanes bitwise == "
          f"the CPU's, g / h within 16 ulp + 2^-21 (1 + n_other) of the "
          f"CPU's (max abs err {float(err.max()):.3g})", flush=True)
    print(f"[rank] {ms:.3f} ms per round ({slots / ms * 1e3:.4g} slots/s), "
          f"gradient {grad_ms:.4f} ms a call | {card}", flush=True)

    # the same rounds with the plain histogram forced on the card
    cuda_hist.level_histogram = cuda_hist.level_histogram_plain
    try:
        plain = xt.train({**RANK_PARAMS, "silent": 1}, d, RANK_ROUNDS,
                         device=device)
    finally:
        cuda_hist.level_histogram = kernel_fn
    plain.set_param("silent", 0)
    if plain.save_raw() != raw:
        fail("rank: kernel and plain histograms grew different models")
    print("[rank] plain-histogram run: identical model bytes", flush=True)
    return counts["hist_level"], ms, grad_ms, max_err, (bst, d, score)


def phase_rank_sort(torch, xt, kernels, device, card):
    """bench_rank's data on the sort path and on the host path."""
    from xgboost_tpu_torch import rank_device as rd
    X, y, group = make_rank()
    launches, rows = 0, []
    for kind, n, rounds, impl in (
            ("map", RANK_N, RANK_SORT_ROUNDS, "device"),
            ("pairwise", RANK_N, RANK_SORT_ROUNDS, "device"),
            ("ndcg", RANK_HOST_N, RANK_HOST_ROUNDS, "host")):
        params = {**RANK_PARAMS, "objective": f"rank:{kind}",
                  "rank_impl": impl}
        tag = f"rank:{kind} " + ("sort path" if impl == "device"
                                 else "host path")
        g = group[:n // RANK_GSIZE]
        d = rank_dmatrix(xt, X[:n], y[:n], g)
        t0 = time.perf_counter()
        os.environ["XGBTPU_RANK_PAD"] = "0"
        try:
            bst, ms, counts, told = boost_told(torch, kernels, xt, params,
                                               d, rounds, device)
        finally:
            del os.environ["XGBTPU_RANK_PAD"]
        launches += counts["hist_level"]
        print(f"[rank-sort] {tag}: {n} rows, {rounds} rounds "
              f"{time.perf_counter() - t0:.2f} s; hist_level launches "
              f"{counts['hist_level']}; all counts {json.dumps(counts)}",
              flush=True)
        if counts != only(kernels, hist_level=rounds * DEPTH):
            fail(f"{tag}: launch counts {counts}")
        want_told = 1 if impl == "device" else 0
        if len(told) != want_told or not all("sort-based" in t
                                             for t in told):
            fail(f"{tag}: path lines {told}")
        entry = bst._cache[id(d)]
        if entry.rank_pad_prep is not None:
            fail(f"{tag}: a padded entry under XGBTPU_RANK_PAD=0")
        score = ndcg_of(bst, d)
        # a booster of its own on the same matrix (its cuts are shared)
        padded = xt.train({**params, "rank_impl": "device", "silent": 1},
                          d, rounds, device=device)
        if padded._cache[id(d)].rank_pad_prep is None:
            fail(f"{tag}: the padded reference run is not padded")
        ref = ndcg_of(padded, d)
        tol = RANK_SORT_TOL if impl == "device" else RANK_HOST_TOL
        print(f"[rank-sort] {tag}: training NDCG {score:.6f}, the padded "
              f"layout's {ref:.6f} (tolerance {tol})", flush=True)
        if not abs(score - ref) <= tol:
            fail(f"{tag}: NDCG {score} vs padded {ref}")
        bst._sync_margin(entry)
        margin = entry.margin
        grad_ms = cuda_ms(torch, lambda: bst.obj.get_gradient(
            margin, d.info, rounds), 3 if impl == "host" else 20)
        if impl == "device":
            prep = bst.obj._prep(d.info, n, margin.device)
            cpu_prep = rd.RankPrep(*(x.cpu() for x in prep))
            key = bst.obj.round_key(rounds)
            if not torch.equal(rd.sort_partners(key, 0, prep).cpu(),
                               rd.sort_partners(key, 0, cpu_prep)):
                fail(f"{tag}: the card's partners != the CPU's")
            print(f"[rank-sort] {tag}: partner rows of round {rounds} "
                  "bitwise == the CPU's", flush=True)
        print(f"[rank-sort] {tag}: {ms:.3f} ms per round, gradient "
              f"{grad_ms:.4f} ms a call | {card}", flush=True)
        rows.append((tag, ms, grad_ms))
    return launches, rows


def logistic_fobj(preds, dtrain):
    """binary logistic loss on margins, float64 numpy on the host."""
    p = 1.0 / (1.0 + np.exp(-preds.astype(np.float64)))
    y = dtrain.get_label()
    return p - y, p * (1.0 - p)


def phase_api(torch, xt, kernels, device, card, rank_out):
    """train(obj=), boost(), cv() and the ranking metrics of eval_set."""
    t_phase = time.perf_counter()
    X, y = make_higgs_like(API_N + API_TEST, seed=77)
    dtrain = xt.DMatrix(X[:API_N], label=y[:API_N])
    dtest = xt.DMatrix(X[API_N:], label=y[API_N:])

    reset_counts(kernels)
    t0 = time.perf_counter()
    custom = xt.train({**API_PARAMS, "objective": "binary:logitraw"},
                      dtrain, API_ROUNDS, obj=logistic_fobj, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts(kernels)
    launches = counts["hist_level"]
    print(f"[api] train(obj=) {API_ROUNDS} rounds: {secs:.2f} s; "
          f"hist_level launches {launches}; all counts "
          f"{json.dumps(counts)}", flush=True)
    if counts != only(kernels, hist_level=API_ROUNDS * DEPTH):
        fail(f"[api] custom objective: launch counts {counts}")
    builtin = xt.train({**API_PARAMS, "objective": "binary:logistic"},
                       dtrain, API_ROUNDS, device=device)
    a_custom = auc_of(xt, custom, dtest, y[API_N:])
    a_builtin = auc_of(xt, builtin, dtest, y[API_N:])
    print(f"[api] holdout AUC: custom logistic objective {a_custom:.6f}, "
          f"binary:logistic {a_builtin:.6f}", flush=True)
    if not abs(a_custom - a_builtin) <= 0.005:
        fail(f"[api] custom-objective AUC {a_custom} vs {a_builtin}")

    # boost() with the built-in gradient pulled to the host == update()
    params = {**API_PARAMS, "objective": "binary:logistic"}
    b1 = xt.Booster(params, cache=[dtrain], device=device)
    b2 = xt.Booster(params, cache=[dtrain], device=device)
    for i in range(API_ROUNDS):
        b1.update(dtrain, i)
        b2._lazy_init(dtrain)
        e = b2._entry(dtrain)
        b2._sync_margin(e)
        gh = b2.obj.get_gradient(e.margin, dtrain.info, i).cpu().numpy()
        b2.boost(dtrain, gh[:, 0, 0], gh[:, 0, 1])
    if b1.save_raw() != b2.save_raw():
        fail("[api] boost() from the host gradient != update()")
    print("[api] boost() with the built-in gradient pulled to the host: "
          "identical model bytes to update()", flush=True)

    # cv on the card against cv on the CPU: int8 sums and a host
    # objective keep both bitwise
    cv_params = {**API_PARAMS, "objective": "binary:logitraw",
                 "hist_precision": "int8", "hist_bin_align": 32}
    cv_kw = {"nfold": 3, "metrics": ["auc", "ams@0.15", "pratio@0.1"],
             "obj": logistic_fobj, "seed": 0}
    import contextlib
    import io
    out = io.StringIO()
    reset_counts(kernels)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        lines = xt.cv(cv_params, dtrain, API_ROUNDS, device=device, **cv_kw)
    cv_secs = time.perf_counter() - t0
    cv_counts = read_counts(kernels)
    sys.stdout.write(out.getvalue())
    if out.getvalue().splitlines() != lines or len(lines) != API_ROUNDS:
        fail("[api] cv printed other lines than it returned")
    if cv_counts != only(kernels, hist_level=3 * API_ROUNDS * DEPTH):
        fail(f"[api] cv launch counts {cv_counts}")
    launches += cv_counts["hist_level"]
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_lines = xt.cv(cv_params, xt.DMatrix(X[:API_N], label=y[:API_N]),
                          API_ROUNDS, device="cpu", **cv_kw)
    if lines != cpu_lines:
        fail(f"[api] cv lines on the card != on the CPU: {lines} vs "
             f"{cpu_lines}")
    print(f"[api] cv: 3 folds x {API_ROUNDS} rounds {cv_secs:.2f} s, "
          f"hist_level launches {cv_counts['hist_level']}; lines == the "
          "CPU's", flush=True)

    # the ranking metrics of eval_set on [rank]'s padded entry
    from xgboost_tpu_torch import metrics as M
    bst, d, _ = rank_out
    names = ["ndcg@10", "map@10", "pre@10"]
    for name in names:
        bst.set_param("eval_metric", name)
    line = bst.eval_set([(d, "train")], RANK_ROUNDS - 1)
    p = bst.predict(d)
    want = "\t".join([f"[{RANK_ROUNDS - 1}]"] + [
        f"train-{n}:{M.create_metric(n)(p, d.get_label(), d.get_weight(), d.info.group_ptr):.6f}"
        for n in names])
    print(f"[api] eval_set on the padded entry: {line!r}", flush=True)
    if line != want:
        fail(f"[api] eval_set {line!r} != the metrics of predict {want!r}")
    print(f"[api] == the metric functions on the host copy of predict; "
          f"hist_level launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


ONEHOT_SOURCES = {
    "onehot_variant": ("xgboost_tpu_torch/csrc/onehot_variant.cu",
                       "tools/hist_microbench.py:26"),
    "onehot_i8": ("xgboost_tpu_torch/csrc/onehot_i8.cu",
                  "tools/hist_int8_proto.py:31"),
    "onehot_notrans": ("xgboost_tpu_torch/csrc/onehot_notrans.cu",
                       "tools/hist_notrans_proto.py:28"),
    "onehot_r5": ("xgboost_tpu_torch/csrc/onehot_r5.cu",
                  "tools/hist_r5_ab.py:41"),
    "onehot_group": ("xgboost_tpu_torch/csrc/onehot_group.cu",
                     "tools/hist_group_proto.py:23"),
    "onehot_pack2": ("xgboost_tpu_torch/csrc/onehot_pack2.cu",
                     "tools/hist_pack2_proto.py:29"),
    "onehot_onebig": ("xgboost_tpu_torch/csrc/onehot_pack2.cu",
                      "tools/hist_pack2_proto.py:143"),
    "onehot_r4": ("xgboost_tpu_torch/csrc/onehot_r4.cu",
                  "tools/hist_r4_ab.py:35"),
}
# H100 SXM dense tensor-core peaks (NVIDIA data sheet): the one-hot
# product's floor, printed beside the function's bound
PEAK_INT8_OPS_S = 1979e12
PEAK_BF16_OPS_S = 989e12
# launches of each kernel by the four ported mains at their defaults:
# a warm-up and the timed calls per level or variant, plus T3's and T2's
# accuracy launch; K1 timed beside them
ONEHOT_MAIN_LAUNCHES = {
    "onehot_variant": 6 * 21, "onehot_i8": 6 * 201 + 1,
    "onehot_notrans": 6 * 201 + 1, "onehot_r5": 6 * 41 + 21,
    "hist_level": 21 + 6 * 201 + 6 * 201 + 3 * 41}
# launches by the bf16 mains at their defaults (T1: 20 calls after a
# warm-up for each of 4 x 3 (fg, r_tile) and one accuracy launch; T4a:
# 30 + 1 for prod and pack2 at 6 levels, and one of each for the M = 32
# match; T4b: 30 + 1 at 6 levels x 2 r_tiles, and its match against one
# prod; T6: 30 + 1 for 6 variants); K1 timed beside them (T1: and its
# fp32 accuracy reference)
ONEHOT_BF16_MAIN_LAUNCHES = {
    "onehot_group": 12 * 21 + 1, "onehot_pack2": 6 * 2 * 31 + 2 + 1,
    "onehot_onebig": 6 * 2 * 31 + 1, "onehot_r4": 6 * 31,
    "hist_level": 1 + 21 + 6 * 31 + 6 * 31 + 31}
# the mains' row count (bench.py's Higgs size)
OH_N = 1_000_000
T5_CHECK_KW = [dict(precision="bf16"),
               dict(precision="bf16", hot_dtype="bfloat16",
                    bin_dtype="int16"),
               dict(precision="fp32"),
               dict(precision="fp32", bin_dtype="int16", r_tile=2048)]


def onehot_int_case(torch, oh, cuda_hist, kernel, n, F, B, M, seed, dev,
                    n_levels=1, mode="prod", r_tile=2048):
    """One int comparison (T3, T2 or T7) on the same CUDA tensors: the
    kernel against its plain version, bitwise, on gh beyond the int8 range
    (wrapped) and a row count past the last whole tile (dropped); T7 with
    pad rows (pos -1, random gh) past the 97% real ones; T3 and T2 at
    ``r_tile`` with 2% of the bins out of range (T3: -1, 256, 1000, B,
    255; T2: B, 255), which add nothing to their feature.  Then, on whole
    tiles, in-range bins and gh in the int8 range, the kernel (one level)
    re-laid to (F, B, 2, M) against a K1 int launch, bitwise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    fr = kernel != "onehot_notrans"
    dt = torch.int32 if kernel == "onehot_i8" else torch.uint8
    bins = torch.randint(0, B, (F, n) if fr else (n, F), generator=g,
                         device=dev, dtype=torch.int32).to(dt)
    planted = bins
    if kernel != "onehot_r5":
        bad = torch.tensor([-1, 256, 1000, B, 255] if fr else [B, 255],
                           device=dev)
        hit = torch.rand(bins.shape, generator=g, device=dev) < 0.02
        pick = torch.randint(0, len(bad), bins.shape, generator=g,
                             device=dev)
        planted = torch.where(hit, bad[pick].to(torch.int32),
                              bins.to(torch.int32)).to(dt)
    pos = torch.randint(0, M, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    if kernel == "onehot_r5":
        pos[int(n * 0.97):] = -1
    else:
        pos[torch.rand(n, generator=g, device=dev) < 0.2] = -1
    gh = torch.randint(-300, 300, (n, 2), generator=g, device=dev,
                       dtype=torch.int32)

    def call(fn, b, p, q):
        if kernel == "onehot_r5":
            return fn(b, p[None, :], q.t().contiguous(), B, n_levels, mode)
        return fn(b, p[:, None], q, M, B, r_tile)
    tag = (f"{kernel} N={n} F={F} B={B} M={M} levels={n_levels} "
           f"mode={mode} r_tile={r_tile}")
    got = call(getattr(oh, kernel), planted, pos, gh)
    want = call(getattr(oh, kernel + "_plain"), planted, pos, gh)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        fail(f"{tag}: not bitwise equal to the plain version")
    if n_levels > 1:
        return
    if kernel == "onehot_r5":
        r_tile = oh.R5_R_TILE
    n_used = (n // r_tile) * r_tile
    bins_w = (bins[:, :n_used] if fr else bins[:n_used]).contiguous()
    pos_w = pos[:n_used].contiguous()
    gh8 = gh[:n_used].clamp(-127, 127).contiguous()
    got = call(getattr(oh, kernel), bins_w, pos_w, gh8)
    k1 = cuda_hist.level_histogram(
        (bins_w.t() if fr else bins_w).contiguous().to(torch.uint8), gh8,
        pos_w, M, B, "int")
    torch.cuda.synchronize()
    if not torch.equal(got[0].reshape(F, B, 2, M), k1):
        fail(f"{tag}: differs from a K1 int launch on the same inputs")


def onehot_variant_case(torch, oh, n, F, B, n_node, kw, seed, dev):
    """One T5 comparison on the same CUDA tensors: bitwise on gh exact in
    bf16 (multiples of 1/64 below 2: f32 sums exact in any order), within
    2 n 2^-24 sum|x| on random gh.  Returns max |kernel - plain|."""
    kw = {k: getattr(torch, v) if k.endswith("dtype") else v
          for k, v in kw.items()}
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (n, F), generator=g, device=dev,
                         dtype=torch.int32)
    pos = torch.randint(-1, n_node + 10, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    tag = f"onehot_variant N={n} F={F} B={B} n_node={n_node} {kw}"
    dy = torch.randint(-128, 128, (n, 2), generator=g, device=dev,
                       dtype=torch.int32).to(torch.float32) / 64.0
    got = oh.onehot_variant(bins, dy, pos, n_node, B, **kw)
    want = oh.onehot_variant_plain(bins, dy, pos, n_node, B, **kw)
    torch.cuda.synchronize()
    if got.shape != (n_node, F, B, 2) or not torch.equal(got, want):
        fail(f"{tag}: not bitwise equal to the plain version on gh exact "
             "in bf16")
    gh = torch.randn(n, 2, generator=g, device=dev)
    got = oh.onehot_variant(bins, gh, pos, n_node, B, **kw)
    want = oh.onehot_variant_plain(bins, gh, pos, n_node, B, **kw)
    src = gh.to(torch.bfloat16).float() if oh._variant_rounds(
        kw.get("precision", "bf16"), kw.get("hot_dtype", torch.float32)) \
        else gh
    cnt = oh.onehot_variant_plain(bins, torch.ones_like(gh), pos, n_node, B,
                                  "fp32")
    a = oh.onehot_variant_plain(bins, src.abs(), pos, n_node, B, "fp32")
    if not sum_bound_ok(torch, got, want, cnt, a):
        fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x| on random gh")
    return float((got - want).abs().max())


def sass_check(nvcc, name, tag, gmma="HGMMA", mma="HMMA"):
    """The built library of ``csrc/<name>.cu`` runs wgmma: its SASS
    holds ``gmma`` instructions (HGMMA for bf16, IGMMA for s8) and no
    mma.sync ones (``mma``: HMMA, IMMA)."""
    built, = nvcc.build([name])
    cuobjdump = os.path.join(os.path.dirname(nvcc.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(built.path)],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        fail(f"{tag} cuobjdump -sass {built.path.name}: {sass.stderr[-500:]}")
    n_gmma = sass.stdout.count(gmma)
    n_mma = sass.stdout.count(mma)
    if n_gmma == 0 or n_mma:
        fail(f"{tag} {name}: {n_gmma} {gmma} and {n_mma} {mma} instructions "
             f"in its SASS; the wgmma kernel has {gmma} only")
    print(f"{tag} {name}: SASS holds {n_gmma} {gmma} instructions, no "
          f"{mma}", flush=True)


def phase_onehot_checks(torch, oh, cuda_hist, nvcc, dev):
    """Each one-hot kernel against its plain version in every mode, at
    the mains' shapes and beyond (T3 and T2 at every N of their small-N
    form, above 32 nodes, in two node tiles, at B = 1, 8, 255 on five
    features, F = 3 and r_tile = 1000; T7 at B = 1, 8, 255, five features
    and 2, 6 and 8 levels); each int kernel against K1; T5's library
    holds bf16 wgmma (HGMMA) and no mma.sync, T7's, T3's and T2's integer
    wgmma (IGMMA) and no integer mma.sync (IMMA)."""
    n_pad = -(-OH_N // 8192) * 8192     # the T3 and T2 mains' rows
    n_r5 = -(-OH_N // 2048) * 2048      # the T7 main's rows
    n_odd = 2048 * 50 + 333             # a dropped tail
    # (n, F, B, M, r_tile): the mains' M = 1, 4, 32, then M = 2, 3, 5, 8,
    # 16 (N = 8-64), 33 (N = 128), 100 (two node tiles), B = 1, 8, 255 on
    # five features, F = 3 (T2 a byte a load) and r_tile = 1000
    int_cases = ([(n_pad, 28, 64, m, 2048) for m in (1, 4, 32)]
                 + [(n_odd, 28, 64, m, 2048) for m in (2, 3, 5, 8, 16, 33)]
                 + [(2048 * 20 + 100, 28, 64, 100, 2048),
                    (n_odd, 28, 67, 8, 2048), (n_odd, 5, 1, 4, 2048),
                    (n_odd, 5, 8, 16, 2048), (n_odd, 5, 255, 4, 2048),
                    (5000, 3, 7, 3, 2048), (20001, 3, 64, 32, 2048),
                    (n_odd, 28, 64, 8, 1000)])
    for kernel in ("onehot_i8", "onehot_notrans"):
        for n, F, B, M, r_tile in int_cases:
            onehot_int_case(torch, oh, cuda_hist, kernel, n, F, B, M,
                            seed=n % 97 + M + B, dev=dev, r_tile=r_tile)
            print(f"[onehot] {kernel} N={n} F={F} B={B} M={M} r_tile="
                  f"{r_tile}: bitwise == plain (int8 wrap, dropped tail, "
                  "bins out of range), == K1 int", flush=True)
    for mode in ("prod", "u8cmp"):
        # then the odd shapes: B = 1, 8, 255 on five features, and level
        # groups of 2 and 4 (2 and 8 levels)
        for n, F, B, nl in [(n_r5, 28, 67, 1), (n_r5, 28, 64, 1),
                            (n_r5, 28, 32, 1), (n_r5, 28, 64, 6),
                            (2048 * 20 + 100, 28, 67, 8),
                            (2048 * 50 + 333, 5, 1, 1),
                            (2048 * 50 + 333, 5, 8, 1),
                            (2048 * 50 + 333, 5, 255, 1),
                            (2048 * 20 + 100, 28, 64, 2),
                            (2048 * 20 + 100, 5, 255, 8)]:
            onehot_int_case(torch, oh, cuda_hist, "onehot_r5", n, F, B, 64,
                            seed=B + nl + F, dev=dev, n_levels=nl, mode=mode)
            print(f"[onehot] onehot_r5 {mode} N={n} F={F} B={B} levels={nl}:"
                  " bitwise == plain (pad rows, floor-mod)"
                  + (", == K1 int" if nl == 1 else ""), flush=True)
    sass_check(nvcc, "onehot_variant", "[onehot]")
    sass_check(nvcc, "onehot_r5", "[onehot]", "IGMMA", "IMMA")
    sass_check(nvcc, "onehot_i8", "[onehot]", "IGMMA", "IMMA")
    sass_check(nvcc, "onehot_notrans", "[onehot]", "IGMMA", "IMMA")
    err = 0.0
    # then F Bp not a multiple of 64, rows not a multiple of the row step,
    # one node
    for n, F, B, n_node in [(OH_N, 28, 67, 5), (OH_N, 28, 67, 64),
                            (OH_N, 28, 67, 128), (3000, 3, 7, 3),
                            (OH_N + 37, 5, 67, 1), (OH_N + 37, 5, 67, 70)]:
        for kw in T5_CHECK_KW:
            err = max(err, onehot_variant_case(torch, oh, n, F, B, n_node,
                                               kw, seed=n_node, dev=dev))
        print(f"[onehot] onehot_variant N={n} F={F} B={B} n_node={n_node}: "
              "bf16 / fp32 (int32 and int16 bins) bitwise on bf16-exact gh, "
              "within bound on random gh", flush=True)
    print(f"[onehot] onehot_variant max |kernel - plain| on random gh: "
          f"{err}", flush=True)
    return {"onehot_variant": err, "onehot_i8": 0.0, "onehot_notrans": 0.0,
            "onehot_r5": 0.0}


def bf16_fr_inputs(torch, n, F, B, M, seed, dev, planted=None):
    """T4 / T6 inputs on the card: feature-major int32 bins (2% past B: in
    [B, 255), or drawn from ``planted``), pos over [-1, M + 6), gh exact
    in bf16 (multiples of 1/64 below 2: f32 sums exact in any order) and
    random."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (F, n), generator=g, device=dev,
                         dtype=torch.int32)
    bad = torch.rand(F, n, generator=g, device=dev) < 0.02
    if planted is None:
        bins[bad] = torch.randint(B, 255, (int(bad.sum()),), generator=g,
                                  device=dev, dtype=torch.int32)
    else:
        vals = torch.tensor(planted, device=dev, dtype=torch.int32)
        bins[bad] = vals[torch.randint(0, len(planted), (int(bad.sum()),),
                                       generator=g, device=dev)]
    pos = torch.randint(-1, M + 6, (n, 1), generator=g, device=dev,
                        dtype=torch.int32)
    dy = torch.randint(-128, 128, (n, 2), generator=g, device=dev,
                       dtype=torch.int32).float() / 64.0
    gh = torch.randn(n, 2, generator=g, device=dev)
    return bins, pos, dy, gh


def bf16_case(torch, oh, kernel, args_of, kw, dy, gh, tag):
    """One bf16 kernel against its plain version on the same CUDA
    tensors: bitwise on ``dy`` (exact in bf16), within 2 n 2^-24 sum|x|
    on ``gh``.  ``args_of(g)`` are the call's arguments with gh = g.
    Returns (max |kernel - plain| on gh, the kernel's result on dy)."""
    fn, plain = getattr(oh, kernel), getattr(oh, kernel + "_plain")
    got_dy = fn(*args_of(dy), **kw)
    want = plain(*args_of(dy), **kw)
    torch.cuda.synchronize()
    if not torch.equal(got_dy, want):
        fail(f"{tag}: not bitwise equal to the plain version on gh exact "
             "in bf16")
    args = args_of(gh)
    got, want = fn(*args, **kw), plain(*args, **kw)
    if not onehot_bound_ok(torch, plain, args, kw, got, want,
                           GH_ARG[kernel]):
        fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x| on random gh")
    return float((got - want).abs().max()), got_dy


def phase_onehot_bf16_checks(torch, oh, nvcc, dev):
    """T1, T4a, T4b and T6 against their plain versions at the mains'
    shapes and beyond: T4 and T6 with a dropped tail and bins past B, T4b
    and T6's u8bins and i16hot equal to prod bitwise on bf16-exact gh, T4
    at F = 5 and 6, B = 1, 8, 255, M = 3, 5, 33, 100 and r_tile = 1000 and
    300,
    T1 at several node counts (70: two node tiles, the second partial),
    every fg and r_tile of its main, F Bp not a multiple of 64, rows not a
    multiple of the row step, one node, and a planted out-of-range bin
    that leaves its row in the group's other features; T6 in every mode
    on rows that are not a multiple of its row step (r_tile = 1000) and
    F Bp not a multiple of 64; T1's, T6's and T4's libraries hold wgmma
    (HGMMA) and no mma.sync."""
    errs = {k: 0.0 for k in ("onehot_group", "onehot_pack2",
                             "onehot_onebig", "onehot_r4")}
    n = -(-OH_N // 8192) * 8192 + 333    # the mains' rows and a tail
    F, B = 28, 64
    for M in (1, 4, 32):
        bins, pos, dy, gh = bf16_fr_inputs(torch, n, F, B, M, M, dev)

        def fr(g):
            return bins, pos, g, M
        prod = None
        for kernel, kw in [("onehot_pack2", dict(mode="prod")),
                           ("onehot_pack2", dict(mode="pack2")),
                           ("onehot_onebig", {}),
                           ("onehot_onebig", dict(r_tile=1024))]:
            tag = f"[onehot-bf16] {kernel} N={n} M={M} {kw}"
            err, got = bf16_case(torch, oh, kernel, fr, dict(n_bin=B, **kw),
                                 dy, gh, tag)
            errs[kernel] = max(errs[kernel], err)
            if kw.get("mode") == "prod":
                prod = got
            elif kernel == "onehot_onebig" and not kw and \
                    not torch.equal(got, prod):
                fail(f"{tag}: onebig != prod on gh exact in bf16")
        print(f"[onehot-bf16] onehot_pack2 prod / pack2, onehot_onebig "
              f"N={n} M={M}: bitwise == plain on bf16-exact gh (dropped "
              "tail, bins past B, pos past M), onebig == prod; within "
              "bound on random gh", flush=True)
    bins, pos, dy, gh = bf16_fr_inputs(torch, n, F, B, 64, 64, dev)
    b8 = bins.to(torch.uint8)
    prod = {}
    for mode, r_tile in [("prod", 1024), ("prod", 2048), ("prod", 4096),
                         ("dotfloor", 2048), ("u8bins", 2048),
                         ("i16hot", 2048)]:
        bt = b8 if mode == "u8bins" else bins
        tag = f"[onehot-bf16] onehot_r4 {mode} r_tile={r_tile} N={n}"
        err, got = bf16_case(torch, oh, "onehot_r4",
                             lambda g: (bt, pos, g),
                             dict(mode=mode, r_tile=r_tile, n_bin=B), dy,
                             gh, tag)
        errs["onehot_r4"] = max(errs["onehot_r4"], err)
        if mode == "prod":
            prod[r_tile] = got
        elif mode != "dotfloor" and not torch.equal(got, prod[r_tile]):
            fail(f"{tag}: != prod on gh exact in bf16")
    print(f"[onehot-bf16] onehot_r4 N={n}: prod (r_tile 1024, 2048, 4096), "
          "dotfloor, u8bins, i16hot bitwise == plain on bf16-exact gh, "
          "u8bins == i16hot == prod; within bound on random gh", flush=True)
    # T6 where the wgmma kernel's tiling is odd: rows not a multiple of
    # its 256-row step (r_tile = 1000), F Bp not a multiple of 64
    for n, F, B, r_tile in [(OH_N + 37, 28, 64, 1000),
                            (OH_N + 37, 5, 67, 1000),
                            (OH_N + 37, 5, 67, 2048)]:
        bins, pos, dy, gh = bf16_fr_inputs(torch, n, F, B, 64, F + r_tile,
                                           dev)
        b8 = bins.to(torch.uint8)
        for mode in oh.R4_MODES:
            bt = b8 if mode == "u8bins" else bins
            tag = (f"[onehot-bf16] onehot_r4 {mode} r_tile={r_tile} N={n} "
                   f"F={F} B={B}")
            err, _ = bf16_case(torch, oh, "onehot_r4",
                               lambda g: (bt, pos, g),
                               dict(mode=mode, r_tile=r_tile, n_bin=B), dy,
                               gh, tag)
            errs["onehot_r4"] = max(errs["onehot_r4"], err)
        print(f"[onehot-bf16] onehot_r4 N={n} F={F} B={B} r_tile={r_tile}: "
              "every mode bitwise == plain on bf16-exact gh, within bound "
              "on random gh", flush=True)
    # T4 where the small-N form's tiling is odd: F = 5 (prod, onebig) and
    # 6 (pack2), B = 1, 8, 255 (Bp 16, 16, 256), M = 3, 5 (N = 8, 16), 33
    # (N = 128) and 100 (two node tiles), r_tile 1000 and 300 on rows that
    # are not a multiple of the row step, bins -1, 256, 1000, B, 255
    n = OH_N + 37
    for k, (B, M) in enumerate((B, M) for B in (1, 8, 255)
                               for M in (3, 5, 33, 100)):
        r_tile = (1000, 300)[k % 2]
        prod = None
        for kernel, F, kw in [("onehot_pack2", 5, dict(mode="prod")),
                              ("onehot_onebig", 5, {}),
                              ("onehot_pack2", 6, dict(mode="pack2"))]:
            if kernel != "onehot_onebig":
                bins, pos, dy, gh = bf16_fr_inputs(
                    torch, n, F, B, M, 100 * B + M + F, dev,
                    planted=[-1, 256, 1000, B, 255])
            tag = (f"[onehot-bf16] {kernel} N={n} F={F} B={B} M={M} "
                   f"r_tile={r_tile} {kw}")
            err, got = bf16_case(torch, oh, kernel,
                                 lambda g: (bins, pos, g, M),
                                 dict(n_bin=B, r_tile=r_tile, **kw), dy, gh,
                                 tag)
            errs[kernel] = max(errs[kernel], err)
            if kernel == "onehot_onebig" and not torch.equal(got, prod):
                fail(f"{tag}: onebig != prod on gh exact in bf16")
            prod = got
        print(f"[onehot-bf16] onehot_pack2 prod (F=5), onehot_onebig (F=5), "
              f"pack2 (F=6) N={n} B={B} M={M} r_tile={r_tile}: bitwise == "
              "plain on bf16-exact gh (bins -1, 256, 1000, B, 255 planted, "
              "pos past M), onebig == prod; within bound on random gh",
              flush=True)
    sass_check(nvcc, "onehot_group", "[onehot-bf16]")
    sass_check(nvcc, "onehot_r4", "[onehot-bf16]")
    sass_check(nvcc, "onehot_pack2", "[onehot-bf16]")
    g = torch.Generator(device=dev).manual_seed(70)
    B = 67
    # 5 features (F Bp not a multiple of 64) on rows that are not a
    # multiple of the row step, then the main's 28 features and rows
    for n, F, cases in [(OH_N + 37, 5, [(1, 4, 2048), (70, 2, 1024)]),
                        (OH_N, 28, [(3, 2, 2048), (64, 2, 1024),
                                    (64, 4, 2048), (64, 7, 4096),
                                    (64, 14, 2048), (70, 4, 2048),
                                    (70, 14, 1024)])]:
        bins = torch.randint(0, B, (n, F), generator=g, device=dev,
                             dtype=torch.int32)
        dy = torch.randint(-128, 128, (n, 2), generator=g, device=dev,
                           dtype=torch.int32).float() / 64.0
        gh = torch.randn(n, 2, generator=g, device=dev)
        for n_node, fg, r_tile in cases:
            pos = torch.randint(-1, n_node + 10, (n,), generator=g,
                                device=dev, dtype=torch.int32)
            tag = (f"[onehot-bf16] onehot_group N={n} F={F} n_node={n_node}"
                   f" fg={fg} r_tile={r_tile}")
            err, _ = bf16_case(torch, oh, "onehot_group",
                               lambda x: (bins, x, pos, n_node, B),
                               dict(fg=fg, r_tile=r_tile), dy, gh, tag)
            errs["onehot_group"] = max(errs["onehot_group"], err)
            print(f"{tag}: bitwise == plain on bf16-exact gh, within bound "
                  "on random gh", flush=True)
    # a bin of -1 or 1000 in one feature drops that (row, feature) alone
    planted = bins.clone()
    planted[::7, 1] = -1
    planted[::5, 2] = 1000
    pos = torch.randint(0, 64, (OH_N,), generator=g, device=dev,
                        dtype=torch.int32)
    got = oh.onehot_group(planted, dy, pos, 64, B, 4)
    clean = oh.onehot_group(bins, dy, pos, 64, B, 4)
    want = oh.onehot_group_plain(planted, dy, pos, 64, B)
    torch.cuda.synchronize()
    keep = [f for f in range(F) if f not in (1, 2)]
    if not torch.equal(got, want) or \
            not torch.equal(got[:, keep], clean[:, keep]):
        fail("[onehot-bf16] onehot_group fg=4 with out-of-range bins in "
             "features 1 and 2: != plain, or their rows lost from the "
             "group's other features")
    print("[onehot-bf16] onehot_group fg=4, bins -1 and 1000 planted in "
          "features 1 and 2: == plain, the other features equal a clean "
          "run's", flush=True)
    return errs


def wgmma_cols(B, n_node):
    """Bp x N of T5's and T1's wgmma product a row and feature: B rounded
    up to 8 (the M rows of a feature), times 2 m_pad rounded up to 8 in
    each node tile (the N it needs)."""
    m_pad = min(n_node, 64)
    return -(-B // 8) * 8 * -(-n_node // m_pad) * (-(-2 * m_pad // 8) * 8)


def onehot_work(torch, oh, kernel, args, kw):
    """(cells, bytes, additions, tensor-core ms) of one call: the flat
    index and values of one ``index_add_`` computing the same sums
    (inactive entries at the dump cell), the bytes the function must move
    (each input read once, the output written once), its additions, and
    the one-hot product's floor at the dense tensor-core rate."""
    if kernel == "onehot_variant":
        binned, gh, pos, n_node, B = args
        cells_kw = {k: v for k, v in kw.items() if k != "r_tile"}
        idx, src, n_cells = oh.variant_cells(binned, gh, pos, n_node, B,
                                             **cells_kw)
        N, F = binned.shape
        bin_bytes = 2 if kw.get("bin_dtype") == torch.int16 else 4
        active = int(((pos >= 0) & (pos < n_node)).sum())
        nbytes = N * F * bin_bytes + 4 * N + 8 * active + n_cells * 4
        split = 3 if kw.get("precision") == "fp32" \
            and kw.get("hot_dtype", torch.float32) == torch.float32 else 1
        tc = 2 * N * F * wgmma_cols(B, n_node) * split / PEAK_BF16_OPS_S
        return (idx, src, n_cells), nbytes, active * F * 2, tc * 1e3
    if kernel == "onehot_group":
        binned, gh, pos, n_node, B = args
        idx, src, n_cells = oh.variant_cells(binned, gh, pos, n_node, B,
                                             "bf16")
        N, F = binned.shape
        active = int(((pos >= 0) & (pos < n_node)).sum())
        nbytes = N * F * 4 + 4 * N + 8 * active + n_cells * 4
        tc = 2 * N * F * wgmma_cols(B, n_node) / PEAK_BF16_OPS_S
        return (idx, src, n_cells), nbytes, active * F * 2, tc * 1e3
    if kernel in ("onehot_pack2", "onehot_onebig", "onehot_r4"):
        if kernel == "onehot_r4":
            (bt, pos, gh), M = args, oh.M_TILE
        else:
            bt, pos, gh, M = args
        B, r_tile = kw["n_bin"], kw.get("r_tile", 2048)
        F, n = bt.shape
        n_used = (n // r_tile) * r_tile
        p = pos.reshape(-1)[:n_used]
        floor = kw.get("mode") == "dotfloor"
        # dotfloor: every row's gh lands in bin 0 of each feature
        b = torch.zeros_like(bt[:, :n_used]) if floor else bt[:, :n_used]
        idx, src, n_cells = oh.proto_cells(
            b, p, gh[:n_used].to(torch.bfloat16).float(), B, M)
        active = int(((p >= 0) & (p < M)).sum())
        bin_bytes = 0 if floor else bt.element_size()
        nbytes = n_used * F * bin_bytes + 4 * n_used + 8 * active \
            + n_cells * 4
        tc = 2 * n_used * F * (-(-B // 16) * 16) * (-(-2 * M // 8) * 8) \
            / PEAK_BF16_OPS_S
        return (idx, src, n_cells), nbytes, active * F * 2, tc * 1e3
    if kernel == "onehot_r5":
        bt, pos, gh, B = args
        nl = kw["n_levels"]
        F, n = bt.shape
        n_used = (n // oh.R5_R_TILE) * oh.R5_R_TILE
        q = oh._wrap_i8(gh[:, :n_used].t()).to(torch.int32)
        idxs, srcs, active = [], [], 0
        for lv in range(nl):
            node = oh.r5_nodes(pos[0, :n_used], lv, nl)
            idx, src, n_cells = oh.proto_cells(bt[:, :n_used], node, q, B,
                                               oh.M_TILE)
            idxs.append(torch.where(idx == n_cells, nl * n_cells,
                                    idx + lv * n_cells))
            srcs.append(src)
            active += int(((node >= 0) & (node < oh.M_TILE)).sum())
        n_cells *= nl
        nbytes = n_used * (F + 4) + 8 * (n_used if nl > 1 else active) \
            + n_cells * 4
        tc = 2 * n_used * F * (-(-B // 16) * 16) * 128 * nl / PEAK_INT8_OPS_S
        return ((torch.cat(idxs), torch.cat(srcs), n_cells), nbytes,
                active * F * 2, tc * 1e3)
    binned, pos, gh, M, B = args
    fr = kernel == "onehot_i8"
    n = binned.shape[1] if fr else binned.shape[0]
    F = binned.shape[0] if fr else binned.shape[1]
    n_used = (n // 2048) * 2048
    bins_fr = binned[:, :n_used] if fr else binned[:n_used].t()
    p = pos.reshape(-1)[:n_used]
    q = oh._wrap_i8(gh[:n_used]).to(torch.int32)
    idx, src, n_cells = oh.proto_cells(bins_fr, p, q, B, M)
    active = int(((p >= 0) & (p < M)).sum())
    nbytes = n_used * F * (4 if fr else 1) + 4 * n_used + 8 * active \
        + n_cells * 4
    tc = 2 * n_used * F * (-(-B // 16) * 16) * (-(-2 * M // 8) * 8) \
        / PEAK_INT8_OPS_S
    return (idx, src, n_cells), nbytes, active * F * 2, tc * 1e3


def phase_onehot(torch, oh, cuda_hist, kernels, card, device="cuda"):
    """The four ported int / T5 microbenchmark mains at their full shapes,
    every launch count set to 0 just before and read just after; then each
    main's rows (:func:`time_onehot_rows`)."""
    from xgboost_tpu_torch.tools import (hist_int8_proto, hist_microbench,
                                         hist_notrans_proto, hist_r5_ab)
    reset_counts(kernels)
    t0 = time.perf_counter()
    rows = hist_microbench.main(OH_N, device=device)
    t3_rows, t3_acc = hist_int8_proto.main(OH_N, device=device)
    t2_rows, t2_acc = hist_notrans_proto.main(OH_N, device=device)
    t7_rows = hist_r5_ab.main(OH_N, device=device)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    print(f"[onehot] the four mains: {time.perf_counter() - t0:.1f} s; "
          f"launch counts {json.dumps(counts)} | {card}", flush=True)
    want = only(kernels, **ONEHOT_MAIN_LAUNCHES)
    if counts != want:
        fail(f"[onehot] launch counts {counts}: want {want}")
    if not t2_acc["exact"]:
        fail("[onehot] T2's int32 sums differ from exact float64 sums")
    if not t3_acc["within_bound"]:
        fail("[onehot] T3's dequantized histogram is beyond the rows' "
             "half quantization steps of the float64 sums")
    out = time_onehot_rows(torch, oh, rows + t3_rows + t2_rows + t7_rows,
                           card, "[onehot]")
    print(f"[onehot] production bf16 (K1) in the T5 main: {rows[0]['ms']:.4f}"
          f" ms | {card}", flush=True)
    return counts, out


def phase_onehot_bf16(torch, oh, cuda_hist, kernels, card, device="cuda"):
    """The three bf16 mains (T1; T4a and T4b; T6) at their full shapes,
    every launch count set to 0 just before and read just after; T1's
    accuracy line within bf16's rounding of the f32 sums, T4a's and T4b's
    match checks; then each main's rows (:func:`time_onehot_rows`)."""
    from xgboost_tpu_torch.tools import (hist_group_proto, hist_pack2_proto,
                                         hist_r4_ab)
    reset_counts(kernels)
    t0 = time.perf_counter()
    t1_rows, t1_acc = hist_group_proto.main(OH_N, device=device)
    t4_rows, t4_chk = hist_pack2_proto.main(OH_N, device=device)
    t4b_rows, t4b_chk = hist_pack2_proto.main_onebig(OH_N, device=device)
    t6_rows = hist_r4_ab.main(OH_N, device=device)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    print(f"[onehot-bf16] the three mains: {time.perf_counter() - t0:.1f} s;"
          f" launch counts {json.dumps(counts)} | {card}", flush=True)
    want = only(kernels, **ONEHOT_BF16_MAIN_LAUNCHES)
    if counts != want:
        fail(f"[onehot-bf16] launch counts {counts}: want {want}")
    if not (t4_chk["match"] and t4b_chk["match"]):
        fail(f"[onehot-bf16] match checks at M = 32: pack2 "
             f"{t4_chk['match']}, onebig {t4b_chk['match']}")
    # T1's accuracy line: bf16 rounding (8 significant bits) moves each
    # row's gh by at most 2^-8 of it, and two f32 orders add
    # 2 n 2^-24 sum|x|
    binned, gh, pos, n_node, B = t1_acc["args"]
    a = oh.onehot_variant_plain(binned, gh.abs(), pos, n_node, B, "fp32")
    cnt = oh.onehot_variant_plain(binned, torch.ones_like(gh), pos, n_node,
                                  B, "fp32")
    diff = (t1_acc["got"] - t1_acc["ref"]).abs()
    if bool((diff > a * (2.0 ** -8 + 2.0 * cnt * 2.0 ** -24)).any()):
        fail(f"[onehot-bf16] T1's accuracy line {t1_acc['err']}: beyond "
             "bf16's rounding of the f32 sums")
    print(f"[onehot-bf16] T1 accuracy line (4,096 rows, fg=4 against K1 "
          f"fp32): max err {t1_acc['err']}, within 2^-8 sum|g| + 2 n 2^-24 "
          f"sum|g| of every cell; T4a pack2 and T4b onebig match prod at "
          f"M = 32", flush=True)
    out = time_onehot_rows(torch, oh, t1_rows + t4_rows + t4b_rows + t6_rows,
                           card, "[onehot-bf16]")
    print(f"[onehot-bf16] production bf16 (K1) in the T1 main: "
          f"{t1_rows[0]['ms']:.4f} ms | {card}", flush=True)
    return counts, out


def onehot_bound_ok(torch, plain, args, kw, got, want, gh_at):
    """The kernel's float sums within 2 n 2^-24 sum|x| of the plain
    version's (``gh_at``: the index of gh in ``args``)."""
    gh = args[gh_at]

    def with_gh(g):
        return plain(*args[:gh_at], g, *args[gh_at + 1:], **kw)
    cnt = with_gh(torch.ones_like(gh))
    a = with_gh(gh.to(torch.bfloat16).float().abs())
    return sum_bound_ok(torch, got, want, cnt, a)


# where gh sits in each float one-hot kernel's arguments
GH_ARG = {"onehot_group": 1, "onehot_pack2": 2, "onehot_onebig": 2,
          "onehot_r4": 2}


def time_onehot_rows(torch, oh, rows, card, tag):
    """Each row of the mains: the kernel against its plain version on the
    main's inputs (int bitwise; float within the f32 summation bound),
    and beside its time the bound, the tensor-core floor, the plain
    version's time and one ``index_add_``'s.  Returns the rows by
    kernel."""
    out = {}
    for row in rows:
        kernel = row["kernel"]
        if kernel == "hist_level":
            continue
        fn = getattr(oh, kernel)
        plain = getattr(oh, kernel + "_plain")
        args, kw = row["args"], row["kw"]
        got, want_h = fn(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if kernel == "onehot_variant":
            if not torch.equal(got, want_h):
                # float sums in another order: the bound of [K1]
                binned, gh, pos, n_node, B = args
                src = gh.to(torch.bfloat16).float() if oh._variant_rounds(
                    kw.get("precision", "bf16"),
                    kw.get("hot_dtype", torch.float32)) else gh
                cnt = oh.onehot_variant_plain(binned, torch.ones_like(gh),
                                              pos, n_node, B, "fp32")
                a = oh.onehot_variant_plain(binned, src.abs(), pos, n_node,
                                            B, "fp32")
                if not sum_bound_ok(torch, got, want_h, cnt, a):
                    fail(f"{tag} {row['name']}: beyond the sum bound")
        elif kernel in GH_ARG:
            if not onehot_bound_ok(torch, plain, args, kw, got, want_h,
                                   GH_ARG[kernel]):
                fail(f"{tag} {row['name']}: beyond the sum bound")
        elif not torch.equal(got, want_h):
            fail(f"{tag} {row['name']}: kernel != plain on the main's "
                 "inputs")
        err = float((got.double() - want_h.double()).abs().max())
        plain_ms = cuda_ms(torch, lambda: plain(*args, **kw), 3)
        (idx, src, n_cells), nbytes, adds, tc_ms = onehot_work(
            torch, oh, kernel, args, kw)
        acc = torch.zeros(n_cells + 1, dtype=src.dtype, device=src.device)
        lib_ms = cuda_ms(torch, lambda: acc.index_add_(0, idx, src), 3)
        del idx, src, acc
        bound_ms, by = bound_of(nbytes, adds)
        out.setdefault(kernel, []).append(dict(
            name=row["name"], ms=row["ms"], k1_ms=row.get("k1_ms"),
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=by, tc_ms=tc_ms, err=err))
        k1 = f"K1 {row['k1_ms']:.4f} ms; " if row.get("k1_ms") else ""
        print(f"{tag} {row['name']} ({kernel}): {row['ms']:.4f} ms ({k1}"
              f"bound {bound_ms:.4f} ms, {by}; tensor-core floor of the "
              f"one-hot product {tc_ms:.4f} ms; plain {plain_ms:.4f} ms; "
              f"index_add_ {lib_ms:.4f} ms) | {card}", flush=True)
    return out


# ------------------------------------------------------------- [linear]
# booster=gblinear on [main]'s data, then on [multiclass]'s
LIN_ROUNDS, LIN_MC_ROUNDS = 10, 5
LIN_PARAMS = {"booster": "gblinear", "objective": "binary:logistic",
              "eta": 0.5, "lambda": 1.0, "alpha": 0.01}
LIN_MC_PARAMS = {**LIN_PARAMS, "objective": "multi:softmax",
                 "num_class": MC_K}
# The JAX package's holdout AUC for LIN_PARAMS on [main]'s rows (10
# rounds) and holdout merror for LIN_MC_PARAMS on [multiclass]'s (5
# rounds), on a CPU; the floor is 0.002 under the AUC, the ceiling 0.005
# over the merror
LIN_AUC_JAX = 0.864947
LIN_MERROR_JAX = 0.109


def phase_linear(torch, xt, kernels, device, card, main_out):
    """gblinear on the card: no histogram kernel, weights and bias
    against the port's CPU run on the same rows, holdout AUC / merror
    against the JAX package's, the model file on the CPU.  Returns the
    ms a round of the Higgs and multiclass runs."""
    from xgboost_tpu_torch.metrics import auc, merror
    X, y = main_out["X"], main_out["y"]
    Xm, ym = make_multiclass(MC_N + MC_TEST)
    runs = (("higgs", LIN_PARAMS, LIN_ROUNDS, X, y, N_TRAIN),
            ("multiclass", LIN_MC_PARAMS, LIN_MC_ROUNDS, Xm, ym, MC_N))
    ms = {}
    for tag, params, rounds, XX, yy, n in runs:
        dtrain = xt.DMatrix(XX[:n], label=yy[:n])
        dtest = xt.DMatrix(XX[n:], label=yy[n:])
        reset_counts(kernels)
        bst = xt.Booster(params, cache=[dtrain], device=device)
        bst.update(dtrain, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst.update_many(dtrain, 1, rounds - 1)
        torch.cuda.synchronize()
        ms[tag] = (time.perf_counter() - t0) * 1e3 / (rounds - 1)
        counts = read_counts(kernels)
        if counts != only(kernels):
            fail(f"[linear] {tag}: a histogram kernel ran: {counts}")
        cpu = xt.train(params, xt.DMatrix(XX[:n], label=yy[:n]), rounds,
                       device="cpu")
        for name in ("weight", "bias"):
            got = getattr(bst.gbtree, name).cpu().numpy()
            want = getattr(cpu.gbtree, name).numpy()
            if not np.allclose(got, want, rtol=1e-4, atol=1e-6):
                fail(f"[linear] {tag}: {name} differs from the CPU run by "
                     f"{np.abs(got - want).max()}")
        if tag == "higgs":
            pred = bst.predict(dtest)
            score = auc(pred, yy[n:], np.ones(len(yy) - n, np.float32))
            floor = LIN_AUC_JAX - 0.002
            print(f"[linear] higgs: holdout AUC {score:.6f} (JAX CPU "
                  f"{LIN_AUC_JAX}, floor {floor:.6f})", flush=True)
            if not score >= floor:
                fail(f"[linear] holdout AUC {score} < {floor}")
        else:
            pred = bst.predict(dtest, output_margin=True)
            err = merror(pred, yy[n:], np.ones(len(yy) - n, np.float32))
            ceil = LIN_MERROR_JAX + 0.005
            print(f"[linear] multiclass: holdout merror {err:.6f} (JAX CPU "
                  f"{LIN_MERROR_JAX}, ceiling {ceil:.6f})", flush=True)
            if not err <= ceil:
                fail(f"[linear] holdout merror {err} > {ceil}")
        path = os.path.join(HERE, ".smoke_out", f"linear_{tag}.bin")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        bst.save_model(path)
        on_cpu = xt.Booster(model_file=path, device="cpu")
        if not (np.array_equal(on_cpu.gbtree.weight.numpy(),
                               bst.gbtree.weight.cpu().numpy())
                and np.allclose(on_cpu.predict(xt.DMatrix(XX[n:]),
                                               output_margin=True),
                                bst.predict(dtest, output_margin=True),
                                rtol=1e-5, atol=1e-5)):
            fail(f"[linear] {tag}: the model file on the CPU predicts "
                 "otherwise")
        print(f"[linear] {tag}: {rounds} rounds, weights within rtol 1e-4 "
              f"of the CPU run, no histogram kernel, the file on the CPU "
              f"predicts the same; {ms[tag]:.3f} ms per round | {card}",
              flush=True)
    return ms


# ------------------------------------------------------------- [compat]
COMPAT_ROWS = 10_000


def phase_compat(torch, xt, device, card, main_out):
    """The reference's model files on the card, and [main]'s model
    through the reference format and back."""
    from xgboost_tpu_torch.compat import save_reference_model
    rng = np.random.RandomState(126)
    Xr = (rng.rand(COMPAT_ROWS, 126) < 0.2).astype(np.float32)
    cpu = xt.Booster(model_file=os.path.join(
        HERE, "tests", "data", "ref_agaricus.model"), device="cpu")
    want = cpu.predict(xt.DMatrix(Xr)).tobytes()
    for name in ("ref_agaricus.model", "ref_agaricus.bs64"):
        bst = xt.Booster(model_file=os.path.join(HERE, "tests", "data",
                                                 name), device=device)
        if bst.predict(xt.DMatrix(Xr)).tobytes() != want:
            fail(f"[compat] {name} on the card predicts other bytes than "
                 "on the CPU")
    print(f"[compat] ref_agaricus.model and .bs64 on the card: "
          f"{COMPAT_ROWS} rows, bytes == the CPU's", flush=True)
    main = xt.Booster(device=device)
    main.load_raw(main_out["raw"])
    X = main_out["X"][N_TRAIN:]
    path = os.path.join(HERE, ".smoke_out", "main.refmodel")
    t0 = time.perf_counter()
    save_reference_model(main, path)
    back = xt.Booster(model_file=path, device=device)
    secs = time.perf_counter() - t0
    if back.predict(xt.DMatrix(X)).tobytes() != \
            main.predict(xt.DMatrix(X)).tobytes():
        fail("[compat] [main]'s model through the reference format "
             "predicts other bytes")
    print(f"[compat] [main]'s model written in the reference format and "
          f"read back on the card: {N_TEST} holdout predictions "
          f"byte-equal ({secs:.2f} s) | {card}", flush=True)


# ------------------------------------------------------------- [extmem]
EXT_PAGE = 65_536                # 16 pages of [main]'s 1M rows
EXT_ROUNDS, EXT_BUDGET_MB = 5, 8
EXT_LIBSVM_ROWS = 50_000


def phase_extmem(torch, xt, kernels, device, card, main_out):
    """[main]'s training rows as an external-memory matrix streamed in 16
    batches a level (K1 at levels 0-5, K2 at 0-6, each once a batch),
    then the same matrix under the default budget, then a libsvm file
    through ``DMatrix("ext:...")`` and ``task=train``."""
    from xgboost_tpu_torch import external, native
    from xgboost_tpu_torch.metrics import auc
    from xgboost_tpu_torch.ops import cuda_hist, cuda_node_stats
    if not native.available():
        fail("[extmem] the native IO library did not build")
    X, y = main_out["X"], main_out["y"]
    Xh, yh = X[N_TRAIN:], y[N_TRAIN:]
    n_pages = -(-N_TRAIN // EXT_PAGE)
    times = {}
    os.makedirs(os.path.join(HERE, ".smoke_out", "ext"), exist_ok=True)
    t0 = time.perf_counter()
    d = external.ExtMemDMatrix(
        ((X[s:min(s + EXT_PAGE, N_TRAIN)], y[s:min(s + EXT_PAGE, N_TRAIN)])
         for s in range(0, N_TRAIN, EXT_PAGE)),
        cache=os.path.join(HERE, ".smoke_out", "ext", "m"),
        page_rows=EXT_PAGE)
    times["ingest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cuts = d.sketch_cuts(PARAMS["max_bin"])
    times["sketch_s"] = time.perf_counter() - t0
    d._cuts[(PARAMS["max_bin"], 0.03, 2.0)] = cuts
    t0 = time.perf_counter()
    d.build_binned(cuts)
    times["binning_s"] = time.perf_counter() - t0
    print(f"[extmem] {N_TRAIN} rows in {n_pages} pages of {EXT_PAGE}: "
          f"ingest {times['ingest_s']:.2f} s, sketch {times['sketch_s']:.2f}"
          f" s, binning {times['binning_s']:.2f} s; binned "
          f"{d.binned_nbytes() / 1e6:.1f} MB", flush=True)
    ones = np.ones(N_TEST, np.float32)

    def train(tag, budget=EXT_BUDGET_MB):
        """EXT_ROUNDS rounds on ``d``: (booster, counts, ms a round of
        rounds 1..4, upload stats)."""
        saved = os.environ.pop("XGBTPU_EXT_DEVICE_CACHE_MB", None)
        if budget is not None:
            os.environ["XGBTPU_EXT_DEVICE_CACHE_MB"] = str(budget)
        try:
            reset_counts(kernels)
            external.reset_upload_stats()
            bst = xt.Booster(PARAMS, cache=[d], device=device)
            bst.update(d, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst.update_many(d, 1, EXT_ROUNDS - 1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (EXT_ROUNDS - 1)
            counts = read_counts(kernels)
            stats = dict(external.UPLOAD_STATS)
        finally:
            os.environ.pop("XGBTPU_EXT_DEVICE_CACHE_MB", None)
            if saved is not None:
                os.environ["XGBTPU_EXT_DEVICE_CACHE_MB"] = saved
        print(f"[extmem] {tag}: {EXT_ROUNDS} rounds, {ms:.3f} ms per round;"
              f" {stats['batches']} batches up ({stats['bytes'] / 1e6:.1f} "
              f"MB, {stats['seconds']:.4f} s of synchronous uploads); all "
              f"counts {json.dumps(counts)} | {card}", flush=True)
        return bst, counts, ms, stats

    # the counted run: 8 MiB of budget holds four 1.8 MB batches
    streamed, counts, ms_s, up_s = train("streamed")
    if not streamed._cache[id(d)].external:
        fail("[extmem] the 8 MiB budget did not stream the matrix")
    want = {"hist_level": EXT_ROUNDS * DEPTH * n_pages,
            "node_stats": EXT_ROUNDS * (DEPTH + 1) * n_pages}
    if counts != only(kernels, **want):
        fail(f"[extmem] streamed launch counts {counts}: want {want}")
    launches = dict(counts)
    again, counts2, ms_a, _ = train("streamed again")
    if counts2 != counts or again.save_raw() != streamed.save_raw():
        fail("[extmem] two streamed runs grew other model bytes")
    print("[extmem] a second streamed run: identical model bytes", flush=True)
    del again
    errs = {"hist_level": 0.0, "node_stats": 0.0}
    os.environ["XGBTPU_EXT_DEVICE_CACHE_MB"] = str(EXT_BUDGET_MB)
    try:
        # every K1 and K2 launch of one streamed round, each against its
        # plain version on the same inputs, and one level's paged int8
        # histogram against the plain K1 on the whole matrix
        k1_calls, k2_calls = [], []
        k1, k2 = cuda_hist.level_histogram, cuda_node_stats.node_stats

        def cap1(bins, gh, pos, n_node, n_bin, mode):
            out = k1(bins, gh, pos, n_node, n_bin, mode)
            k1_calls.append((n_node, bins.clone(), gh.clone(), pos.clone(),
                             out, mode, n_bin))
            return out

        def cap2(gh, pos, n_node):
            out = k2(gh, pos, n_node)
            k2_calls.append((n_node, gh.clone(), pos.clone(), out))
            return out
        cuda_hist.level_histogram = cap1
        cuda_node_stats.node_stats = cap2
        try:
            b1 = xt.Booster(PARAMS, cache=[d], device=device)
            b1.update(d, 0)
        finally:
            cuda_hist.level_histogram = k1
            cuda_node_stats.node_stats = k2
        rows = {c[1].shape[0] for c in k1_calls} | {c[1].shape[1]
                                                    for c in k2_calls}
        last = N_TRAIN - (n_pages - 1) * EXT_PAGE
        if len(k1_calls) != DEPTH * n_pages \
                or len(k2_calls) != (DEPTH + 1) * n_pages \
                or rows != {EXT_PAGE, last} \
                or max(c[0] for c in k1_calls) != 1 << (DEPTH - 1) \
                or max(c[0] for c in k2_calls) != 1 << DEPTH \
                or any(c[5] != "int" for c in k1_calls):
            fail(f"[extmem] captured {len(k1_calls)} K1 and {len(k2_calls)}"
                 f" K2 calls on rows {sorted(rows)}: want {DEPTH * n_pages}"
                 f" int8 K1 and {(DEPTH + 1) * n_pages} K2 on {EXT_PAGE} "
                 f"and {last} rows")
        for n_node, bins, gh, pos, out, mode, n_bin in k1_calls:
            if not torch.equal(out, cuda_hist.level_histogram_plain(
                    bins, gh, pos, n_node, n_bin, mode)):
                fail(f"[extmem] K1 on a batch of {bins.shape[0]} rows at "
                     f"{n_node} nodes != the plain version")
        for n_node, gh, pos, out in k2_calls:
            want_k2 = cuda_node_stats.node_stats_plain(gh, pos, n_node)
            n = cuda_node_stats.node_stats_plain(torch.ones_like(gh), pos,
                                                 n_node)
            a = cuda_node_stats.node_stats_plain(gh.abs(), pos, n_node)
            if not sum_bound_ok(torch, out, want_k2, n, a):
                fail(f"[extmem] K2 on a batch of {gh.shape[1]} rows at "
                     f"{n_node} nodes: |kernel - plain| beyond 2 n 2^-24 "
                     "sum|x|")
            errs["node_stats"] = max(errs["node_stats"], float(
                (out - want_k2).abs().max()))
        print(f"[extmem] round 0's {len(k1_calls)} K1 launches (batches of "
              f"{EXT_PAGE} and {last} rows, 1-{1 << (DEPTH - 1)} nodes) == "
              f"the plain version bitwise; its {len(k2_calls)} K2 launches "
              f"(1-{1 << DEPTH} nodes) within the f32 bound (max |diff| "
              f"{errs['node_stats']:.3e})", flush=True)
        lv = [c for c in k1_calls if c[0] == 8]
        paged = sum(c[4] for c in lv)
        whole = cuda_hist.level_histogram_plain(
            torch.cat([c[1] for c in lv]), torch.cat([c[2] for c in lv]),
            torch.cat([c[3] for c in lv]), 8, lv[0][6], "int")
        torch.cuda.synchronize()
        if paged.dtype != torch.int32 or not torch.equal(paged, whole):
            fail("[extmem] level 3's paged int8 histogram != the plain K1 "
                 "on the whole matrix")
        print(f"[extmem] level 3 (8 nodes): the {n_pages} batches' int32 "
              "partial sums == the plain K1 on the whole matrix, bitwise",
              flush=True)
        del k1_calls, k2_calls, lv, paged, whole

        # the device bytes a round adds at its peak, streamed and in
        # memory (over what is allocated when it starts)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        b1.update(d, 1)
        torch.cuda.synchronize()
        peak_stream = torch.cuda.max_memory_allocated() - base
    finally:
        del os.environ["XGBTPU_EXT_DEVICE_CACHE_MB"]

    # the default budget: the matrix fits and trains in memory
    mem, counts_m, ms_m, up_m = train("default budget", budget=None)
    if mem._cache[id(d)].external or up_m["batches"] != 0:
        fail("[extmem] the in-budget matrix streamed")
    if counts_m != only(kernels, hist_level=EXT_ROUNDS * DEPTH):
        fail(f"[extmem] in-budget launch counts {counts_m}")
    launches["hist_level"] += counts_m["hist_level"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mem.update(d, EXT_ROUNDS)
    torch.cuda.synchronize()
    peak_mem = torch.cuda.max_memory_allocated() - base
    print(f"[extmem] device bytes a round adds at its peak: streamed "
          f"{peak_stream / 1e6:.1f} MB, in memory {peak_mem / 1e6:.1f} MB",
          flush=True)
    if not peak_stream < peak_mem:
        fail(f"[extmem] a streamed round peaked at {peak_stream} bytes, "
             f"the in-memory one at {peak_mem}")
    a_stream = auc(streamed.predict(xt.DMatrix(Xh)), yh, ones)
    a_mem = auc(mem.predict(xt.DMatrix(Xh)), yh, ones)
    print(f"[extmem] holdout AUC: streamed {a_stream:.6f}, in memory "
          f"{a_mem:.6f}", flush=True)
    if not abs(a_stream - a_mem) <= 0.002:
        fail(f"[extmem] streamed AUC {a_stream} vs in-memory {a_mem}")

    # a libsvm file through DMatrix("ext:...") and the command line
    svm = os.path.join(HERE, ".smoke_out", "ext", "train.svm")
    write_libsvm_text(svm, X[:EXT_LIBSVM_ROWS], y[:EXT_LIBSVM_ROWS])
    dl = xt.DMatrix(f"ext:{svm}#{svm}.cache")
    if not isinstance(dl, external.ExtMemDMatrix) \
            or dl.num_row != EXT_LIBSVM_ROWS:
        fail("[extmem] DMatrix('ext:...') did not make a paged matrix")
    model = os.path.join(HERE, ".smoke_out", "ext", "cli.model")
    conf = write_conf(os.path.join(HERE, ".smoke_out", "ext", "ext.conf"),
                      task="train", objective="binary:logistic",
                      max_depth=DEPTH, eta=0.1, max_bin=64, num_round=3,
                      data=f"ext:{svm}#{svm}.cli", model_out=model,
                      silent=1)
    rc, err = run_cli([conf, "device=cuda"])
    if rc != 0 or not os.path.exists(model):
        fail(f"[extmem] task=train on an ext: matrix: rc {rc}: {err[-500:]}")
    print(f"[extmem] {EXT_LIBSVM_ROWS}-row libsvm file: DMatrix('ext:...') "
          f"{dl.num_row} x {dl.num_col}, task=train wrote its model",
          flush=True)
    times.update(ms_streamed=ms_s, ms_again=ms_a, ms_in_memory=ms_m,
                 upload_s=up_s["seconds"], upload_mb=up_s["bytes"] / 1e6)
    return launches, errs, times


def phases_linear_compat_extmem(torch, xt, kernels, card, main_out):
    """[linear], [compat] and [extmem] in turn: (the K1 and K2 launches
    of [extmem], their largest errors against the plain versions, the
    times of all three)."""
    with phase("linear"):
        lin_ms = phase_linear(torch, xt, kernels, "cuda", card, main_out)
    with phase("compat"):
        phase_compat(torch, xt, "cuda", card, main_out)
    with phase("extmem"):
        ext_launches, ext_errs, times = phase_extmem(torch, xt, kernels,
                                                     "cuda", card, main_out)
    times.update(lin_ms=lin_ms["higgs"], lin_mc_ms=lin_ms["multiclass"])
    return ext_launches, ext_errs, times


def kernel_record(name, source, replaces, launches, max_err, rows):
    def mean(key):
        return sum(r[key] for r in rows) / len(rows)
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max_err, "ms": mean("ms"),
           "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
           "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                      for r in rows) else "operations",
           "library_ms": mean("library_ms")}
    if all("device_ms" in r for r in rows):
        rec["device_ms"] = mean("device_ms")
    return rec


def main():
    sys.stdout.reconfigure(line_buffering=True)
    if sys.argv[1:2] == ["--dist-worker"]:
        dist_worker(sys.argv[2])
        return
    stop_after = sys.argv[2] if sys.argv[1:2] == ["--stop-after"] else None
    start_deadline()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, HERE)
    try:
        import xgboost_tpu_torch as xt
    except ImportError as e:
        fail(f"xgboost_tpu_torch is not beside this script: {e}")
    from xgboost_tpu_torch.ops import (cuda_hist, cuda_hist_batched,
                                       cuda_hist_lanes, cuda_hist_onehot,
                                       cuda_node_stats, nvcc)
    # every kernel's launch count: each path checks all of them
    kernels = {"hist_level": cuda_hist, "hist_batched": cuda_hist_batched,
               "node_stats": cuda_node_stats, "hist_lanes": cuda_hist_lanes,
               **cuda_hist_onehot.COUNTERS}

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[env] {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | python "
          f"{sys.version.split()[0]}")

    def stop_here(name):
        """True after the phase ``--stop-after`` names: the table, no
        result."""
        if stop_after != name:
            return False
        print_phases()
        return True

    with phase("build"):
        sources = ["hist_level", "hist_batched", "node_stats", "hist_lanes",
                   *dict.fromkeys(cuda_hist_onehot.SOURCES.values())]
        for b in nvcc.build(sources):
            print(f"[build] {b.name}: {b.seconds:.2f} s")
            for line in b.log.splitlines():
                if "registers" in line or "spill" in line \
                        or "Performance" in line:
                    print(f"[build]   {line.strip()}")
    with phase("K1"):
        phase_kernels(torch, cuda_hist, dev)
    with phase("K3"):
        phase_k3(torch, cuda_hist_batched, cuda_hist, dev)
    with phase("K2"):
        phase_k2(torch, cuda_node_stats, dev)
    with phase("K4"):
        phase_k4(torch, cuda_hist_lanes, cuda_hist, dev)
    with phase("main"):
        launches, ms_round, captured, max_err, main_out = phase_main(
            torch, xt, cuda_hist, kernels, "cuda", card)
    with phase("time"):
        rows = phase_times(torch, cuda_hist, captured, card)
    del captured
    with phase("cli"):
        phase_cli(torch, xt, kernels, "cuda", card, main_out)
    with phase("dist"):
        dist_launches = phase_dist(torch, xt, kernels, card, main_out)
    if stop_here("dist"):
        return
    with phase("sample"):
        s_launches, s_ms, draw_ms, _ = phase_sample(
            torch, xt, cuda_hist, kernels, "cuda", card, main_out)
    with phase("subtract"):
        sub_k1, sub_k2, sub_ms, _ = phase_subtract(
            torch, xt, cuda_hist, kernels, "cuda", card, main_out)
    with phase("roots"):
        r_launches, rf_launches = phase_roots(torch, xt, cuda_hist, kernels,
                                              "cuda", card, main_out)
    with phase("profile"):
        p_launches, phases, _, _ = phase_profile(torch, xt, kernels, "cuda",
                                                 card, main_out)
    with phase("updaters"):
        upd_launches, upd_times = phase_updaters(torch, xt, kernels, "cuda",
                                                 card, main_out)
    ext_launches, ext_errs, ext_times = phases_linear_compat_extmem(
        torch, xt, kernels, card, main_out)
    main_hold = main_out["X"][N_TRAIN:]
    fleet_train = (main_out["X"][:FLEET_CAND_N].copy(),
                   main_out["y"][:FLEET_CAND_N].copy())
    del main_out
    with phase("multiclass"):
        mc_launches, mc_ms_round, mc_captured, mc_err, _ = phase_multiclass(
            torch, xt, kernels, "cuda", card)
        k3_rows = time_k3(torch, cuda_hist_batched, mc_captured, card)
    del mc_captured
    with phase("serve"):
        engine_bytes = phase_serve(torch, xt, kernels, card, main_hold)
    with phase("fleet"):
        phase_fleet(torch, xt, kernels, card, main_hold, fleet_train,
                    engine_bytes)
    del main_hold, fleet_train
    with phase("otto"):
        phase_otto(torch, xt, kernels, "cuda", card)
    with phase("forest"):
        f_launches, _ = phase_forest(torch, xt, kernels, "cuda", card)
    with phase("subtract-multiclass"):
        smc_k3, smc_k4, smc_k2, smc_ms = phase_subtract_multiclass(
            torch, xt, kernels, "cuda", card, mc_ms_round)
    with phase("depth0"):
        d0_launches, d0_captured, d0_err = phase_depth0(torch, xt, kernels,
                                                        "cuda")
        k2_rows = time_k2(torch, cuda_node_stats, d0_captured, card)
    with phase("lanes"):
        k4_launches, lane_data, lane_rows, lane_secs, _ = phase_lanes(
            torch, xt, kernels, "cuda", card)
        k4_captured = lanes_round_inputs(torch, xt, cuda_hist_lanes,
                                         lane_data, "cuda")
        k4_err = check_lanes_levels(torch, cuda_hist_lanes, cuda_hist,
                                    k4_captured, lane_rows)
        k4_rows = time_k4(torch, cuda_hist_lanes, k4_captured, card)
        del k4_captured
        host_ms, stacked_ms = time_lane_cycles(torch, xt, lane_data, "cuda",
                                               card)
        print(f"[lanes] pipeline runs {lane_secs[0]:.2f} s stacked, "
              f"{lane_secs[1]:.2f} s host loop")
    with phase("lanes-sampled"):
        sl_launches = phase_lanes_sampled(torch, xt, kernels, "cuda", card)
    with phase("rank"):
        rk_launches, rk_ms, rk_grad_ms, rk_err, rank_out = phase_rank(
            torch, xt, cuda_hist, kernels, "cuda", card)
    with phase("rank-sort"):
        rs_launches, rs_rows = phase_rank_sort(torch, xt, kernels, "cuda",
                                               card)
    with phase("api"):
        api_launches = phase_api(torch, xt, kernels, "cuda", card, rank_out)
    del rank_out
    with phase("onehot"):
        oh_errs = phase_onehot_checks(torch, cuda_hist_onehot, cuda_hist,
                                      nvcc, dev)
        oh_launches, oh_rows = phase_onehot(torch, cuda_hist_onehot,
                                            cuda_hist, kernels, card)
    with phase("onehot-bf16"):
        oh_errs.update(phase_onehot_bf16_checks(torch, cuda_hist_onehot,
                                                nvcc, dev))
        bf_launches, bf_rows = phase_onehot_bf16(torch, cuda_hist_onehot,
                                                 cuda_hist, kernels, card)

    # launches: each path's own count, summed over the paths that run
    # the kernel ([main], [sample], [subtract], [roots], [profile],
    # [updaters], [rank], [rank-sort] and [api] for K1; [multiclass],
    # [forest], the [roots] forest, the multiclass [subtract] and
    # [updaters] for K3; [depth0], both [subtract] runs and [updaters]
    # for K2; [lanes], [lanes-sampled] and the multiclass [subtract] for
    # K4)
    records = [
        kernel_record("hist_level", "xgboost_tpu_torch/csrc/hist_level.cu",
                      "xgboost_tpu/ops/pallas_hist.py:46",
                      launches + s_launches + sub_k1 + r_launches
                      + p_launches + upd_launches["hist_level"]
                      + ext_launches["hist_level"]
                      + rk_launches + rs_launches + api_launches
                      + dist_launches["hist_level"],
                      max(max_err, rk_err, ext_errs["hist_level"]), rows),
        kernel_record("hist_batched",
                      "xgboost_tpu_torch/csrc/hist_batched.cu",
                      "xgboost_tpu/ops/pallas_hist.py:374",
                      mc_launches + f_launches + rf_launches + smc_k3
                      + upd_launches["hist_batched"]
                      + dist_launches["hist_batched"], mc_err, k3_rows),
        kernel_record("node_stats", "xgboost_tpu_torch/csrc/node_stats.cu",
                      "xgboost_tpu/ops/pallas_hist.py:609",
                      d0_launches + sub_k2 + smc_k2
                      + upd_launches["node_stats"]
                      + ext_launches["node_stats"]
                      + dist_launches["node_stats"],
                      max(d0_err, ext_errs["node_stats"],
                          dist_launches["node_stats_err"]), k2_rows),
        kernel_record("hist_lanes", "xgboost_tpu_torch/csrc/hist_lanes.cu",
                      "xgboost_tpu/ops/pallas_hist.py:283",
                      k4_launches + sl_launches + smc_k4, k4_err, k4_rows),
    ]
    for name, (source, replaces) in ONEHOT_SOURCES.items():
        bf16 = name in ONEHOT_BF16_MAIN_LAUNCHES
        rows_k = (bf_rows if bf16 else oh_rows)[name]
        records.append(kernel_record(
            name, source, replaces, (bf_launches if bf16 else oh_launches)[
                name], max([oh_errs[name]] + [r["err"] for r in rows_k]),
            rows_k))
    print(f"[time] Higgs path: {ms_round:.3f} ms per round (sampled "
          f"{s_ms:.3f}, subtracted {sub_ms:.3f}; one 1M-row draw "
          f"{draw_ms:.4f} ms; profile=1 phases " + ", ".join(
              f"{k} {v:.3f}" for k, v in phases.items()) + "); multiclass "
          f"path: {mc_ms_round:.3f} ms per round (subtracted "
          f"{smc_ms:.3f}); lanes: {host_ms:.3f} ms "
          f"per host-loop cycle, {stacked_ms:.3f} ms per stacked cycle; "
          f"rank:ndcg padded {rk_ms:.3f} ms per round (gradient "
          f"{rk_grad_ms:.4f} ms), " + ", ".join(
              f"{t} {m:.3f} (gradient {g:.4f})" for t, m, g in rs_rows)
          + f"; updaters: exact {upd_times['exact_ms']:.3f} ms per round "
          f"(rank build {upd_times['exact_rank_s']:.2f} s), skmaker "
          f"{upd_times['skmaker_ms']:.3f} (multiclass "
          f"{upd_times['skmaker_mc_ms']:.3f}), refresh "
          f"{upd_times['refresh_ms']:.3f} ms a pass; gblinear "
          f"{ext_times['lin_ms']:.3f} ms per round (multiclass "
          f"{ext_times['lin_mc_ms']:.3f}); external memory "
          f"{ext_times['ms_streamed']:.3f} ms per streamed round (again "
          f"{ext_times['ms_again']:.3f}; in memory "
          f"{ext_times['ms_in_memory']:.3f}), upload "
          f"{ext_times['upload_s']:.4f} s for {ext_times['upload_mb']:.1f}"
          f" MB, ingest {ext_times['ingest_s']:.2f} s, sketch "
          f"{ext_times['sketch_s']:.2f} s, binning "
          f"{ext_times['binning_s']:.2f} s; "
          f"kernel times are means over the levels of one round (K2: one "
          f"depth-0 round) | {card}")
    print_phases()
    print(json.dumps({"kernels": records}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
